"""The readers of the program's spans and counters: nothing from an
untraced run or a program without them, and each ratio from planted
totals."""

import types

import pytest

from benchmark import harness
from gcn_maxcut_tpu_torch.utils import profiling

SPANS = {"decode.forward": 0.030, "chunk.capture": 0.120, "chunk.replay": 0.080,
         "giant.setup": 0.250}
COUNTS = {"climb.captures": 5, "climb.steps": 1600}
UNITS = {"graphs": 50, "epochs": 40, "jobs": 2}

# reader: its value from the planted totals over UNITS
WANT = {
    "climb_captures_per_graph": 5 / 50,
    "climb_capture_ms_per_graph": 120.0 / 50,
    "climb_steps_per_graph": 1600 / 50,
    "decode_forward_ms_per_graph": 30.0 / 50,
    "replay_launch_ms_per_epoch": 80.0 / 40,
    "job_setup_ms": (250.0 + 120.0) / 2,
}


def _read(name, traced=True, units=UNITS, device="cuda"):
    out = harness.Outcome(setup_s=1.0, metrics={}, units=dict(units), info={}, values={},
                          attempted=1, failed=0, memory_peak_bytes=0,
                          trace={"window_s": 1.0, "busy_s": 0.5} if traced else None)
    cell = types.SimpleNamespace(device=device)
    return harness.load_module(harness.BENCH / "metrics" / f"{name}.py").read(out, cell)


@pytest.fixture
def planted(monkeypatch):
    totals = {k: {"count": 1, "total_s": v, "self_s": v} for k, v in SPANS.items()}
    monkeypatch.setattr(profiling, "span_totals", lambda: totals)
    monkeypatch.setattr(profiling, "counts", lambda: dict(COUNTS))


@pytest.mark.parametrize("name", sorted(WANT))
def test_each_reader_gives_its_ratio_of_planted_totals(planted, name):
    assert _read(name) == pytest.approx(WANT[name])


@pytest.mark.parametrize("name", sorted(WANT))
def test_each_reader_is_silent_untraced_or_with_no_units(planted, name):
    assert _read(name, traced=False) is None
    assert _read(name, units={}) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_each_reader_is_silent_where_nothing_was_recorded(monkeypatch, name):
    monkeypatch.setattr(profiling, "span_totals", dict)
    monkeypatch.setattr(profiling, "counts", dict)
    assert _read(name) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_each_reader_is_silent_with_a_program_that_has_no_spans(monkeypatch, name):
    monkeypatch.delattr(profiling, "span_totals")
    monkeypatch.delattr(profiling, "counts")
    assert _read(name) is None


@pytest.mark.parametrize("name", ["climb_captures_per_graph", "climb_capture_ms_per_graph",
                                  "replay_launch_ms_per_epoch"])
def test_captures_and_replays_are_read_on_the_card_alone(monkeypatch, name):
    monkeypatch.setattr(profiling, "span_totals",
                        lambda: {"decode.graph": {"count": 1, "total_s": 1.0, "self_s": 1.0},
                                 "chunk.run": {"count": 1, "total_s": 1.0, "self_s": 1.0}})
    monkeypatch.setattr(profiling, "counts", dict)
    assert _read(name, device="cpu") is None


def test_a_card_window_with_no_capture_reads_zero_captures(monkeypatch):
    monkeypatch.setattr(profiling, "span_totals",
                        lambda: {"decode.graph": {"count": 50, "total_s": 0.6, "self_s": 0.1}})
    monkeypatch.setattr(profiling, "counts", lambda: {"climb.steps": 800})
    assert _read("climb_captures_per_graph") == 0.0
    assert _read("climb_capture_ms_per_graph") == 0.0
