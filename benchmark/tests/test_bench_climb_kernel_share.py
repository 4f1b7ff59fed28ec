"""The reader of ``climb_kernel_share``: nothing from an untraced run, a
window with no graphs, a program that counts no climb runs or a run off
the card; else the kernel's climbs over all the card's climbs, in %."""

import types

import pytest

from benchmark import harness
from gcn_maxcut_tpu_torch.utils import profiling

CARD = {"climb.runs": 50, "climb.kernel": 50}


def _read(monkeypatch, counts, traced=True, graphs=50, device="cuda"):
    if counts is None:
        monkeypatch.delattr(profiling, "counts")
    else:
        monkeypatch.setattr(profiling, "counts", lambda: dict(counts))
    out = harness.Outcome(setup_s=1.0, metrics={}, units={"graphs": graphs} if graphs else {},
                          info={}, values={}, attempted=1, failed=0, memory_peak_bytes=0,
                          trace={"window_s": 1.0, "busy_s": 0.5} if traced else None)
    reader = harness.load_module(harness.BENCH / "metrics" / "climb_kernel_share.py")
    return reader.read(out, types.SimpleNamespace(device=device))


@pytest.mark.parametrize("counts,want", [
    ({**CARD, "climb.steps": 3500}, 100.0),
    ({"climb.runs": 50, "climb.kernel": 25}, 50.0),
    ({"climb.runs": 50, "climb.captures": 5}, 0.0),
])
def test_the_share_is_the_kernels_climbs_over_the_cards(monkeypatch, counts, want):
    assert _read(monkeypatch, counts) == pytest.approx(want)


@pytest.mark.parametrize("case,kwargs", [
    ("untraced", {"counts": CARD, "traced": False}),
    ("no graphs", {"counts": CARD, "graphs": 0}),
    ("a program before the climb kernel", {"counts": {"climb.steps": 4200,
                                                      "climb.captures": 5}}),
    ("a program with no counters", {"counts": None}),
    ("off the card", {"counts": CARD, "device": "cpu"}),
])
def test_the_share_is_silent_where_there_is_nothing_to_read(monkeypatch, case, kwargs):
    assert _read(monkeypatch, **kwargs) is None
