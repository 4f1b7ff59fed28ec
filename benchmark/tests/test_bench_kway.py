"""The k-way cell (``kway-100k-ring``) on the CPU at the sizes of
``readings_kway.TINY_*``: a sound run is correct and each planted fault is
not; ``sharded_setup_ms`` from planted span totals; and the names of the
sharded trainer that the cell's watch and faults reach."""

import subprocess
import sys
import types

import numpy as np
import pytest

from benchmark import harness
from benchmark.entries import giant_jobs, kway_sweep
from benchmark.tests import readings_kway
from gcn_maxcut_tpu_torch.utils import profiling

ROOT = harness.ROOT
SEED = 2**31 + 12345          # larger than 32 signed bits hold
SPANS = {"sharded.partition": 0.002, "sharded.assemble": 0.040, "sharded.setup": 0.030,
         "chunk.capture": 0.090, "sharded.decode": 0.005, "chunk.replay": 0.010}


def test_a_sound_run_is_correct():
    line = readings_kway.reading(SEED, 0.3, tiny=True)
    assert line["correct"], line["checks"]
    assert line["metrics"]["setup_s"]["value"] > 0 and line["metrics"]["epoch_ms"]["value"] > 0
    assert line["attempted"] >= 1 and line["checks"]["answer_errors"]["value"] == 0


@pytest.mark.parametrize("fault", readings_kway.FAULTS)
def test_a_fault_in_the_timed_path_is_not_correct(fault):
    line = readings_kway.reading(SEED, 0.3, fault=fault, tiny=True)
    assert not line["correct"], line["checks"]


def test_a_state_left_unchanged_reads_one():
    line = readings_kway.reading(SEED, 0.3, fault="unchanged", tiny=True)
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)
    assert line["checks"]["grad_gap"]["value"] == pytest.approx(1.0)


def test_a_lower_precision_in_the_forward_fails_prob_gap(monkeypatch):
    """The CPU has no TF32: aggregations rounded to bfloat16 stand in for
    the lower precision that ``prob_gap`` catches."""
    import torch

    import gcn_maxcut_tpu_torch.parallel.spmm as spmm

    real = spmm._group_aggregate
    monkeypatch.setattr(spmm, "_group_aggregate", lambda sg, d, s, x: real(
        sg, d, s, x.to(torch.bfloat16).float()).to(torch.bfloat16).float())
    line = readings_kway.reading(SEED, 0.3, tiny=True)
    check = line["checks"]["prob_gap"]
    assert check["value"] > check["limit"] and not line["correct"]


def test_a_traced_run_reports_its_per_layer_metrics():
    line = readings_kway.reading(SEED, 0.3, tiny=True, trace=True)
    assert line["correct"] and line["attempted"] == readings_kway.TINY_TRAFFIC["trace_jobs"]
    # the card's readers (train_mfu, replay_launch_ms_per_epoch) are silent on the CPU
    assert set(line["metrics"]) == {"device_idle_pct.train", "kernels_per_epoch",
                                    "sharded_setup_ms"}
    assert line["metrics"]["sharded_setup_ms"]["value"] > 0


def test_the_cell_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import gcn_maxcut_tpu_torch.parallel.giant\n"
        "from benchmark import harness\n"
        "from benchmark.entries import kway_sweep\n"
        "harness.load_module(harness.BENCH / 'reference' / 'kway-100k.py')\n"
        "harness.load_module(harness.BENCH / 'metrics' / 'sharded_setup_ms.py')\n"
        "print(harness.forbidden_modules(sys.modules))\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("assignment, errors", [
    (np.array([0, 1, 2, 0, 1, 2]), 0),
    (np.array([1, 1, 2, 0, 1, 2]), 1),            # a terminal moved
    (np.array([0, 1, 2, 3, 1, -1]), 2),           # classes outside [0, k)
    (np.array([0, 1, 2, 0, 1]), 6),               # the wrong length
])
def test_answer_errors_count_what_an_answer_breaks(assignment, errors):
    assert kway_sweep.answer_errors(assignment, 6, 3) == errors


def _read(traced=True, units=None):
    out = harness.Outcome(setup_s=1.0, metrics={}, units={"jobs": 4} if units is None else units,
                          info={}, values={}, attempted=4, failed=0, memory_peak_bytes=0,
                          trace={"window_s": 1.0, "busy_s": 0.5} if traced else None)
    path = harness.BENCH / "metrics" / "sharded_setup_ms.py"
    return harness.load_module(path).read(out, types.SimpleNamespace(device="cuda"))


def _plant(monkeypatch, spans):
    totals = {k: {"count": 1, "total_s": v, "self_s": v} for k, v in spans.items()}
    monkeypatch.setattr(profiling, "span_totals", lambda: totals)


def test_sharded_setup_ms_reads_its_four_spans_per_job(monkeypatch):
    _plant(monkeypatch, SPANS)
    assert _read() == pytest.approx((2.0 + 40.0 + 30.0 + 90.0) / 4)


def test_sharded_setup_ms_is_silent_untraced_with_no_jobs_or_without_its_spans(monkeypatch):
    _plant(monkeypatch, SPANS)
    assert _read(traced=False) is None and _read(units={}) is None
    # a program without the sharded spans (the captures alone are another trainer's)
    _plant(monkeypatch, {"chunk.capture": 0.09, "chunk.replay": 0.01})
    assert _read() is None
    monkeypatch.delattr(profiling, "span_totals")
    assert _read() is None


def test_the_program_names_the_kway_checks_read():
    """The cell's watch replaces ``chunk_step`` as a global of
    ``parallel/giant.py`` that ``make_giant_step`` looks up at each call,
    and names the leaves in ``GiantState.leaves``'s order; the
    probabilities' watch replaces ``_pin_and_ste`` (looked up by
    ``_forward``); its faults replace ``sharded_cut_edgeform`` (by
    ``_loss``) and ``decode_assignment`` (by ``train_giant_graph``).  A
    change to any of these fails here before it fails a run."""
    import torch

    import gcn_maxcut_tpu_torch.parallel.giant as pg
    from gcn_maxcut_tpu_torch.parallel.mesh import make_mesh

    assert callable(pg.chunk_step) and "chunk_step" in pg.make_giant_step.__code__.co_names
    assert "_pin_and_ste" in pg._forward.__code__.co_names
    assert "sharded_cut_edgeform" in pg._loss.__code__.co_names
    assert "decode_assignment" in pg.train_giant_graph.__code__.co_names
    params = {"conv1": {"w": np.full((4, 3), 1.0), "b": np.full(3, 2.0)},
              "conv2": {"w": np.full((3, 2), 3.0), "b": np.full(2, 4.0)},
              "embed": np.full((2, 8, 4), 5.0)}
    state = pg.GiantState.create(params, make_mesh(devices=["cpu"] * 2), 1e-3)
    shapes = [(tuple(t.shape), float(t.flatten()[0])) for t in state.leaves()]
    assert shapes == [((4, 3), 1.0), ((3,), 2.0), ((3, 2), 3.0), ((2,), 4.0),
                      ((8, 4), 5.0), ((8, 4), 5.0)]
    assert giant_jobs.LEAVES == ("conv1.w", "conv1.b", "conv2.w", "conv2.b", "embed")
    assert all(t.dtype == torch.float32 for t in state.leaves())


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")


@pytest.mark.cuda
def test_cuda_the_control_is_not_correct(card):
    """The TF32 reference in the program's place at the cell's own size."""
    line = readings_kway.reading(SEED, 1.0, control=True)
    assert not line["correct"], line["checks"]
