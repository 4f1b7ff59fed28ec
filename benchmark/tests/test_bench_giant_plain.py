"""The plain giant cell (``giant-plain-train``) on the CPU at the sizes of
``readings_giant_plain.TINY_*``: a sound run is correct and under its
limits, each planted fault and the control are not; the two roofline
readers from planted traces; and the names of the plain trainer that the
cell's watch and faults reach."""

import math
import subprocess
import sys
import types

import pytest
import torch

from benchmark import harness
from benchmark.counts import bytes as nbytes
from benchmark.counts import giant_plain
from benchmark.entries import giant_jobs, giant_plain_jobs
from benchmark.tests import readings_giant_plain

ROOT = harness.ROOT
SEED = 2**31 + 54321          # larger than 32 signed bits hold
N = 10_002_432


def test_a_sound_run_is_correct_with_finite_values_under_its_limits():
    line = readings_giant_plain.reading(SEED, 0.3, tiny=True)
    assert line["correct"], line["checks"]
    for check in line["checks"].values():
        assert math.isfinite(check["value"]) and check["value"] <= check["limit"]
    assert line["metrics"]["setup_s"]["value"] > 0 and line["metrics"]["epoch_ms"]["value"] > 0
    assert line["attempted"] >= 1 and line["failed"] == 0


@pytest.mark.parametrize("fault", readings_giant_plain.FAULTS)
def test_a_fault_in_the_timed_path_is_not_correct(fault):
    line = readings_giant_plain.reading(SEED, 0.3, fault=fault, tiny=True)
    assert not line["correct"], line["checks"]


def test_a_state_left_unchanged_reads_one():
    line = readings_giant_plain.reading(SEED, 0.3, fault="unchanged", tiny=True)
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)
    assert line["checks"]["grad_gap"]["value"] == pytest.approx(1.0)


def test_the_control_is_not_correct():
    """The reference on bfloat16 aggregation streams in the program's place."""
    line = readings_giant_plain.reading(SEED, 0.3, control=True, tiny=True)
    assert not line["correct"], line["checks"]
    assert line["attempted"] == 0


def test_a_traced_run_reports_its_per_layer_metrics():
    line = readings_giant_plain.reading(SEED, 0.3, tiny=True, trace=True)
    assert line["correct"] and line["attempted"] == 1
    # the card's readers (train_mfu, the rooflines, replay_launch_ms_per_epoch)
    # are silent on the CPU
    assert set(line["metrics"]) == {"device_idle_pct.train", "kernels_per_epoch",
                                    "job_setup_ms"}
    assert line["metrics"]["job_setup_ms"]["value"] > 0


def test_the_cell_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import gcn_maxcut_tpu_torch.bench.giant_demo\n"
        "from benchmark import harness\n"
        "from benchmark.entries import giant_plain_jobs\n"
        "harness.load_module(harness.BENCH / 'reference' / 'giant-plain-10m.py')\n"
        "harness.load_module(harness.BENCH / 'metrics' / 'k2_roofline.py')\n"
        "harness.load_module(harness.BENCH / 'metrics' / 'banded_f3_roofline.py')\n"
        "print(harness.forbidden_modules(sys.modules))\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_the_byte_counts_are_the_streams_of_an_epoch():
    assert giant_plain.k2_epoch(N) == 2 * nbytes.banded_unit_call(N, 16, 4) == 4.0 * N * 16 * 4
    assert giant_plain.f3_epoch(N) == 4 * nbytes.banded_unit_call(N, 3, 4) == 8.0 * N * 3 * 4


def _read(metric, kernel_s, info, device="cuda", epochs=40):
    out = harness.Outcome(setup_s=1.0, metrics={}, units={"epochs": epochs, "jobs": 1},
                          info=info, values={}, attempted=1, failed=0, memory_peak_bytes=0,
                          trace={"window_s": 1.0, "busy_s": 0.9, "kernel_s": kernel_s})
    path = harness.BENCH / "metrics" / f"{metric}.py"
    return harness.load_module(path).read(out, types.SimpleNamespace(device=device))


READERS = [("k2_roofline", "halo_stream_kernel", "k2_bytes_per_epoch"),
           ("banded_f3_roofline", "banded_window_kernel", "f3_bytes_per_epoch")]


@pytest.mark.parametrize("metric, kernel, key", READERS)
def test_a_roofline_reads_its_kernel_against_the_hbm_peak(monkeypatch, metric, kernel, key):
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA H100 80GB HBM3")
    info = {"k2_bytes_per_epoch": giant_plain.k2_epoch(N),
            "f3_bytes_per_epoch": giant_plain.f3_epoch(N)}
    bound = info[key] * 40 / 3.35e12
    kernel_s = {f"void {kernel}<float>(float const*)": 2 * bound, "other_kernel": 5.0}
    assert _read(metric, kernel_s, info) == pytest.approx(50.0)


@pytest.mark.parametrize("metric, kernel, key", READERS)
def test_a_roofline_is_silent_off_the_card_or_without_its_kernel(metric, kernel, key):
    info = {key: 1e9}
    assert _read(metric, {kernel: 1.0}, info, device="cpu") is None
    assert _read(metric, {kernel: 1.0}, info, epochs=0) is None
    out = harness.Outcome(setup_s=1.0, metrics={}, units={"epochs": 40}, info=info, values={},
                          attempted=1, failed=0, memory_peak_bytes=0, trace=None)
    path = harness.BENCH / "metrics" / f"{metric}.py"
    assert harness.load_module(path).read(out, types.SimpleNamespace(device="cuda")) is None


def test_the_program_names_the_plain_checks_read():
    """The cell calls ``train_banded_giant`` with the keywords below; its
    watch replaces ``chunk_step`` as a global of ``bench/giant_demo.py``
    that ``train_banded_giant`` looks up at each call, and names the
    leaves in ``_leaves``' order; the ``half_batch`` fault replaces
    ``ste_argmax_onehot``, looked up by the trainer's loss.  A change to
    any of these fails here before it fails a run."""
    import inspect

    import gcn_maxcut_tpu_torch.bench.giant_demo as gd

    names = set(inspect.signature(gd.train_banded_giant).parameters)
    assert {"n", "d", "dim_embedding", "hidden_dim", "num_classes", "learning_rate", "epochs",
            "epochs_per_call", "bandwidth", "seed", "params", "device"} <= names
    code = gd.train_banded_giant.__code__
    assert callable(gd.chunk_step) and "chunk_step" in code.co_names
    loss_code = [c for c in code.co_consts if isinstance(c, types.CodeType)
                 and c.co_name == "loss_fn"]
    assert loss_code and "ste_argmax_onehot" in loss_code[0].co_names
    params = giant_plain_jobs.init_weights(1, {"nodes": 64, "embedding": 32, "hidden": 16,
                                               "classes": 3}, "cpu")
    shapes = [tuple(t.shape) for t in gd._leaves(params)]
    assert shapes == [(32, 16), (16,), (16, 3), (3,), (64, 32)]
    assert giant_jobs.LEAVES == ("conv1.w", "conv1.b", "conv2.w", "conv2.b", "embed")
    assert all(t.dtype == torch.float32 for t in gd._leaves(params))
