"""The harness's pieces on the CPU: the check for JAX by whole top-level
name, the trace's reduction, the gaps, and the exits without a card."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from benchmark import harness

ROOT = Path(__file__).resolve().parents[2]


@pytest.mark.parametrize("name", ["jax", "jax.numpy", "jaxlib.xla_extension", "flax.linen",
                                  "gcn_maxcut_tpu", "gcn_maxcut_tpu.ops.pallas_banded"])
def test_forbidden_modules_are_found(name):
    assert harness.forbidden_modules(["torch", name]) == [name.split(".")[0]]


@pytest.mark.parametrize("name", ["gcn_maxcut_tpu_torch", "gcn_maxcut_tpu_torch.train.loop",
                                  "jaxtyping", "flaxen", "benchmark.harness"])
def test_allowed_modules_pass(name):
    assert harness.forbidden_modules([name, "torch", "numpy"]) == []


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import gcn_maxcut_tpu_torch.train.loop, gcn_maxcut_tpu_torch.eval.harness\n"
        "import gcn_maxcut_tpu_torch.bench.giant_demo\n"
        "from benchmark import harness, generator\n"
        "from benchmark.entries import recipe_train, recipe_decode, giant_jobs\n"
        "for c in ('recipe-n500', 'giant-packed-10m'):\n"
        "    harness.load_module(harness.BENCH / 'reference' / (c + '.py'))\n"
        "print(harness.forbidden_modules(sys.modules))\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]"


@pytest.mark.parametrize("path", sorted((ROOT / "benchmark" / "reference").glob("*.py")))
def test_references_import_neither_package_nor_the_benchmark(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            names.add((node.module or "").split(".")[0])
    assert not names & (harness.FORBIDDEN | {"gcn_maxcut_tpu_torch", "benchmark"})


def _event(name, start, end, kind="CPU"):
    return SimpleNamespace(name=name, device_type=f"DeviceType.{kind}",
                           time_range=SimpleNamespace(start=start, end=end))


def test_reduce_trace_from_its_own_intervals():
    events = [
        _event(harness.WINDOW_SPAN, 0, 1000),
        _event("cudaGraphLaunch", 0, 10),
        _event("k_a", 100, 300, "CUDA"), _event("k_a", 200, 400, "CUDA"),   # overlap: 300 busy
        _event("k_b", 405, 500, "CUDA"),                                    # a 5 us launch gap
        _event("Memcpy DtoH (Device -> Pageable)", 700, 800, "CUDA"),
        _event("cudaStreamSynchronize", 550, 650),
        _event("aten::item", 520, 900), _event("cudaMemcpyAsync", 690, 810),
        _event("k_c", 1500, 1600, "CUDA"),                                  # outside the window
    ]
    t = harness.reduce_trace(events)
    assert t["window_s"] == pytest.approx(1000e-6)
    assert t["busy_s"] == pytest.approx((300 + 95 + 100) * 1e-6)
    assert t["kernels"] == 3
    assert t["kernel_s"]["k_a"] == pytest.approx(400e-6)
    assert t["runtime"] == {"cudaGraphLaunch": 1, "cudaStreamSynchronize": 1, "cudaMemcpyAsync": 1}
    idle = dict(t["idle_gaps"])
    assert idle["host: nothing traced"] == pytest.approx(100e-6)         # 0..100
    assert idle["launch gaps (<10 us)"] == pytest.approx(5e-6)           # 400..405
    assert idle["host: cudaStreamSynchronize"] == pytest.approx(200e-6)  # 500..700, innermost
    assert idle["host: aten::item"] == pytest.approx(200e-6)             # 800..1000
    assert sum(idle.values()) == pytest.approx(t["window_s"] - t["busy_s"])
    assert t["device_ops"][0][0] == "k_a"


def test_reduce_trace_needs_its_window():
    with pytest.raises(RuntimeError):
        harness.reduce_trace([_event("k", 0, 1, "CUDA")])


def test_gaps_by_worst_leaf_and_kept_leaves():
    ref = {"a": 10.0, "b": 1.0, "c": 0.0005}
    assert harness.kept_leaves(ref) == ["a", "b"]
    # b's gap is measured against the median leaf's norm, the larger
    assert harness.leaf_gap({"a": 10.0, "b": 1.5}, ref, ["a", "b"]) == pytest.approx(0.5 / 5.5)
    assert harness.leaf_gap({"a": 0.0, "b": 0.0}, ref, ["a", "b"]) == pytest.approx(1.0)
    assert harness.loss_gap([-100.0, -99.0], [-100.0, -100.0]) == pytest.approx(0.01)
    assert harness.loss_gap([-1.0], [-1.0, -2.0]) == float("inf")


def test_checks_fail_on_a_missing_number():
    found = harness.checks({"x": 1.0, "y": 0.0}, {"x": 0.5})
    assert [c.ok for c in found] == [True, False]


def test_percentile_is_numpys_linear_rule():
    assert harness.percentile([1.0, 2.0, 3.0, 4.0, 5.0], 95) == pytest.approx(4.8)


def _run(cwd, *args):
    return subprocess.run([sys.executable, "benchmark/run.py", "--workload", "recipe-train",
                           "--seed", "3000000000", "--seconds", "1", "--trace", "0", *args],
                          cwd=cwd, capture_output=True, text=True, timeout=300)


def test_run_without_a_card_exits_nonzero_and_prints_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("there is a card here")
    out = _run(ROOT)
    assert out.returncode != 0 and out.stdout == ""


def test_run_from_the_benchmark_alone_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_an_unknown_workload_exits_2():
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "nope", "--seed",
                          "1", "--seconds", "1"], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 2 and out.stdout == ""


def test_result_line_puts_the_checks_last():
    cell = harness.Cell("w", "c", {}, "t", {}, 1,
                        [{"name": "setup_s", "unit": "s"}, {"name": "epoch_ms", "unit": "ms"}],
                        [], {"gap": 1.0}, 1, 1.0, False, device="cpu")
    out = harness.Outcome(2.5, {"epoch_ms": 3.0, "other": 1.0}, {}, {}, {"gap": 0.5}, 7, 0, 0)
    line = harness.result(cell, out)
    assert list(line)[-1] == "checks" and line["correct"] is True
    assert line["metrics"] == {"setup_s": {"value": 2.5, "unit": "s"},
                               "epoch_ms": {"value": 3.0, "unit": "ms"}}
    assert json.loads(json.dumps(line)) == line


def test_the_program_names_the_training_checks_read():
    """The training checks read the first gradient inside the program: the
    public ``Adam``'s ``step``, ``params``, ``nu`` and ``b2`` (the watch on
    its first step), and ``chunk_step`` as a global of ``giant_demo`` that
    ``train_banded_giant_packed`` looks up at each call (the giant's watch).
    A change to any of these fails here before it fails a run."""
    import torch

    import gcn_maxcut_tpu_torch.bench.giant_demo as gd
    from gcn_maxcut_tpu_torch.train.optim import Adam

    leaves = [torch.zeros(3), torch.zeros(2, 2)]
    opt = Adam(leaves, lr=1e-3)
    assert opt.params == leaves and len(opt.nu) == len(leaves) and opt.b2 == 0.999
    seen = {}
    harness.watch_first_step(opt, ["a", "b"], seen)
    grads = [torch.tensor([3.0, 0.0, 4.0]), torch.full((2, 2), 0.5)]
    opt.step(grads)
    assert seen == pytest.approx({"a": 5.0, "b": 1.0}, rel=1e-6)
    assert leaves[0][0] < 0 and "step" not in vars(opt)        # stepped, watch removed
    opt.step([torch.ones(3), torch.ones(2, 2)])
    assert seen == pytest.approx({"a": 5.0, "b": 1.0}, rel=1e-6) and opt.count == 2
    assert callable(gd.chunk_step)
    assert "chunk_step" in gd.train_banded_giant_packed.__code__.co_names
