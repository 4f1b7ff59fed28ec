"""The cells driven on the CPU at the tests' sizes (``readings.TINY_*``):
sound runs are correct, each fault a cell can have makes ``correct``
false, and a configuration, traffic mix and metric added as new files
are found by name."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark.tests import readings

ROOT = Path(__file__).resolve().parents[2]
SEED = 2**31 + 12345          # larger than 32 signed bits hold


@pytest.mark.parametrize("workload", ["recipe-train", "giant-packed-train", "recipe-decode"])
def test_a_sound_run_is_correct(workload):
    line = readings.reading(workload, SEED, 0.3, tiny=True)
    assert line["correct"], line["checks"]
    assert line["metrics"]["setup_s"]["value"] > 0


@pytest.mark.parametrize("workload, fault", [
    ("recipe-train", "unchanged"), ("recipe-train", "half_batch"),
    ("giant-packed-train", "unchanged"), ("giant-packed-train", "half_batch"),
    ("recipe-decode", "answer_altered"), ("recipe-decode", "rollout_permuted"),
])
def test_a_fault_in_the_timed_path_is_not_correct(workload, fault):
    line = readings.reading(workload, SEED, 0.3, fault=fault, tiny=True)
    assert not line["correct"], line["checks"]


def test_a_state_left_unchanged_reads_one():
    line = readings.reading("recipe-train", SEED, 0.3, fault="unchanged", tiny=True)
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)
    assert line["checks"]["grad_gap"]["value"] == pytest.approx(1.0)


def test_a_traced_run_reports_its_per_layer_metrics():
    line = readings.reading("recipe-train", SEED, 0.3, tiny=True, trace=True)
    assert line["correct"]
    assert set(line["metrics"]) == {"device_idle_pct.train", "kernels_per_epoch"}
    assert line["device"]["window_s"] > 0 and "breakdown" in line


def test_a_new_config_traffic_and_metric_are_found_by_name(tmp_path):
    """Copy the benchmark, add files and entries only, and run the new cell."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    bench = tmp_path / "benchmark"
    shutil.copytree(ROOT / "benchmark", bench, ignore=shutil.ignore_patterns("__pycache__"))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    config = json.loads((bench / "configs" / "recipe-n500.json").read_text())
    config.update(readings.TINY_CONFIG["recipe-n500"], name="tiny-recipe", nodes=24)
    (bench / "configs" / "tiny-recipe.json").write_text(json.dumps(config))
    shutil.copy(bench / "reference" / "recipe-n500.py", bench / "reference" / "tiny-recipe.py")
    traffic = {"entry": "recipe_train", "train_graphs": 3, "warmup_epochs": 5,
               "check_epochs": 3, "trace_epochs": 4}
    (bench / "traffic" / "three-graphs.json").write_text(json.dumps(traffic))
    (bench / "limits" / "tiny-train.json").write_text(json.dumps({"loss_gap": 1e-4}))
    (bench / "metrics" / "epochs_seen.py").write_text(
        "def read(out, cell):\n    return out.units.get('epochs')\n")
    spec["configs"].append({"name": "tiny-recipe", "source": "https://example.org/tiny",
                            "file": "benchmark/configs/tiny-recipe.json", "reduced": [],
                            "why": "a throwaway"})
    spec["workloads"].append({"name": "tiny-train", "config": "tiny-recipe",
                              "traffic": "three-graphs", "chips": 1, "why": "a throwaway"})
    spec["per_layer"].append({"name": "epochs_seen", "unit": "epochs", "better": "higher",
                              "source": "program_counter", "layer": "training step",
                              "moves": "epoch_ms", "workloads": ["tiny-train"]})
    for m in spec["end_to_end"]:
        if m["name"] == "epoch_ms":
            m["workloads"].append("tiny-train")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    code = ("import sys, json, time; sys.path.insert(0, %r); sys.path.append(%r)\n"
            "from benchmark import harness\n"
            "cell = harness.load_cell('tiny-train', %d, 0.2, True, device='cpu')\n"
            "print(json.dumps(harness.run_cell(cell, time.perf_counter())))\n"
            % (str(tmp_path), str(ROOT), SEED))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["metrics"]["epochs_seen"]["value"] == 4


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA)")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["recipe-train", "giant-packed-train", "recipe-decode"])
def test_cuda_the_control_is_not_correct(card, workload):
    """The control in the program's place at the cell's own size, on the card."""
    line = readings.reading(workload, SEED, 1.0, control=True)
    assert not line["correct"], line["checks"]
