"""Port parity: the quality suite's graphs, keys and gates, the recipe's
timing benches, and the ``generate`` -> ``train`` -> ``test`` ->
``pipeline`` flow of the port's CLI on the CPU.

The JAX suite's result keys are read from its source (``ast``), so the
test does not pay for a JAX training run.
"""

import ast
import json
from pathlib import Path

import numpy as np
import pytest

import gcn_maxcut_tpu.bench.quality as jq
import gcn_maxcut_tpu.data.io as jio
import gcn_maxcut_tpu_torch.bench.microbench as tmicro
import gcn_maxcut_tpu_torch.bench.quality as tq
from gcn_maxcut_tpu_torch.cli import main

ROOT = Path(__file__).resolve().parent.parent


def _jax_keys(func: str, var: str) -> set:
    """String keys of the dict literal assigned to ``var`` (or stored under
    ``var[...]``) in ``func`` of the JAX quality suite."""
    tree = ast.parse((ROOT / "gcn_maxcut_tpu/bench/quality.py").read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name == func)
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict):
            target = node.targets[0]
            name = target.value if isinstance(target, ast.Subscript) else target
            if isinstance(name, ast.Name) and name.id == var:
                return {k.value for k in node.value.keys}
    raise AssertionError(f"no dict assigned to {var} in {func}")


def _same_specs(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x.n_nodes, list(x.terminals), x.degree) == (y.n_nodes, list(y.terminals), y.degree)
        np.testing.assert_array_equal(x.edges, y.edges)


@pytest.mark.parametrize("recipe", ["n500", "mixed", "per_size"])
def test_recipe_and_suite_graphs_match_jax(recipe):
    a, b = jq._train_specs(recipe), tq._train_specs(recipe)
    assert list(a) == list(b)
    for k in a:
        _same_specs(a[k], b[k])
    if recipe == "mixed":
        for s in tq.SIZES:
            _same_specs(jq._suite_specs(s, 6), tq._suite_specs(s, 6))
    with pytest.raises(ValueError):
        tq._train_specs("nope")


def test_tiny_quality_suite_keys_and_gates():
    res = tq.run_quality_suite(
        sizes=(20, 30), graphs_per_size=2, randomized_iterations=50, max_nodes=32,
        train_kwargs={"number_epochs": 5}, measure_times=False, device="cpu",
    )
    assert set(res) == _jax_keys("run_quality_suite", "result")
    per_size = res["per_size"]
    assert list(per_size) == [20, 30]
    for v in per_size.values():
        assert set(v) == _jax_keys("run_quality_suite", "per_size")
        assert v["graphs"] == 2 and v["refined"] >= v["post"]
        assert v["post_time_s"] == 0.0 and v["refine_time_s"] == 0.0
    assert res["simple_mean"] == pytest.approx(np.mean([v["simple"] for v in per_size.values()]))
    assert res["reference_simple_mean"] == 547.1
    assert res["default_decode_beats_randomized_all_sizes"] == all(
        v["refined"] >= v["randomized"] for v in per_size.values())
    assert res["gcn_post_beats_randomized_sizes"] == sum(
        v["post"] >= v["randomized"] for v in per_size.values())
    assert res["refined_gcn_beats_refined_random_all_sizes"] == all(
        v["refined"] >= v["refined_random"] for v in per_size.values())
    assert res["timing_method"] == "skipped" and res["refine_default"] is True


def test_timing_benches_on_cpu():
    tr = tmicro.bench_train_epoch(num_graphs=2, n=30, max_nodes=32, epochs_timed=2,
                                  device="cpu")
    assert set(tr) == {"num_graphs", "n", "epoch_time_s", "epoch_time_stats",
                       "compile_time_s", "final_epoch_loss", "reference_epoch_time_s",
                       "speedup_vs_reference", "device"}
    assert tr["epoch_time_s"] > 0 and tr["epoch_time_stats"]["n"] == 3
    assert tr["final_epoch_loss"] < 0 and tr["device"] == "cpu"
    assert tr["reference_epoch_time_s"] == pytest.approx(171.81 / 486)
    post = tmicro.bench_post_processing(n=40, d=4, iterations=20, iters=2, device="cpu")
    assert post["samples_per_s"] == pytest.approx(20 / post["time_s"])
    assert {"n", "iterations", "time_s", "samples_per_s"} <= set(post)


def test_generate_train_test_pipeline_commands(tmp_path, capsys):
    ds = tmp_path / "ds.npz"
    assert main(["generate", "--num-graphs", "3", "--min-nodes", "30", "--max-nodes", "40",
                 "--min-degree", "3", "--max-degree", "5", "--pad-to", "48",
                 "--output", str(ds)]) == 0
    assert len(jio.load_dataset(ds).specs) == 3            # the JAX package reads it
    stem = tmp_path / "m" / "mm"
    common = ["--dataset", str(ds), "--model-name", str(stem), "--save-frequency", "2",
              "--device", "cpu"]
    assert main(["train", *common, "--epochs", "5", "--metrics",
                 str(tmp_path / "metrics.jsonl")]) == 0
    first = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert first["epochs"] == 5
    assert len((tmp_path / "metrics.jsonl").read_text().splitlines()) == 5
    ck = next((tmp_path / "m").glob("epoch_2_*"))
    assert main(["train", *common, "--epochs", "7", "--resume", str(ck)]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["epochs"] == 7
    # the training variants run from the command line (a model of their own)
    assert main(["train", "--dataset", str(ds), "--model-name", str(tmp_path / "v" / "vv"),
                 "--device", "cpu", "--epochs", "2", "--lr-schedule", "cosine",
                 "--loss-mode", "quantile", "--entropy-weight", "0.5"]) == 0
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["epochs"] == 2
    assert (tmp_path / "v" / "final_vv.npz").exists()

    out = tmp_path / "res.json"
    assert main(["test", "--dataset", str(ds), "--checkpoint", str(stem.parent / "final_mm.npz"),
                 "--output", str(out), "--device", "cpu"]) == 0
    assert "Performance Analysis" in capsys.readouterr().out
    results = json.loads(out.read_text())["individual_results"]
    assert len(results) == 3
    assert all(r["refined_cut"] >= r["post_cut"] for r in results)

    work = tmp_path / "pipe"
    assert main(["pipeline", "--workdir", str(work), "--num-graphs", "4", "--nodes", "30",
                 "--min-degree", "3", "--max-degree", "5", "--pad-to", "32",
                 "--epochs", "5", "--device", "cpu"]) == 0
    assert "GCN + multi-start refine avg cut" in capsys.readouterr().out
    names = sorted(p.name for p in work.iterdir())
    assert "maxcut_3way_n30_d3_5_dataset.npz" in names
    assert "final_maxcut_3way_n30_d3_5_model.npz" in names
    assert "epoch_0_" in names[0]
