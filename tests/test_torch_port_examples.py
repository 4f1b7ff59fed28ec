"""The port's examples (``gcn_maxcut_tpu_torch/examples/``) run end to end
on the CPU at a small size and exit 0, each writing what its JAX script
writes."""

import json

import numpy as np
import pytest

from gcn_maxcut_tpu_torch.examples import (
    complete_training_pipeline,
    giant_scale_pipeline,
    neural_network_testing,
    torch_migration,
    visualization_demo,
)
from gcn_maxcut_tpu_torch.train.checkpoint import save_checkpoint
from gcn_maxcut_tpu_torch.train.config import TrainingConfig
from gcn_maxcut_tpu_torch.train.loop import setup_train_state
from gcn_maxcut_tpu_torch.train.torch_compat import load_torch_checkpoint
from tests.test_torch_compat import _make_reference_checkpoint


def test_complete_training_pipeline_quick(tmp_path, capsys):
    assert complete_training_pipeline.main(str(tmp_path), quick=True, device="cpu") == 0
    for name in ("final_maxcut3way.npz", "SUMMARY.md", "results.json", "loss_curve.png",
                 "comparison.png"):
        assert (tmp_path / name).stat().st_size > 0, name
    assert "randomized" in capsys.readouterr().out


def test_giant_scale_pipeline_small(capsys):
    assert giant_scale_pipeline.main(N=2000, device="cpu") == 0
    out = capsys.readouterr().out
    assert "metis 4-way partition" in out and "GCN warm-start margin" in out


def test_testing_then_visualization(tmp_path, monkeypatch):
    monkeypatch.setattr(neural_network_testing, "GRAPH_SIZES", [20, 30])
    monkeypatch.setattr(neural_network_testing, "GRAPHS_PER_SIZE", 2)
    monkeypatch.setattr(neural_network_testing, "POST_ITERATIONS", 20)
    monkeypatch.setattr(neural_network_testing, "PAD", 32)
    cfg = TrainingConfig(n_nodes=32)
    ckpt = save_checkpoint(tmp_path / "final_m", params=setup_train_state(cfg, device="cpu")
                           .params(), config=cfg)
    out = tmp_path / "testing"
    assert neural_network_testing.main(str(ckpt), str(out), device="cpu") == 0
    results = json.loads((out / "results.json").read_text())
    assert len(results["individual_results"]) == 4
    assert (out / "test_panel.png").stat().st_size > 0
    figs = tmp_path / "figs"
    assert visualization_demo.main(str(out / "results.json"), str(figs)) == 0
    for name in ("comparison.png", "runtime.png", "scalability.png", "panel.png"):
        assert (figs / name).stat().st_size > 0, name


def test_torch_migration(tmp_path):
    path = str(tmp_path / "final_refmodel.pth")
    _make_reference_checkpoint(path)
    out = torch_migration.main(path, device="cpu")
    assert len(out["losses"]) == 5 and np.isfinite(out["losses"]).all()
    assert out["exported"] == path.replace(".pth", "_continued.pth")
    params, _, meta = load_torch_checkpoint(out["exported"])
    assert meta["epoch"] == 47 and meta["loss_history"][-1] == pytest.approx(out["losses"][-1])
    assert params["conv1"]["w"].shape == (64, 32)
