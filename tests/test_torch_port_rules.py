"""Rules of the port: no JAX in it, and the card unless the CPU is asked for."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from gcn_maxcut_tpu_torch import device as tdevice
from gcn_maxcut_tpu_torch.bench.giant_demo import train_banded_giant_packed
from gcn_maxcut_tpu_torch.bench.kway_sweep import kway_sweep
from gcn_maxcut_tpu_torch.bench.locality import train_locality
from gcn_maxcut_tpu_torch.bench.microbench import (
    bench_post_processing,
    bench_spmm,
    bench_spmm_banded,
    bench_train_epoch,
)
from gcn_maxcut_tpu_torch.bench.quality import run_quality_suite
from gcn_maxcut_tpu_torch.bench.scaling import bench_sharded_conv, scaling_sweep
from gcn_maxcut_tpu_torch.cli import main as cli_main
from gcn_maxcut_tpu_torch.convert import params_from_jax
from gcn_maxcut_tpu_torch.data.generate import random_regular_edges
from gcn_maxcut_tpu_torch.experiments import (
    gather_probe,
    gather_probe2,
    panel_ell_probe,
    subblock_probe,
    weighted_probe,
)
from gcn_maxcut_tpu_torch.ops import halo as th
from gcn_maxcut_tpu_torch.parallel import giant_banded as tgb
from gcn_maxcut_tpu_torch.parallel.giant import GiantConfig, train_giant_graph
from gcn_maxcut_tpu_torch.parallel.mesh import make_mesh

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "gcn_maxcut_tpu")


def _port_files():
    files = sorted((ROOT / "gcn_maxcut_tpu_torch").rglob("*.py"))
    return [*files, ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
def test_port_imports_no_jax(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, f"{path}: imports {name}"


def test_resolve_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdevice.resolve_device()
    with pytest.raises(RuntimeError):
        tdevice.resolve_device("cuda")
    assert tdevice.resolve_device("cpu") == torch.device("cpu")
    # entry points go through it: no silent CPU fallback
    with pytest.raises(RuntimeError):
        params_from_jax({"w": [[1.0]]})
    with pytest.raises(RuntimeError):
        train_banded_giant_packed(n=4096, epochs=1)
    for entry in (train_locality, bench_spmm, bench_spmm_banded):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            entry(n=4096)
    for probe in (gather_probe, gather_probe2, subblock_probe, panel_ell_probe, weighted_probe):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            probe.main(n=4096)


def test_mesh_and_halo_trainers_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        make_mesh()
    with pytest.raises(RuntimeError):
        make_mesh(devices=["cuda:0"] * 2)
    with pytest.raises(RuntimeError):
        tgb.train_halo_giant(64)
    with pytest.raises(RuntimeError):
        tgb.train_halo_giant_packed(64)
    # a CPU ring is asked for by name, and then the trainers run
    ring = make_mesh(devices=["cpu"] * 2)
    assert ring.size == 2 and ring.devices == (torch.device("cpu"),) * 2
    cfg = tgb.PackedHaloGiantConfig(d=4, bandwidth=7, epochs=1)
    assert tgb.train_halo_giant_packed(256, cfg, ring)["num_devices"] == 2


def test_halo_ops_raise_on_a_shard_off_its_mesh_device():
    ring = make_mesh(devices=["cpu"] * 2)
    xs = [torch.zeros(64, 8), torch.zeros(64, 8, device="meta")]
    with pytest.raises(ValueError, match="mesh device"):
        th.halo_banded_spmm_unit(xs, (1, -1), ring, 16)
    with pytest.raises(ValueError, match="mesh device"):
        th.halo_banded_spmm_unit_packed(xs, (1, -1), 8, ring)
    # a shard that is neither on the CPU nor on CUDA takes no plain path
    meta = make_mesh(devices=["meta"] * 2)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        th.halo_banded_spmm_unit([torch.zeros(64, 8, device="meta")] * 2, (1, -1), meta, 16)


@pytest.mark.parametrize("entry", [
    lambda path: run_quality_suite(sizes=(20,), graphs_per_size=1),
    lambda path: bench_train_epoch(num_graphs=1, n=20, max_nodes=24),
    lambda path: bench_post_processing(n=20, d=4),
    lambda path: cli_main(["train", "--dataset", path, "--model-name", path + "m"]),
    lambda path: cli_main(["test", "--dataset", path, "--checkpoint", path + "ck"]),
], ids=["quality", "train_epoch", "post_processing", "train_command", "test_command"])
def test_recipe_entry_points_raise_without_cuda(monkeypatch, tmp_path, entry):
    path = str(tmp_path / "ds.npz")
    assert cli_main(["generate", "--num-graphs", "1", "--min-nodes", "20", "--max-nodes",
                     "20", "--min-degree", "4", "--max-degree", "4", "--pad-to", "24",
                     "--output", path]) == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        entry(path)


def test_sharded_entry_points_raise_without_cuda(monkeypatch):
    edges = random_regular_edges(64, 4, seed=0)
    s = np.concatenate([edges[:, 0], edges[:, 1]])
    r = np.concatenate([edges[:, 1], edges[:, 0]])
    cfg = GiantConfig(dim_embedding=8, hidden_dim=4, number_epochs=1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="devices="):
        train_giant_graph(s, r, 64, cfg)
    with pytest.raises(RuntimeError):
        train_giant_graph(s, r, 64, cfg, mesh=make_mesh(devices=["cuda:0"]))
    with pytest.raises(RuntimeError, match="devices="):
        kway_sweep(n=64, d=4, ks=(3,), epochs=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bench_sharded_conv(64, 4, feature_dim=8, out_dim=4)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        scaling_sweep(64, 4, feature_dim=8)
    for argv in (["bench", "--what", "kway", "--n", "64", "--d", "4"],
                 ["bench", "--what", "scaling", "--n", "64", "--d", "4"]):
        with pytest.raises(RuntimeError):
            cli_main(argv)
    # asked for by name, the CPU runs them
    assert train_giant_graph(s, r, 64, cfg, mesh=make_mesh(devices=["cpu"] * 2))["num_shards"] == 2
    (res,) = kway_sweep(n=64, d=4, ks=(3,), epochs=1, dim_embedding=8, hidden_dim=4,
                        device="cpu")
    assert res["num_shards"] == 1
    assert bench_sharded_conv(64, 4, feature_dim=8, out_dim=4, iters=1,
                              device="cpu")["device"] == "cpu"
