"""Runs across processes: ``parallel.mesh.multi_host_init`` over
``torch.distributed`` (gloo ranks on the CPU), data-parallel and hybrid
training with the data axis spanning two ranks, against the same runs in
one process.

The ranks are spawned (``torch.multiprocessing``, spawn context) and meet
through a ``file://`` store under the test's ``tmp_path``, so parallel test
workers cannot collide on a port.  They import the port only, never JAX.
The data-axis sums change order across the ranks, so losses and
parameters agree at rtol 1e-5; per-graph cuts (whole counts) are equal.
"""

import json
import os
import sys
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from gcn_maxcut_tpu_torch.core.graph import pad_graph_batch
from gcn_maxcut_tpu_torch.data.generate import generate_graph, random_regular_edges
from gcn_maxcut_tpu_torch.data.process import DataConfig, process_graphs
from gcn_maxcut_tpu_torch.parallel import data_parallel as tdp
from gcn_maxcut_tpu_torch.parallel import mesh as tmesh
from gcn_maxcut_tpu_torch.parallel.giant import GiantConfig
from gcn_maxcut_tpu_torch.parallel.hybrid import train_hybrid
from gcn_maxcut_tpu_torch.train import loop as tloop
from gcn_maxcut_tpu_torch.train.config import TrainingConfig

WORLD = 2
DP_CFG = TrainingConfig(n_nodes=16, learning_rate=1e-2)
DP_EPOCHS = 3
HY_N = 64
HY_CFG = GiantConfig(dim_embedding=8, hidden_dim=8, number_epochs=6, learning_rate=1e-2,
                     log_every=1)
TIMEOUT_S = 180


def _batch():
    ds = process_graphs([generate_graph(n=16, d=4, seed=s) for s in range(8)],
                        DataConfig(max_nodes=16))
    return pad_graph_batch([ds.graphs[k] for k in sorted(ds.graphs)])


def _dp_run(entries):
    """3 DP epochs from the seed-0 draw on a data mesh of ``entries`` CPU
    entries (on this rank); the losses and the conv parameters."""
    state = tloop.setup_train_state(DP_CFG, device="cpu")
    mesh = tmesh.make_mesh(("data",), devices=["cpu"] * entries)
    fn = tdp.make_dp_epoch_fn(DP_CFG, state.optimizer, mesh)
    shards = tdp.shard_batch_for_dp(_batch(), mesh)
    losses = [fn(state, shards) for _ in range(DP_EPOCHS)]
    return losses, [p.detach().numpy().tolist() for p in state.optimizer.params]


def _hybrid_run(local_devices):
    lists = []
    for seed in (1, 2):
        e = random_regular_edges(HY_N, 4, seed=seed)
        lists.append((np.concatenate([e[:, 0], e[:, 1]]), np.concatenate([e[:, 1], e[:, 0]])))
    mesh = tmesh.make_mesh(("data", "graph"), shape=(2, 2), devices=["cpu"] * local_devices)
    return train_hybrid(lists, HY_N, HY_CFG, mesh=mesh)


def _rank_main(rank, store, out_dir):
    tmesh.multi_host_init(f"file://{store}", WORLD, rank, backend="gloo")
    try:
        assert tmesh.process_group() == (WORLD, rank)
        dp_losses, dp_params = _dp_run(2)
        hybrid = _hybrid_run(2)
        res = {"dp_losses": dp_losses, "dp_params": dp_params, "hybrid": hybrid,
               "jax_loaded": any(m.split(".")[0] in ("jax", "gcn_maxcut_tpu")
                                 for m in sys.modules)}
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(res, f)
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ranks")
    ctx = mp.start_processes(_rank_main, args=(str(tmp / "store"), str(tmp)), nprocs=WORLD,
                             join=False, start_method="spawn")
    deadline = time.monotonic() + TIMEOUT_S
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the ranks did not finish in {TIMEOUT_S} s")
    assert not any(p.is_alive() for p in ctx.processes)
    return [json.loads((tmp / f"rank{r}.json").read_text()) for r in range(WORLD)]


def test_ranks_import_the_port_only(two_ranks):
    assert not any(r["jax_loaded"] for r in two_ranks)


def test_dp_over_two_ranks_matches_one_process(two_ranks):
    losses, params = _dp_run(4)
    for r in two_ranks:
        np.testing.assert_allclose(r["dp_losses"], losses, rtol=1e-5)
        for got, ref in zip(r["dp_params"], params):
            np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-7)
    assert losses[-1] < losses[0]


def test_hybrid_over_two_ranks_matches_one_process(two_ranks):
    ref = _hybrid_run(4)
    for r in two_ranks:
        got = r["hybrid"]
        np.testing.assert_allclose(got["loss_history"], ref["loss_history"], rtol=1e-5)
        # every rank returns the whole batch's cuts
        assert got["per_graph_cuts"] == ref["per_graph_cuts"] and len(got["per_graph_cuts"]) == 2
        assert (got["mesh_shape"], got["num_graphs"]) == ([2, 2], 2)


@pytest.fixture
def no_launch_env(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)


def test_multi_host_init_single_process(no_launch_env, tmp_path):
    tmesh.multi_host_init()
    assert not dist.is_initialized() and tmesh.process_group() == (1, 0)
    for bad in (dict(num_processes=2, process_id=2), dict(num_processes=2),
                dict(process_id=0), dict(num_processes=0, process_id=0)):
        with pytest.raises(ValueError):
            tmesh.multi_host_init(f"file://{tmp_path / 'never'}", backend="gloo", **bad)
    assert not dist.is_initialized()
    tmesh.multi_host_init(f"file://{tmp_path / 'store'}", 1, 0, backend="gloo")
    try:
        assert tmesh.process_group() == (1, 0)
        tmesh.multi_host_init("127.0.0.1:1", 4, 3)       # a group exists: a no-op
        assert dist.get_world_size() == 1
    finally:
        dist.destroy_process_group()
    assert not dist.is_initialized()


def test_a_world_of_one_equals_no_group(no_launch_env, tmp_path):
    """The all_reduce path with one rank gives the runs without a group, bit
    for bit (the check the card repeats on NCCL)."""
    plain = _dp_run(2), _hybrid_run(4)
    tmesh.multi_host_init(f"file://{tmp_path / 'store'}", 1, 0, backend="gloo")
    try:
        grouped = _dp_run(2), _hybrid_run(4)
    finally:
        dist.destroy_process_group()
    assert grouped[0] == plain[0]
    assert grouped[1]["loss_history"] == plain[1]["loss_history"]
    assert grouped[1]["per_graph_cuts"] == plain[1]["per_graph_cuts"]
