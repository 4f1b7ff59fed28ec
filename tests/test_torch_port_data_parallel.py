"""Port parity: data-parallel recipe training (``parallel/data_parallel.py``)
against the JAX ``make_dp_epoch_fn`` under ``shard_map`` on the virtual CPU
devices of tests/conftest.py.

Both start from the JAX ``setup_train_state`` parameters (copied through
``params_from_jax``), dropout 0 (the config default).  Tolerances: the loss
after 1 and 20 epochs rtol 1e-4 (the recipe loop's contract), the conv
parameters after one epoch rtol 1e-5, atol 1e-6.  The port aggregates on
the recipe's dense operators where the JAX function takes the sparse
path, and sums each entry's gradients in another order: float sums only.
"""

import jax
import numpy as np
import pytest
import torch

import gcn_maxcut_tpu.core.graph as jgraph
import gcn_maxcut_tpu.data.generate as jgen
import gcn_maxcut_tpu.data.process as jproc
import gcn_maxcut_tpu.parallel.data_parallel as jdp
import gcn_maxcut_tpu.train.loop as jloop
import gcn_maxcut_tpu_torch.core.graph as tgraph
import gcn_maxcut_tpu_torch.data.generate as tgen
import gcn_maxcut_tpu_torch.data.process as tproc
import gcn_maxcut_tpu_torch.parallel.data_parallel as tdp
import gcn_maxcut_tpu_torch.train.loop as tloop
from gcn_maxcut_tpu.parallel.mesh import make_mesh as jmake_mesh
from gcn_maxcut_tpu.train.config import TrainingConfig as JConfig
from gcn_maxcut_tpu_torch.convert import params_from_jax
from gcn_maxcut_tpu_torch.parallel.mesh import make_mesh
from gcn_maxcut_tpu_torch.train.config import TrainingConfig

N, D, B = 16, 4, 8
CFG = dict(n_nodes=N, learning_rate=1e-2)


@pytest.fixture(scope="module")
def batches():
    bj = jgraph.pad_graph_batch([g for _, g in sorted(jproc.process_graphs(
        [jgen.generate_graph(n=N, d=D, seed=s) for s in range(B)],
        jproc.DataConfig(max_nodes=N)).graphs.items())])
    bt = tgraph.pad_graph_batch([g for _, g in sorted(tproc.process_graphs(
        [tgen.generate_graph(n=N, d=D, seed=s) for s in range(B)],
        tproc.DataConfig(max_nodes=N)).graphs.items())])
    return bj, bt


def _conv(params):
    return {f"{layer}/{k}": np.asarray(params[layer][k].detach() if hasattr(
        params[layer][k], "detach") else params[layer][k])
        for layer in ("conv1", "conv2") for k in ("w", "b")}


def _port_run(bt, start, entries, epochs):
    cfg = TrainingConfig(**CFG)
    state = tloop.setup_train_state(cfg, params=params_from_jax(start, "cpu"), device="cpu")
    mesh = make_mesh(("data",), devices=["cpu"] * entries)
    fn = tdp.make_dp_epoch_fn(cfg, state.optimizer, mesh)
    shards = tdp.shard_batch_for_dp(bt, mesh)
    losses = [fn(state, shards) for _ in range(epochs)]
    return losses, state


@pytest.mark.parametrize("entries", [8, 2])
def test_dp_epochs_match_jax(batches, entries):
    bj, bt = batches
    jcfg = JConfig(**CFG)
    jstate = jloop.setup_train_state(jcfg)
    start = jax.tree_util.tree_map(np.asarray, jstate.params)
    jmesh = jmake_mesh(("data",), devices=jax.devices()[:entries])
    fn = jdp.make_dp_epoch_fn(jcfg, jstate.optimizer, jmesh)
    batch_sh = jdp.shard_batch_for_dp(bj, jmesh)
    params, opt_state = jstate.params, jstate.opt_state
    jlosses, jparams1 = [], None
    for i in range(20):
        params, opt_state, loss = fn(params, opt_state, batch_sh, jax.random.PRNGKey(i))
        jlosses.append(float(loss))
        jparams1 = jparams1 or _conv(params)

    losses, state = _port_run(bt, start, entries, 1)
    np.testing.assert_allclose(losses[0], jlosses[0], rtol=1e-4)
    for k, v in _conv(state.model.params()).items():
        np.testing.assert_allclose(v, jparams1[k], rtol=1e-5, atol=1e-6, err_msg=k)
    losses, _ = _port_run(bt, start, entries, 20)
    np.testing.assert_allclose(losses[-1], jlosses[-1], rtol=1e-4)
    assert losses[0] < 0 and losses[-1] < losses[0]      # -Σ cuts, and it trains


def test_dp_epoch_deterministic(batches):
    _, bt = batches
    start = jax.tree_util.tree_map(np.asarray, jloop.setup_train_state(JConfig(**CFG)).params)
    runs = [_port_run(bt, start, 8, 4) for _ in range(2)]
    assert runs[0][0] == runs[1][0]
    for a, b in zip(runs[0][1].optimizer.params, runs[1][1].optimizer.params):
        assert torch.equal(a, b)


def test_dp_batch_must_divide_the_data_axis(batches):
    _, bt = batches
    with pytest.raises(ValueError, match="must divide data axis 3"):
        tdp.shard_batch_for_dp(bt, make_mesh(("data",), devices=["cpu"] * 3))
    with pytest.raises(ValueError, match="named 'data'"):
        tdp.shard_batch_for_dp(bt, make_mesh(devices=["cpu"] * 2))
    shards = tdp.shard_batch_for_dp(bt, make_mesh(("data",), devices=["cpu"] * 4))
    assert [int(s.n_nodes.shape[0]) for s in shards] == [2] * 4
    assert torch.equal(shards[1].senders, bt.senders[2:4])
