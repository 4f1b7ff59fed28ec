"""Port parity: the hybrid data × graph trainer (``parallel/hybrid.py``) and
``bench --what hybrid`` against the JAX package's, which runs under jitted
``shard_map`` on the virtual CPU devices of tests/conftest.py (never a
Pallas kernel in interpret mode); the port runs its rows on CPU rings.

Inputs are numpy draws: the graphs from a seed, the initial parameters the
JAX trainer's own draw (``hybrid.py``'s, passed as ``params=``).  The JAX
step differentiates a loss holding a ``psum`` inside ``shard_map``, so its
embedding gradient is D times the true one; the port takes the true
gradient, compared with JAX's / D.  Conv gradients and the embedding
gradient: rtol 1e-5 (atol 1e-6 for entries near zero); per-graph losses
(whole cut counts) equal; 20-epoch histories rtol 1e-3, where only Adam's
eps sees the factor D.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from gcn_maxcut_tpu.data.generate import random_regular_edges
from gcn_maxcut_tpu.models.gcn import gcn_conv_init
from gcn_maxcut_tpu.parallel import giant as jgiant
from gcn_maxcut_tpu.parallel import hybrid as jhybrid
from gcn_maxcut_tpu.parallel import partition as jpart
from gcn_maxcut_tpu.parallel.mesh import make_mesh as jmake_mesh
from gcn_maxcut_tpu_torch.bench.microbench import banded_random_edges
from gcn_maxcut_tpu_torch.cli import main as cli_main
from gcn_maxcut_tpu_torch.parallel import giant as tgiant
from gcn_maxcut_tpu_torch.parallel import hybrid as thybrid
from gcn_maxcut_tpu_torch.parallel import partition as tpart
from gcn_maxcut_tpu_torch.parallel.mesh import make_mesh


def _coo(edges):
    return (np.concatenate([edges[:, 0], edges[:, 1]]),
            np.concatenate([edges[:, 1], edges[:, 0]]))


def _graphs(n, d, seeds):
    return [_coo(random_regular_edges(n, d, seed=s)) for s in seeds]


def _jax_init(cfg, B, D, n_shard):
    """The JAX hybrid trainer's initial draw (``train_hybrid``) as numpy."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(cfg.seed), 3)
    return {
        "conv1": {k: np.asarray(v) for k, v in
                  gcn_conv_init(k1, cfg.dim_embedding, cfg.hidden_dim).items()},
        "conv2": {k: np.asarray(v) for k, v in
                  gcn_conv_init(k2, cfg.hidden_dim, cfg.num_classes).items()},
        "embed": np.asarray(jax.random.normal(
            k3, (B, D, n_shard, cfg.dim_embedding), jnp.float32)),
    }


def _capture_grads():
    """An optax transformation that applies no update and keeps the
    gradients as its state: one JAX step's gradients, exactly."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree_util.tree_map(jnp.zeros_like, grads), grads))


def _port_state(p0, mesh, sgb, lr):
    rows = thybrid._rows_of(sgb, mesh, "data", "graph")
    n_shard, f = sgb[0].n_shard, p0["embed"].shape[-1]
    state = tgiant.GiantState.from_blocks(
        {**p0, "embed": p0["embed"].reshape(-1, n_shard, f)},
        [dev for row in rows for dev in row.devices], lr)
    return state, rows


@pytest.mark.parametrize("R,D", [(2, 4), (4, 2), (2, 3)], ids=["2x4", "4x2", "2x3"])
def test_one_hybrid_step_matches_jax(R, D):
    n = 48
    kw = dict(dim_embedding=8, hidden_dim=8, num_classes=3)
    jcfg = jgiant.GiantConfig(epochs_per_call=1, **kw)
    lists = _graphs(n, 4, range(R))
    jsgb = jhybrid.stack_sharded_graphs([jpart.shard_graph(s, r, n, D)[0] for s, r in lists])
    p0 = _jax_init(jcfg, R, D, jsgb.n_shard)
    conv = {k: {kk: jnp.asarray(vv) for kk, vv in p0[k].items()} for k in ("conv1", "conv2")}
    jmesh = jmake_mesh(("data", "graph"), shape=(R, D), devices=jax.devices()[:R * D])
    embeds = jax.device_put(jnp.asarray(p0["embed"]), NamedSharding(jmesh, P("data", "graph")))
    opt = _capture_grads()
    opt_state = opt.init((conv, embeds))
    step = jhybrid.make_hybrid_step(jsgb, jmesh, jcfg, opt, opt_state, (conv, embeds))
    _, _, (jconv_g, jembed_g), losses, per_graph = step(conv, embeds, opt_state)

    mesh = make_mesh(("data", "graph"), shape=(R, D), devices=["cpu"] * (R * D))
    sgb = thybrid.stack_sharded_graphs([tpart.shard_graph(s, r, n, D)[0] for s, r in lists])
    state, rows = _port_state(p0, mesh, sgb, 1e-3)
    graphs = [sg.to(row) for sg, row in zip(sgb, rows)]
    total, got_per_graph, grads = thybrid._local_grads(state, graphs, rows,
                                                       tgiant.GiantConfig(**kw))
    np.testing.assert_array_equal(got_per_graph.numpy(), np.asarray(per_graph))
    assert float(total) / R == float(losses[0])
    for g, ref in zip(grads[:4], (jconv_g["conv1"]["w"], jconv_g["conv1"]["b"],
                                  jconv_g["conv2"]["w"], jconv_g["conv2"]["b"])):
        np.testing.assert_allclose(g.numpy() / R, np.asarray(ref), rtol=1e-5, atol=1e-6)
    got_embed = torch.stack(grads[4:]).reshape(jembed_g.shape).numpy()
    # the JAX embedding gradient is D times the true one (psum in the loss)
    np.testing.assert_allclose(got_embed, np.asarray(jembed_g) / D, rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="module")
def jax_history():
    """JAX ``train_hybrid`` on two 6-regular graphs of 48 nodes, 2 × 4."""
    n = 48
    kw = dict(dim_embedding=16, hidden_dim=16, number_epochs=20, learning_rate=5e-3,
              log_every=1)
    lists = _graphs(n, 6, (1, 2))
    ref = jhybrid.train_hybrid(lists, n, jgiant.GiantConfig(epochs_per_call=10, **kw),
                               mesh_shape=(2, 4))
    return n, kw, lists, ref


def test_train_hybrid_history_matches_jax(jax_history):
    n, kw, lists, ref = jax_history
    n_shard = jpart.shard_graph(*lists[0], n, 4)[0].n_shard
    p0 = _jax_init(jgiant.GiantConfig(**kw), 2, 4, n_shard)
    mesh = make_mesh(("data", "graph"), shape=(2, 4), devices=["cpu"] * 8)
    got = thybrid.train_hybrid(lists, n, tgiant.GiantConfig(**kw), mesh=mesh, params=p0)
    assert (got["epochs"], got["mesh_shape"], got["num_graphs"]) == (20, (2, 4), 2)
    np.testing.assert_allclose(got["loss_history"], ref["loss_history"], rtol=1e-3)
    np.testing.assert_allclose(got["final_mean_loss"], ref["final_mean_loss"], rtol=1e-3)
    np.testing.assert_allclose(got["per_graph_cuts"], ref["per_graph_cuts"], rtol=1e-3)
    assert got["loss_history"][-1] < got["loss_history"][0]


def test_bench_hybrid_prints_the_jax_keys(jax_history, capsys):
    ref = jax_history[3]
    assert cli_main(["bench", "--what", "hybrid", "--n", "25600", "--d", "4",
                     "--giant-epochs", "3", "--device", "cpu"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])["hybrid"]
    assert set(res) == set(ref)
    # 3 epochs round up to one chunk of 10, as in the JAX command
    assert (res["mesh_shape"], res["num_graphs"], res["epochs"]) == ([1, 1], 1, 10)
    assert len(res["per_graph_cuts"]) == 1 and len(res["loss_history"]) == 1


def test_duplicated_graph_tracks_the_giant_trainer():
    """B = 2 copies of one graph with equal embeddings on a 2 × 4 mesh: the
    conv gradients are the mean of two equal per-graph gradients, so the
    conv parameters and both embedding copies track the giant trainer on a
    4-shard ring (the JAX package's own test, against the port's trainer)."""
    n, D, epochs = 32, 4, 3
    kw = dict(dim_embedding=8, hidden_dim=8, learning_rate=1e-2)
    s, r = _graphs(n, 4, (0,))[0]
    sg = tpart.shard_graph(s, r, n, D)[0]
    rng = np.random.default_rng(7)
    p0 = {"conv1": {"w": rng.normal(size=(8, 8)).astype(np.float32) * 0.3,
                    "b": np.zeros(8, np.float32)},
          "conv2": {"w": rng.normal(size=(8, 3)).astype(np.float32) * 0.3,
                    "b": np.zeros(3, np.float32)},
          "embed": rng.normal(size=(D, sg.n_shard, 8)).astype(np.float32)}
    cfg = tgiant.GiantConfig(**kw)
    ring = make_mesh(devices=["cpu"] * D)
    gstate = tgiant.GiantState.create(p0, ring, cfg.learning_rate)
    g_losses = [float(tgiant._epoch(gstate, sg.to(ring), ring, cfg)) for _ in range(epochs)]

    mesh = make_mesh(("data", "graph"), shape=(2, D), devices=["cpu"] * (2 * D))
    sgb = thybrid.stack_sharded_graphs([sg, sg])
    state, _ = _port_state({**p0, "embed": np.stack([p0["embed"]] * 2)}, mesh, sgb,
                           cfg.learning_rate)
    step = thybrid.make_hybrid_step(sgb, mesh, cfg, state)
    runs = [step() for _ in range(epochs)]
    np.testing.assert_allclose([float(m[0]) for m, _ in runs], g_losses, rtol=1e-5)
    np.testing.assert_allclose(runs[-1][1].numpy(), [g_losses[-1]] * 2, rtol=1e-5)
    for a, b in zip(state.leaves()[:4], gstate.leaves()[:4]):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), rtol=1e-5, atol=1e-6)
    copies = [torch.stack([e.detach() for e in state.embeds[i * D:(i + 1) * D]]) for i in (0, 1)]
    np.testing.assert_allclose(copies[0].numpy(), gstate.embed().numpy(), rtol=1e-5, atol=1e-6)
    assert torch.equal(copies[0], copies[1])


def _sharded(n, d, seed, D, **kw):
    return tpart.shard_graph(*_graphs(n, d, (seed,))[0], n, D, **kw)[0]


@pytest.mark.parametrize("other,match", [
    (lambda: _sharded(32, 4, 1, 2), "num_shards"),
    (lambda: _sharded(40, 4, 1, 4), "n_shard"),
    (lambda: tpart.shard_graph(*random_regular_edges(32, 4, seed=1).T, 32, 4)[0],
     "symmetric"),
    (lambda: _sharded(32, 4, 1, 4, build_ell=False), "ELL tables"),
], ids=["num_shards", "n_shard", "symmetric", "ell"])
def test_stack_sharded_graphs_raises_the_jax_errors(other, match):
    base = _sharded(32, 4, 0, 4)
    with pytest.raises(ValueError, match=match):
        thybrid.stack_sharded_graphs([base, other()])
    with pytest.raises(ValueError, match="at least one"):
        thybrid.stack_sharded_graphs([])


def test_stack_keeps_each_graphs_tables_and_plan():
    # different e_group (d = 4 and 12): JAX pads, the port keeps each graph
    n, D = 256, 4
    small, dense = _sharded(n, 4, 3, D), _sharded(n, 12, 4, D)
    assert small.e_group < dense.e_group
    assert thybrid.stack_sharded_graphs([small, dense]) == (small, dense)
    # matching plans are kept (the JAX test's graphs: offsets 1, 2, 5, shifted)
    n, offs = 2048, (1, 2, 5)
    sgs = []
    for shift in (0, 1):
        s = np.concatenate([np.arange(n) for _ in offs])
        r = np.concatenate([(np.arange(n) + o + shift) % n for o in offs])
        sgs.append(tpart.shard_graph(np.concatenate([s, r]), np.concatenate([r, s]), n, 1,
                                     block_ell=True)[0])
    stacked = thybrid.stack_sharded_graphs(sgs)
    assert all(sg.bell_senders is not None for sg in stacked)
    assert stacked[0].bell_block == sgs[0].bell_block


def test_plans_of_other_geometries_change_no_result():
    """Two banded graphs whose hop-0 plans differ in geometry: JAX drops both
    plans and runs the gather tables; the port keeps each plan (K1's plain
    version here).  One step's losses and gradients agree with the run of
    the same graphs without plans."""
    n, D = 4096, 2
    lists = [_coo(banded_random_edges(n, 8, w, seed)) for w, seed in ((63, 0), (255, 1))]
    with_plans = thybrid.stack_sharded_graphs([
        tpart.shard_graph(s, r, n, D, local_reorder="rcm", block_ell=True)[0] for s, r in lists])
    assert all(sg.bell_senders is not None for sg in with_plans)
    assert len({(sg.bell_block, sg.bell_wp) for sg in with_plans}) == 2
    without = thybrid.stack_sharded_graphs([
        tpart.shard_graph(s, r, n, D, local_reorder="rcm")[0] for s, r in lists])
    mesh = make_mesh(("data", "graph"), shape=(2, D), devices=["cpu"] * (2 * D))
    rng = np.random.default_rng(9)
    p0 = {"conv1": {"w": rng.normal(size=(16, 8)).astype(np.float32) * 0.3,
                    "b": np.zeros(8, np.float32)},
          "conv2": {"w": rng.normal(size=(8, 3)).astype(np.float32) * 0.3,
                    "b": np.zeros(3, np.float32)},
          "embed": rng.normal(size=(2, D, with_plans[0].n_shard, 16)).astype(np.float32)}
    cfg = tgiant.GiantConfig(dim_embedding=16, hidden_dim=8)
    outs = []
    for sgb in (with_plans, without):
        state, rows = _port_state(p0, mesh, sgb, 1e-3)
        outs.append(thybrid._local_grads(state, [sg.to(row) for sg, row in zip(sgb, rows)],
                                         rows, cfg))
    np.testing.assert_array_equal(outs[0][1].numpy(), outs[1][1].numpy())
    for a, b in zip(outs[0][2], outs[1][2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


def test_two_axis_mesh_validates_as_jax():
    for kw, match in ((dict(), "shape required"), (dict(shape=(2, 3)), r"\(2, 3\) != 8 devices")):
        with pytest.raises(ValueError, match=match):
            jmake_mesh(("data", "graph"), devices=jax.devices()[:8], **kw)
        with pytest.raises(ValueError, match=match):
            make_mesh(("data", "graph"), devices=["cpu"] * 8, **kw)
    mesh = make_mesh(("data", "graph"), shape=(2, 4), devices=["cpu"] * 8)
    assert (mesh.shape, mesh.axis_size("data"), mesh.axis_size("graph")) == ((2, 4), 2, 4)
    assert mesh.row(1) is mesh.rows[1] and mesh.row(1).size == 4 and len(mesh.devices) == 8
    with pytest.raises(ValueError, match="not on this process"):
        mesh.row(2)
    with pytest.raises(ValueError, match="mesh"):
        thybrid.train_hybrid(_graphs(32, 4, (0,)), 32, tgiant.GiantConfig(number_epochs=1),
                             mesh=make_mesh(devices=["cpu"] * 2))
    ring = make_mesh(devices=["cpu"] * 3)             # 1-D calls are unchanged
    assert (type(ring).__name__, ring.size, ring.axis_name) == ("Mesh", 3, "graph")
