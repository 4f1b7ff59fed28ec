"""Port parity: the sharded SpMM, the giant trainer and the k-way sweep.

The JAX package runs its ``parallel/spmm.py`` and ``parallel/giant.py`` under
``jax.shard_map`` on the virtual CPU devices of tests/conftest.py; the port
runs the same shards on a CPU ring (``make_mesh(devices=["cpu"] * D)``),
where hop 0's block-ELL route takes K1's plain version.  Inputs are numpy
draws from a seed.  Tolerances: activations and gradients rtol 1e-4 (the
ROADMAP's layer tolerance; float sums in other orders), atol 1e-5.  The
block-ELL route is held against the JAX package's gather-table route
(never a Pallas kernel in interpret mode).  The port's sharded conv
projects first when that narrows the width; the JAX one preferred a
128-lane width when a plan was attached, which changes only the order of
float sums (same tolerance).

The JAX training step differentiates a loss that holds a ``psum`` inside
``shard_map``, so its embedding gradient is D times the true one (its conv
gradients are right: ``pmean`` of D-scaled shares).  The port takes the
true gradient: one step's embedding gradient is compared with JAX's / D.
Adam is invariant to that scale up to its eps, so loss histories agree.
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from gcn_maxcut_tpu.data.generate import random_regular_edges
from gcn_maxcut_tpu.models.gcn import gcn_conv_init
from gcn_maxcut_tpu.parallel import giant as jgiant
from gcn_maxcut_tpu.parallel import partition as jpart
from gcn_maxcut_tpu.parallel import spmm as jspmm
from gcn_maxcut_tpu.parallel.mesh import make_mesh as jmake_mesh
from gcn_maxcut_tpu_torch.bench.kway_sweep import kway_sweep
from gcn_maxcut_tpu_torch.bench.microbench import banded_random_edges
from gcn_maxcut_tpu_torch.bench.scaling import bench_sharded_conv, scaling_sweep
from gcn_maxcut_tpu_torch.parallel import giant as tgiant
from gcn_maxcut_tpu_torch.parallel import partition as tpart
from gcn_maxcut_tpu_torch.parallel import spmm as tspmm
from gcn_maxcut_tpu_torch.parallel.mesh import make_mesh

RTOL, ATOL = 1e-4, 1e-5


def _coo(edges):
    return (np.concatenate([edges[:, 0], edges[:, 1]]),
            np.concatenate([edges[:, 1], edges[:, 0]]))


def _ring(D):
    return make_mesh(devices=["cpu"] * D)


def _blocks(a, requires_grad=False):
    return [torch.tensor(x, requires_grad=requires_grad) for x in a]


def _stack(ts):
    return np.stack([t.detach().numpy() for t in ts])


def _jax_map(fn, sg, D, n_in, out_specs=P("graph")):
    """jit(shard_map(fn)) over D virtual devices: fn(local sg, *args) with
    the first ``n_in`` arguments [D, ...] sharded on the leading axis (fn
    gets shard d's block) and the rest replicated."""
    mesh = jmake_mesh(("graph",), devices=jax.devices()[:D])

    @jax.jit
    def run(*args):
        specs = (jpart.shard_specs(sg),) + (P("graph"),) * n_in + (P(),) * (len(args) - n_in)
        return jax.shard_map(
            lambda sg_, *a: fn(jpart.local_shard(sg_), *[x[0] for x in a[:n_in]], *a[n_in:]),
            mesh=mesh, in_specs=specs, out_specs=out_specs, check_vma=False)(sg, *args)
    return run


def _graphs(n, D, s, r, **kw):
    jsg, g2l = jpart.shard_graph(s, r, n, D, **kw)
    tsg, tg2l = tpart.shard_graph(s, r, n, D, **kw)
    np.testing.assert_array_equal(g2l, tg2l)
    return jsg, tsg.to(_ring(D)), g2l


@pytest.mark.parametrize("D,schedule,build_ell", [
    (1, "ring", True), (2, "allgather", False), (4, "ring", True),
    (4, "allgather", True), (4, "ring", False),
], ids=["D1-ring-ell", "D2-allgather-coo", "D4-ring-ell", "D4-allgather-ell", "D4-ring-coo"])
def test_sharded_spmm_matches_jax(D, schedule, build_ell):
    n, F = 200, 8
    s, r = _coo(random_regular_edges(n, 6, seed=1))
    w = np.ones(s.shape[0], np.float32)
    jsg, tsg, _ = _graphs(n, D, s, r, weights=w, build_ell=build_ell)
    assert (tsg.ell_senders is not None) is build_ell
    rng = np.random.default_rng(2)
    x = rng.normal(size=(D, tsg.n_shard, F)).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)

    fwd = _jax_map(lambda sg_, x_: jspmm.make_sharded_spmm(schedule)(sg_, x_, "graph")[None],
                   jsg, D, 1)
    sym = _jax_map(lambda sg_, x_: jspmm.sharded_spmm_sym(sg_, x_, "graph", schedule)[None],
                   jsg, D, 1)
    ref = np.asarray(fwd(jnp.asarray(x)))
    ref_grad = np.asarray(jax.grad(lambda x_: jnp.sum(sym(x_) * dy))(jnp.asarray(x)))

    mesh = _ring(D)
    xs = _blocks(x, requires_grad=True)
    ys = tspmm.make_sharded_spmm(schedule)(tsg, xs, mesh)
    np.testing.assert_allclose(_stack(ys), ref, rtol=RTOL, atol=ATOL)
    for ys in (tspmm.sharded_spmm_sym(tsg, xs, mesh, schedule), ys):   # symmetric, autograd
        grads = torch.autograd.grad(sum(torch.sum(y * torch.tensor(g)) for y, g in zip(ys, dy)),
                                    xs)
        np.testing.assert_allclose(_stack(grads), ref_grad, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("D,F", [(2, 64), (4, 3)])
def test_block_ell_route_matches_jax_gather_tables(D, F):
    # a banded graph: with block_ell every shard's hop 0 runs K1's plain
    # version; the JAX reference is its gather-table route on the same ids
    n = 8192
    s, r = _coo(banded_random_edges(n, 8, 63, 3))
    jsg, g2l = jpart.shard_graph(s, r, n, D, local_reorder="rcm")
    tsg, tg2l = tpart.shard_graph(s, r, n, D, local_reorder="rcm", block_ell=True)
    np.testing.assert_array_equal(g2l, tg2l)
    assert tsg.bell_block is not None and jsg.bell_block is None
    mesh = _ring(D)
    tsg = tsg.to(mesh)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(D, tsg.n_shard, F)).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    sym = _jax_map(lambda sg_, x_: jspmm.sharded_spmm_sym(sg_, x_, "graph", "ring")[None],
                   jsg, D, 1)
    ref = np.asarray(sym(jnp.asarray(x)))
    ref_grad = np.asarray(jax.grad(lambda x_: jnp.sum(sym(x_) * dy))(jnp.asarray(x)))

    xs = _blocks(x, requires_grad=True)
    ys = tspmm.sharded_spmm_sym(tsg, xs, mesh)
    np.testing.assert_allclose(_stack(ys), ref, rtol=RTOL, atol=ATOL)
    grads = torch.autograd.grad(sum(torch.sum(y * torch.tensor(g)) for y, g in zip(ys, dy)), xs)
    np.testing.assert_allclose(_stack(grads), ref_grad, rtol=RTOL, atol=ATOL)


def test_asymmetric_graph_gradient_is_the_transpose():
    # one direction of each banded edge: no hop-0 plan is attached, and the
    # conv's gradient is autograd's Aᵀ·dy on the dense matrix, not A·dy
    n, D, F = 2048, 2, 8
    e = banded_random_edges(n, 8, 63, 5)
    sg, g2l = tpart.shard_graph(e[:, 0], e[:, 1], n, D, block_ell=True)
    assert not sg.symmetric and sg.bell_senders is None
    mesh = _ring(D)
    sg = sg.to(mesh)
    a = torch.zeros(n, n)
    a[torch.tensor(e[:, 1]), torch.tensor(e[:, 0])] = 1.0        # y[r] += x[s]
    rng = np.random.default_rng(6)
    x = torch.tensor(rng.normal(size=(n, F)).astype(np.float32), requires_grad=True)
    dy = torch.tensor(rng.normal(size=(n, F)).astype(np.float32))
    norm = torch.rsqrt(torch.clamp(a.sum(1), min=1.0))[:, None]
    ref = (a @ (x * norm)) * norm
    (ref_grad,) = torch.autograd.grad(torch.sum(ref * dy), x)

    order = torch.tensor(np.argsort(g2l))                        # sharded row -> node
    xs = [t.detach().requires_grad_(True) for t in x.detach()[order].split(sg.n_shard)]
    ys = tspmm.sharded_gcn_conv(torch.eye(F), torch.zeros(F), sg, xs, mesh)
    np.testing.assert_allclose(torch.cat(ys).detach().numpy(), ref[order].detach().numpy(),
                               rtol=RTOL, atol=ATOL)
    dys = dy[order].split(sg.n_shard)
    grads = torch.autograd.grad(sum(torch.sum(y * g) for y, g in zip(ys, dys)), xs)
    np.testing.assert_allclose(torch.cat(grads).numpy(), ref_grad[order].numpy(),
                               rtol=RTOL, atol=ATOL)
    wrong = ((a.T @ (x * norm)) * norm)                          # A·dy's pattern differs
    assert not torch.allclose(ref, wrong)


@pytest.mark.parametrize("D,in_f,out_f", [(2, 16, 8), (4, 8, 16)], ids=["project", "aggregate"])
def test_sharded_gcn_conv_matches_jax(D, in_f, out_f):
    n = 200
    s, r = _coo(random_regular_edges(n, 6, seed=7))
    jsg, tsg, _ = _graphs(n, D, s, r)
    rng = np.random.default_rng(8)
    x = rng.normal(size=(D, tsg.n_shard, in_f)).astype(np.float32)
    w = rng.normal(size=(in_f, out_f)).astype(np.float32)
    b = rng.normal(size=out_f).astype(np.float32)
    dy = rng.normal(size=(D, tsg.n_shard, out_f)).astype(np.float32)
    conv = _jax_map(lambda sg_, x_, w_, b_: jspmm.sharded_gcn_conv(w_, b_, sg_, x_, "graph")[None],
                    jsg, D, 1)
    args = (jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    ref = np.asarray(conv(*args))
    ref_grads = jax.grad(lambda *a: jnp.sum(conv(*a) * dy), argnums=(0, 1, 2))(*args)

    xs = _blocks(x, requires_grad=True)
    wt = torch.tensor(w, requires_grad=True)
    bt = torch.tensor(b, requires_grad=True)
    ys = tspmm.sharded_gcn_conv(wt, bt, tsg, xs, _ring(D))
    np.testing.assert_allclose(_stack(ys), ref, rtol=RTOL, atol=ATOL)
    loss = sum(torch.sum(y * torch.tensor(g)) for y, g in zip(ys, dy))
    grads = torch.autograd.grad(loss, [*xs, wt, bt])
    np.testing.assert_allclose(_stack(grads[:D]), np.asarray(ref_grads[0]), rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(grads[D].numpy(), np.asarray(ref_grads[1]), rtol=RTOL, atol=1e-4)
    np.testing.assert_allclose(grads[D + 1].numpy(), np.asarray(ref_grads[2]), rtol=RTOL,
                               atol=1e-4)


@pytest.mark.parametrize("D", [1, 4])
def test_sharded_cuts_match_jax(D):
    n, k = 128, 3
    s, r = _coo(random_regular_edges(n, 4, seed=9))
    jsg, tsg, g2l = _graphs(n, D, s, r)
    probs = np.random.default_rng(10).dirichlet([1.0] * k, size=n).astype(np.float32)
    sh = np.zeros((D * tsg.n_shard, k), np.float32)
    sh[g2l] = probs
    sh = sh.reshape(D, tsg.n_shard, k)
    mesh = _ring(D)
    for jfn, tfn in ((lambda sg_, s_: jgiant.sharded_cut(sg_, s_, "graph"),
                      lambda ss: tgiant.sharded_cut(tsg, ss, mesh)),
                     (lambda sg_, s_: jspmm.sharded_cut_edgeform(sg_, s_, "graph"),
                      lambda ss: tspmm.sharded_cut_edgeform(tsg, ss, mesh))):
        cut = _jax_map(jfn, jsg, D, 1, out_specs=P())
        ref = float(cut(jnp.asarray(sh)))
        ref_grad = np.asarray(jax.grad(cut)(jnp.asarray(sh)))
        ss = _blocks(sh, requires_grad=True)
        got = tfn(ss)
        np.testing.assert_allclose(got.item(), ref, rtol=RTOL)
        np.testing.assert_allclose(_stack(torch.autograd.grad(got, ss)), ref_grad,
                                   rtol=RTOL, atol=ATOL)


# ---- the giant trainer -------------------------------------------------------

def _jax_init(cfg, D, n_shard):
    """The JAX trainer's initial draw (``giant.train_giant_graph``) as numpy."""
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(cfg.seed), 3)
    return {
        "conv1": {k: np.asarray(v) for k, v in
                  gcn_conv_init(k1, cfg.dim_embedding, cfg.hidden_dim).items()},
        "conv2": {k: np.asarray(v) for k, v in
                  gcn_conv_init(k2, cfg.hidden_dim, cfg.num_classes).items()},
        "embed": np.asarray(jax.random.normal(k3, (D, n_shard, cfg.dim_embedding), jnp.float32)),
    }


def _capture_grads():
    """An optax transformation that applies no update and keeps the
    gradients as its state: one JAX step's gradients, exactly."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda grads, state, params=None: (jax.tree_util.tree_map(jnp.zeros_like, grads), grads))


def test_one_training_step_matches_jax():
    n, D = 256, 4
    s, r = _coo(random_regular_edges(n, 4, seed=11))
    jcfg = jgiant.GiantConfig(dim_embedding=16, hidden_dim=8, num_classes=3)
    jsg, tsg, _ = _graphs(n, D, s, r)
    p0 = _jax_init(jcfg, D, jsg.n_shard)
    conv = {k: {kk: jnp.asarray(vv) for kk, vv in p0[k].items()} for k in ("conv1", "conv2")}
    embed = jnp.asarray(p0["embed"])
    opt = _capture_grads()
    opt_state = opt.init((conv, embed))
    step = jgiant.make_giant_step(jsg, jmake_mesh(("graph",), devices=jax.devices()[:D]), jcfg,
                                  opt, "graph", opt_state, params=(conv, embed))
    _, _, (jconv_g, jembed_g), losses = step(conv, embed, opt_state)

    mesh = _ring(D)
    tcfg = tgiant.GiantConfig(dim_embedding=16, hidden_dim=8, num_classes=3)
    state = tgiant.GiantState.create(p0, mesh, tcfg.learning_rate)
    onehot = tgiant._forward(state.conv, state.embeds, tsg, mesh, tcfg)
    loss = -tspmm.sharded_cut_edgeform(tsg, onehot, mesh)
    grads = torch.autograd.grad(loss, state.leaves())
    assert float(loss.detach()) == float(losses[0])
    for g, ref in zip(grads[:4], (jconv_g["conv1"]["w"], jconv_g["conv1"]["b"],
                                  jconv_g["conv2"]["w"], jconv_g["conv2"]["b"])):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), rtol=RTOL, atol=1e-4)
    # the JAX embedding gradient is D times the true one (psum in the loss)
    np.testing.assert_allclose(_stack(grads[4:]), np.asarray(jembed_g) / D, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("D,schedule,partition", [(4, "ring", "contiguous"),
                                                  (2, "allgather", "metis")])
def test_training_history_matches_jax(D, schedule, partition):
    n = 512
    s, r = _coo(random_regular_edges(n, 4, seed=12))
    kw = dict(dim_embedding=16, hidden_dim=8, learning_rate=5e-3, number_epochs=20,
              log_every=1, schedule=schedule, partition=partition)
    jcfg = jgiant.GiantConfig(**kw)
    ref = jgiant.train_giant_graph(s, r, n, jcfg, mesh=jmake_mesh(
        ("graph",), devices=jax.devices()[:D]), return_assignment=True)
    owner = jpart.partition_nodes_metis(s, r, n, D) if partition == "metis" else None
    n_shard = jpart.shard_graph(s, r, n, D, owner=owner)[0].n_shard
    got = tgiant.train_giant_graph(s, r, n, tgiant.GiantConfig(**kw), mesh=_ring(D),
                                   params=_jax_init(jcfg, D, n_shard), return_assignment=True)
    # cut values are whole numbers; Adam's eps is all that sees the JAX
    # embedding gradient's factor D
    np.testing.assert_allclose(got["loss_history"], ref["loss_history"], rtol=1e-3)
    assert np.mean(got["assignment"] == ref["assignment"]) >= 0.99
    assert (got["epochs"], got["num_shards"], got["total_edges"]) == (20, D, n * 2)


def test_checkpoints_cross_between_packages(tmp_path):
    # D = 1: the JAX embedding gradient's factor D is 1, so a run resumed
    # from the other package's Adam state continues the same trajectory
    n = 256
    s, r = _coo(random_regular_edges(n, 4, seed=13))
    kw = dict(dim_embedding=16, hidden_dim=8, learning_rate=5e-3, log_every=1)
    jmesh = jmake_mesh(("graph",), devices=jax.devices()[:1])
    full = jgiant.train_giant_graph(s, r, n, jgiant.GiantConfig(number_epochs=8, **kw),
                                    mesh=jmesh)
    p0 = _jax_init(jgiant.GiantConfig(**kw), 1, jpart.shard_graph(s, r, n, 1)[0].n_shard)
    jck, tck = str(tmp_path / "jax_ck"), str(tmp_path / "torch_ck")
    jgiant.train_giant_graph(s, r, n, jgiant.GiantConfig(number_epochs=4, **kw), mesh=jmesh,
                             checkpoint_path=jck)
    tgiant.train_giant_graph(s, r, n, tgiant.GiantConfig(number_epochs=4, **kw), mesh=_ring(1),
                             params=p0, checkpoint_path=tck, checkpoint_every=2)
    port_resumed = tgiant.train_giant_graph(s, r, n, tgiant.GiantConfig(number_epochs=8, **kw),
                                            mesh=_ring(1), resume_from=jck)
    jax_resumed = jgiant.train_giant_graph(s, r, n, jgiant.GiantConfig(number_epochs=8, **kw),
                                           mesh=jmesh, resume_from=tck)
    for res in (port_resumed, jax_resumed):
        assert res["epochs"] == 8
        np.testing.assert_allclose(res["loss_history"], full["loss_history"], rtol=1e-3)
    assert port_resumed["epochs_run"] == 4

    # a resume at the last epoch runs nothing: the checkpoint's last loss
    # and no edges/s (the JAX package fails here)
    ck8 = str(tmp_path / "ck8")
    tgiant.train_giant_graph(s, r, n, tgiant.GiantConfig(number_epochs=8, **kw), mesh=_ring(1),
                             resume_from=tck, checkpoint_path=ck8)
    done = tgiant.train_giant_graph(s, r, n, tgiant.GiantConfig(number_epochs=8, **kw),
                                    mesh=_ring(1), resume_from=ck8)
    assert (done["epochs"], done["epochs_run"]) == (8, 0)
    assert done["final_loss"] == done["loss_history"][-1] == port_resumed["final_loss"]
    assert np.isnan(done["edges_per_s"])


def test_measuring_the_epoch_time_leaves_the_model_as_trained():
    n = 256
    s, r = _coo(random_regular_edges(n, 4, seed=14))
    cfg = tgiant.GiantConfig(dim_embedding=16, hidden_dim=8, number_epochs=6, log_every=1)
    plain = tgiant.train_giant_graph(s, r, n, cfg, mesh=_ring(2), return_assignment=True)
    timed = tgiant.train_giant_graph(s, r, n, cfg, mesh=_ring(2), return_assignment=True,
                                     measure_throughput=True)
    np.testing.assert_array_equal(plain["assignment"], timed["assignment"])
    assert plain["loss_history"] == timed["loss_history"]
    assert timed["timing_reliable"] in (True, False)
    assert {"edges_per_s_amortized", "epoch_time_s_amortized", "timing_spread_s",
            "timing_method"} <= timed.keys()


def test_kway_sweep_keys_and_floors(monkeypatch):
    # the JAX sweep's result keys, from its own code with a stub trainer
    stub = dict(final_cut=1.0, edges_per_s=1.0, num_shards=1)
    jkway = importlib.import_module("gcn_maxcut_tpu.bench.kway_sweep")
    monkeypatch.setattr(jkway, "train_giant_graph", lambda *a, **k: stub)
    jkeys = {tuple(sorted(r)) for r in jkway.kway_sweep(n=256, d=4, ks=(3, 5), epochs=1)}
    res = kway_sweep(n=256, d=4, ks=(3, 5), epochs=40, dim_embedding=16, hidden_dim=8,
                           learning_rate=5e-3, seed=1, device="cpu")
    assert [x["k"] for x in res] == [3, 5]
    for x in res:
        assert set(next(iter(jkeys))) <= x.keys()
        assert x["random_fraction"] == (x["k"] - 1) / x["k"]
        assert x["cut_fraction"] == x["final_cut"] / 512
        assert x["cut_fraction"] > x["random_fraction"]
        assert x["num_shards"] == 1 and not x["block_ell"]


def test_scaling_on_a_cpu_ring():
    res = bench_sharded_conv(512, 4, feature_dim=16, out_dim=8, iters=2, devices=["cpu"] * 4)
    assert res["num_devices"] == 4 and res["virtual_ring"]
    assert res["fwd_edges_per_s"] > 0 and res["fwdbwd_edges_per_s"] > 0
    (one,) = scaling_sweep(512, 4, feature_dim=16, device="cpu")
    assert one["num_devices"] == 1 and not one["virtual_ring"]
    assert one["scaling_efficiency"] == 1.0
