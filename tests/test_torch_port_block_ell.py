"""Port parity: the block-ELL planner, K1's plain version, the locality
graph constructors and ``spmm``'s dispatch.

The planner and the graph constructors must give the JAX package's arrays
exactly.  K1's plain version (the table gather-sum plus the outlier
scatter) is held against the JAX ``block_ell_spmm`` run in Pallas
interpret mode, as the JAX package's own tests run it: forward
rtol = atol = 1e-5 (the interpret-mode
kernel sums the window through two bf16 halves, ~3e-6 relative), gradient
1e-4.  The CUDA kernel itself is held against the plain version by
tests/test_torch_port_cuda.py on the card, and by chip_smoke.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import gcn_maxcut_tpu.core.graph as jgraph
import gcn_maxcut_tpu.ops.pallas_block_ell as jbell
import gcn_maxcut_tpu.ops.segment as jseg
import gcn_maxcut_tpu_torch.core.graph as tgraph
import gcn_maxcut_tpu_torch.ops.block_ell as tbell
import gcn_maxcut_tpu_torch.ops.segment as tseg
from gcn_maxcut_tpu_torch.bench.locality import locality_spec

PLAN_ARRAYS = ("senders", "weights", "mask", "out_senders", "out_receivers",
               "out_weights", "out_mask")


def _banded_edges(n=2048, per_node=3, w=50, long_edges=(), seed=0, weighted=False):
    """The edge lists of tests/test_pallas_block_ell.py's ``_banded_graph``."""
    rng = np.random.default_rng(seed)
    edges = []
    for i in range(n):
        for _ in range(per_node):
            j = int((i + rng.integers(-w, w + 1)) % n)
            if j != i:
                edges.append((i, j))
    edges += list(long_edges)
    wts = rng.random(len(edges)).astype(np.float32) + 0.5 if weighted else None
    return np.asarray(edges), wts


def _directed(edges, wts):
    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    w = np.ones(src.shape[0], np.float32) if wts is None else np.concatenate([wts, wts])
    return src, dst, w


def _assert_plans_equal(pt, pj):
    assert (pt is None) == (pj is None)
    if pj is None:
        return
    assert (pt.block, pt.wp, pt.n_outliers, pt.window) == (pj.block, pj.wp, pj.n_outliers, pj.window)
    for f in PLAN_ARRAYS:
        a, b = getattr(pt, f), getattr(pj, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def _assert_graph_plans_equal(gt, gj):
    assert (gt.bell_block, gt.bell_wp) == (gj.bell_block, gj.bell_wp)
    for f in PLAN_ARRAYS:
        a, b = getattr(gt, f"bell_{f}"), getattr(gj, f"bell_{f}")
        assert (a is None) == (b is None), f
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=f)
    if gj.reorder_perm is None:
        assert gt.reorder_perm is None
    else:
        np.testing.assert_array_equal(gt.reorder_perm.numpy(), np.asarray(gj.reorder_perm))
    np.testing.assert_array_equal(gt.senders.numpy(), np.asarray(gj.senders))
    np.testing.assert_array_equal(gt.receivers.numpy(), np.asarray(gj.receivers))


PLAN_CASES = [
    dict(),
    dict(long_edges=[(0, 1000), (5, 1500), (1024, 30)]),
    dict(long_edges=[(0, 900), (7, 1400)], weighted=True, seed=2),
    dict(seed=4, long_edges=[(3, 1200)]),
    dict(n=1200, w=20, seed=5),                     # B = 240: not a multiple of 128
    dict(n=4096, per_node=5, w=200, seed=6),        # wider window, width spills
]


@pytest.mark.parametrize("case", PLAN_CASES, ids=range(len(PLAN_CASES)))
def test_planner_matches_jax(case):
    n = case.get("n", 2048)
    src, dst, w = _directed(*_banded_edges(**case))
    pj = jbell.plan_block_ell(src, dst, w, n)
    assert pj is not None
    _assert_plans_equal(tbell.plan_block_ell(src, dst, w, n), pj)


def test_planner_forced_geometry_and_expander_match_jax():
    src, dst, w = _directed(*_banded_edges(long_edges=[(0, 1000)]))
    for kw in (dict(force_wp=128), dict(force_wp=64, force_width=2), dict(max_wp=128)):
        _assert_plans_equal(tbell.plan_block_ell(src, dst, w, 2048, **kw),
                            jbell.plan_block_ell(src, dst, w, 2048, **kw))
    rng = np.random.default_rng(1)
    e = np.stack([np.repeat(np.arange(2048), 3), rng.integers(0, 2048, 3 * 2048)], axis=1)
    e = e[e[:, 0] != e[:, 1]]
    src, dst, w = _directed(e, None)
    assert tbell.plan_block_ell(src, dst, w, 2048) is None
    assert jbell.plan_block_ell(src, dst, w, 2048) is None


def _plan_operands(g, mode):
    w = g.bell_mask if mode == "mask" else g.bell_weights
    ow = g.bell_out_mask if mode == "mask" else g.bell_out_weights
    return g.bell_senders, w, g.bell_out_senders, g.bell_out_receivers, ow


@pytest.mark.parametrize("F", [128, 3])
@pytest.mark.parametrize("mode", ["mask", "weights"])
def test_plain_version_matches_jax_interpret(F, mode):
    edges, wts = _banded_edges(long_edges=[(0, 900), (7, 1400)], weighted=True, seed=2)
    gj = jgraph.graph_from_edges(edges, 2048, weights=wts, block_ell=True)
    gt = tgraph.graph_from_edges(edges, 2048, weights=wts, block_ell=True)
    assert gt.bell_block is not None and gt.bell_out_mask.sum() > 0
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2048, F)).astype(np.float32)
    dy = rng.normal(size=(2048, F)).astype(np.float32)
    ops_j = _plan_operands(gj, mode)
    geo = (gj.n_pad, gj.bell_block, gj.bell_wp)
    with pltpu.force_tpu_interpret_mode():
        yj, vjp = jax.vjp(lambda z: jbell.block_ell_spmm(z, *ops_j, *geo), jnp.asarray(x))
        gj_x = np.asarray(vjp(jnp.asarray(dy))[0])
    xt = torch.tensor(x, requires_grad=True)
    yt = tbell.block_ell_spmm(xt, *_plan_operands(gt, mode), *geo)
    yt.backward(torch.tensor(dy))
    np.testing.assert_allclose(yt.detach().numpy(), np.asarray(yj), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), gj_x, rtol=1e-4, atol=1e-4)
    # the plain version itself, called directly, is the same function
    plain = tbell.block_ell_spmm_plain(torch.tensor(x), *_plan_operands(gt, mode), *geo)
    torch.testing.assert_close(plain, yt.detach(), rtol=0, atol=0)


def test_block_ell_spmm_takes_no_plain_path_off_the_cpu():
    g = tgraph.graph_from_edges(_banded_edges()[0], 2048, block_ell=True)
    x = torch.empty(2048, 4, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tbell.block_ell_spmm(x, *_plan_operands(g, "mask"), 2048, g.bell_block, g.bell_wp)
    with pytest.raises(ValueError, match="mode"):
        tbell.block_ell_spmm(torch.zeros(2048, 4), *_plan_operands(g, "mask"), 2048,
                             g.bell_block, g.bell_wp, mode="mxu")


@pytest.mark.parametrize("reorder", ["off", "rcm", "auto"])
def test_reorder_constructors_match_jax(reorder):
    spec = locality_spec(4096, seed=3)
    kw = dict(block_ell=True, reorder=reorder)
    gt = tgraph.graph_from_edges(spec.edges, 4096, **kw)
    gj = jgraph.graph_from_edges(spec.edges, 4096, **kw)
    _assert_graph_plans_equal(gt, gj)
    assert (gt.bell_block is None) == (reorder == "off")   # shuffled ids band only after RCM
    assert (gt.reorder_perm is None) == (reorder == "off")


def test_attach_block_ell_and_graph_from_dense_match_jax():
    edges, _ = _banded_edges(long_edges=[(5, 1500)], seed=7)
    gt = tgraph.graph_from_edges(edges, 2048, block_ell=False)
    gj = jgraph.graph_from_edges(edges, 2048, block_ell=False)
    assert gt.bell_block is None
    _assert_graph_plans_equal(tgraph.attach_block_ell(gt), jgraph.attach_block_ell(gj))
    adj = np.zeros((2048, 2048), np.float32)
    adj[edges[:, 0], edges[:, 1]] = adj[edges[:, 1], edges[:, 0]] = 1.0
    _assert_graph_plans_equal(tgraph.graph_from_dense(adj, block_ell=True),
                              jgraph.graph_from_dense(adj, block_ell=True))


def test_pad_graph_batch_keeps_plans():
    spec = locality_spec(4096, seed=3)
    g_rcm = tgraph.graph_from_edges(spec.edges, 4096, block_ell=True, reorder="rcm")
    g_plain = tgraph.attach_block_ell(tgraph.graph_from_edges(
        g_rcm.reorder_perm.numpy()[spec.edges], 4096, block_ell=False),
        force_wp=g_rcm.bell_wp, force_width=g_rcm.bell_senders.shape[1])
    assert g_plain.bell_block == g_rcm.bell_block and g_plain.reorder_perm is None
    batch = tgraph.pad_graph_batch([g_rcm, g_plain])
    jb = jgraph.pad_graph_batch([
        jgraph.graph_from_edges(spec.edges, 4096, block_ell=True, reorder="rcm"),
        jgraph.attach_block_ell(
            jgraph.graph_from_edges(g_rcm.reorder_perm.numpy()[spec.edges], 4096,
                                    block_ell=False),
            force_wp=g_rcm.bell_wp, force_width=g_rcm.bell_senders.shape[1]),
    ])
    np.testing.assert_array_equal(batch.reorder_perm.numpy(), np.asarray(jb.reorder_perm))
    assert batch.bell_senders.shape[0] == 2 and batch.bell_block == g_rcm.bell_block
    for i, g in enumerate((g_rcm, g_plain)):
        gi = batch.index(i)
        assert (gi.bell_block, gi.bell_wp) == (g.bell_block, g.bell_wp)
        for f in PLAN_ARRAYS:
            torch.testing.assert_close(getattr(gi, f"bell_{f}"), getattr(g, f"bell_{f}"))
    x = torch.randn(4096, 8)
    torch.testing.assert_close(tseg.spmm(batch.index(0), x), tseg.spmm(g_rcm, x))
    other = tgraph.graph_from_edges(spec.edges, 4096, block_ell=True, reorder="rcm")
    other = dataclasses.replace(other, bell_wp=other.bell_wp + 64)
    with pytest.raises(ValueError, match="geometry"):
        tgraph.pad_graph_batch([g_rcm, other])


def test_spmm_dispatch_and_feature_dtype_match_jax():
    edges, _ = _banded_edges(long_edges=[(2, 1100)], seed=6)
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2048, 128)).astype(np.float32)
    for block_ell in (True, False):
        gt = tgraph.graph_from_edges(edges, 2048, block_ell=block_ell)
        gj = jgraph.graph_from_edges(edges, 2048, block_ell=block_ell)
        with pltpu.force_tpu_interpret_mode():
            yj = np.asarray(jseg.spmm(gj, jnp.asarray(x), feature_dtype="bfloat16"))
        yt = tseg.spmm(gt, torch.tensor(x), feature_dtype="bfloat16")
        assert yt.dtype == torch.float32
        np.testing.assert_allclose(yt.numpy(), yj, rtol=1e-5, atol=1e-5)
        if block_ell:
            # the plan wins over the dtype request: the float32 kernel path
            torch.testing.assert_close(yt, tseg.spmm(gt, torch.tensor(x)), rtol=0, atol=0)
            torch.testing.assert_close(
                tseg.spmm(gt, torch.tensor(x).to(torch.bfloat16)),
                tseg.spmm(gt, torch.tensor(x).to(torch.bfloat16).float()), rtol=0, atol=0)
        else:
            xb = torch.tensor(x).to(torch.bfloat16).requires_grad_(True)
            tseg.spmm(gt, xb).sum().backward()
            assert xb.grad.dtype == torch.bfloat16
            gjx = jax.grad(lambda z: jnp.sum(jseg.spmm(gj, z)))(jnp.asarray(x, jnp.bfloat16))
            np.testing.assert_allclose(xb.grad.float().numpy(),
                                       np.asarray(gjx, np.float32), rtol=1e-2, atol=1e-2)


def test_asymmetric_graph_runs_its_transpose_plan():
    """A weighted graph that is not symmetric: the backward runs the kernel
    on the plan of Aᵀ.  Held against autograd through the dense operator."""
    n = 2048
    rng = np.random.default_rng(11)
    adj = np.zeros((n, n), np.float32)
    for i in range(n):
        for j in rng.integers(-40, 41, size=3):
            if j:
                adj[i, (i + j) % n] = rng.random() + 0.5
    adj[3, 1500] = adj[700, 10] = 2.0                  # long edges: outliers
    g = tgraph.graph_from_dense(adj, block_ell=True)
    assert not g.symmetric and g.bell_block is not None and g.bell_t_block is not None
    assert int(g.bell_out_mask.sum()) > 0 and int(g.bell_t_out_mask.sum()) > 0
    assert g.ell_senders is not None
    dense = torch.zeros(n, n).index_put_(
        (g.receivers.long(), g.senders.long()), g.weights * g.edge_mask, accumulate=True)
    assert not torch.equal(dense, dense.T)
    x = torch.tensor(rng.normal(size=(n, 8)).astype(np.float32))
    dy = torch.tensor(rng.normal(size=(n, 8)).astype(np.float32))
    xs = x.clone().requires_grad_(True)
    ys = tseg.spmm(g, xs, edge_weights=g.weights)
    ys.backward(dy)
    xd = x.clone().requires_grad_(True)
    yd = dense @ xd
    yd.backward(dy)
    torch.testing.assert_close(ys.detach(), yd.detach(), rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(xs.grad, xd.grad, rtol=1e-4, atol=1e-4)
    with pytest.raises(ValueError, match="transpose"):
        tseg.spmm(dataclasses.replace(g, bell_t_block=None), x)
