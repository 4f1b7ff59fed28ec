"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py -q

(``--noconftest`` skips the JAX set-up of tests/conftest.py).  Without a
CUDA device every test here skips.

Tolerances: float32 rtol = atol = 1e-5 (the kernel sums in the plain
version's order, so it is usually exact); bfloat16 within one bf16 ulp of
the plain version, which sums in float32 and rounds once.
"""

import numpy as np
import pytest
import torch

from gcn_maxcut_tpu_torch.bench import giant_demo as tgiant
from gcn_maxcut_tpu_torch.core.graph import graph_from_dense, graph_from_edges
from gcn_maxcut_tpu_torch.ops import banded as tb
from gcn_maxcut_tpu_torch.ops import block_ell as tbell
from gcn_maxcut_tpu_torch.ops import halo as th
from gcn_maxcut_tpu_torch.ops import probe_kernels as tpk
from gcn_maxcut_tpu_torch.ops.segment import spmm
from gcn_maxcut_tpu_torch.parallel import giant_banded as tgb
from gcn_maxcut_tpu_torch.parallel.mesh import make_mesh

CASES = [
    (4096, 16, 8, (1, -1, 5, -5)),
    (8192, 4, 32, (2, -2, 7, -7, 63, -63)),
    (4096, 32, 8, (33, -33, 1, -1)),
    (8192, 16, 32, (9, -9, 2, -2)),
    (4096, 16, 8, (3, 11)),
    (296, 3, 8, (1, -1, 7, -7)),          # m = 37 rows: small, odd
    (400, 20, 8, (2, -5, 6)),             # L = 160: F does not divide the tile
    (1024, 16, 8, (63, -63, 1, -1)),      # m = 128 = 2·Wp: every tile wraps
]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def assert_kernel_close(got: torch.Tensor, ref: torch.Tensor) -> None:
    if ref.dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
        return
    ref32 = ref.float()
    _, exp = torch.frexp(ref32)
    ulp = torch.where(ref32 == 0, torch.full_like(ref32, 2.0**-133),
                      torch.ldexp(torch.ones_like(ref32), exp - 8))
    assert bool(((got.float() - ref32).abs() <= ulp).all())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("packed", [False, True], ids=["K2", "K3"])
def test_cuda_kernel_matches_plain(cuda_device, packed, dtype):
    rng = np.random.default_rng(2)
    for n, F, r, offsets in CASES:
        fn = ((lambda z: tb.banded_spmm_unit_packed(z, offsets, r)) if packed
              else (lambda z: tb.banded_spmm_unit(z, offsets)))
        x = torch.tensor(rng.normal(size=(n, F)).astype(np.float32)).to(dtype)
        dy = torch.tensor(rng.normal(size=(n, F)).astype(np.float32)).to(dtype)
        before = dict(tb.LAUNCHES)
        xc = x.to(cuda_device).requires_grad_(True)
        yc = fn(xc)
        yc.backward(dy.to(cuda_device))
        torch.cuda.synchronize()
        name = "banded_spmm_unit_packed" if packed else "banded_spmm_unit"
        assert tb.LAUNCHES[name] == before[name] + 2       # forward + backward
        xp = x.clone().requires_grad_(True)
        yp = fn(xp)
        yp.backward(dy)
        assert_kernel_close(yc.detach().cpu(), yp.detach())
        assert_kernel_close(xc.grad.cpu(), xp.grad)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("n", [4096, 131072])
def test_cuda_unit_kernel_at_bench_width(cuda_device, n, dtype):
    """K2 at the width and offsets of ``bench --what banded`` (F = 128)."""
    offsets = (17, -17, 32, -32, 52, -52, 39, -39)
    rng = np.random.default_rng(3)
    x = torch.tensor(rng.normal(size=(n, 128)).astype(np.float32)).to(dtype)
    dy = torch.tensor(rng.normal(size=(n, 128)).astype(np.float32)).to(dtype)
    before = tb.LAUNCHES["banded_spmm_unit"]
    xc = x.to(cuda_device).requires_grad_(True)
    yc = tb.banded_spmm_unit(xc, offsets)
    yc.backward(dy.to(cuda_device))
    torch.cuda.synchronize()
    assert tb.LAUNCHES["banded_spmm_unit"] == before + 2
    xp = x.clone().requires_grad_(True)
    yp = tb.banded_spmm_unit(xp, offsets)
    yp.backward(dy)
    assert_kernel_close(yc.detach().cpu(), yp.detach())
    assert_kernel_close(xc.grad.cpu(), xp.grad)


@pytest.mark.cuda
def test_cuda_kernel_rejects_what_it_does_not_take(cuda_device):
    x = torch.zeros(64, 4, device=cuda_device)
    with pytest.raises(ValueError, match="exceeds"):
        tb.banded_spmm_unit(x, (40, -40))                  # 2·Wp > m
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tb.banded_spmm_unit(x.half(), (1, -1))


@pytest.mark.cuda
def test_cuda_packed_trainer_matches_cpu(cuda_device):
    kw = dict(n=4096, bandwidth=31, epochs=4, agg_dtype=None, mu_dtype=None,
              return_assignment=True)
    params = tgiant.packed_params(4096, seed=0, device="cpu")
    rc = tgiant.train_banded_giant_packed(params=params, device=cuda_device, **kw)
    rp = tgiant.train_banded_giant_packed(params=params, device="cpu", **kw)
    np.testing.assert_allclose(rc["history"], rp["history"], rtol=1e-3)
    assert np.mean(rc["assignment"] == rp["assignment"]) >= 0.999


def _banded_edges(n, per_node, w, seed, long_edges=()):
    rng = np.random.default_rng(seed)
    i = np.repeat(np.arange(n), per_node)
    j = (i + rng.integers(-w, w + 1, size=i.shape[0])) % n
    keep = i != j
    return np.concatenate([np.stack([i[keep], j[keep]], axis=1),
                           np.asarray(long_edges, dtype=np.int64).reshape(-1, 2)])


# (n, per_node, w, long edges, F): wrap edges at both ends in every case
BLOCK_ELL_CASES = [
    (2048, 3, 50, [(0, 1000), (5, 1500)], 128),
    (2048, 3, 50, [(3, 1200)], 3),
    (1200, 2, 20, [(1, 600)], 16),            # B = 240 is no multiple of 128: R0 = B
    (4096, 5, 200, [], 64),                   # wider window, degree spills
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", BLOCK_ELL_CASES, ids=range(len(BLOCK_ELL_CASES)))
def test_cuda_block_ell_matches_plain(cuda_device, case):
    n, per_node, w, long_edges, F = case
    rng = np.random.default_rng(5)
    edges = _banded_edges(n, per_node, w, 1, long_edges)
    wts = (rng.random(edges.shape[0]) + 0.5).astype(np.float32)
    g = graph_from_edges(edges, n, weights=wts, block_ell=True)
    assert g.bell_block is not None
    x = torch.tensor(rng.normal(size=(g.n_pad, F)).astype(np.float32))
    dy = torch.tensor(rng.normal(size=(g.n_pad, F)).astype(np.float32))
    gc = g.to(cuda_device)
    for ew in (None, "weights"):
        before = tbell.LAUNCHES["block_ell_spmm"]
        xc = x.to(cuda_device).requires_grad_(True)
        yc = spmm(gc, xc, None if ew is None else gc.weights)
        yc.backward(dy.to(cuda_device))
        torch.cuda.synchronize()
        assert tbell.LAUNCHES["block_ell_spmm"] == before + 2     # forward + backward
        xp = x.clone().requires_grad_(True)
        yp = spmm(g, xp, None if ew is None else g.weights)
        yp.backward(dy)
        assert_kernel_close(yc.detach().cpu(), yp.detach())
        assert_kernel_close(xc.grad.cpu(), xp.grad)


@pytest.mark.cuda
def test_cuda_block_ell_asymmetric_runs_transpose_plan(cuda_device):
    n = 2048
    rng = np.random.default_rng(11)
    adj = np.zeros((n, n), np.float32)
    edges = _banded_edges(n, 3, 40, 2, [(3, 1500), (700, 10)])
    adj[edges[:, 0], edges[:, 1]] = rng.random(edges.shape[0]) + 0.5
    g = graph_from_dense(adj, block_ell=True)
    assert not g.symmetric and g.bell_t_block is not None
    x = torch.tensor(rng.normal(size=(n, 8)).astype(np.float32))
    dy = torch.tensor(rng.normal(size=(n, 8)).astype(np.float32))
    gc = g.to(cuda_device)
    xc = x.to(cuda_device).requires_grad_(True)
    yc = spmm(gc, xc, gc.weights)
    yc.backward(dy.to(cuda_device))
    xp = x.clone().requires_grad_(True)
    yp = spmm(g, xp, g.weights)
    yp.backward(dy)
    assert_kernel_close(yc.detach().cpu(), yp.detach())
    assert_kernel_close(xc.grad.cpu(), xp.grad)


@pytest.mark.cuda
def test_cuda_block_ell_rejects_what_it_does_not_take(cuda_device):
    g = graph_from_edges(_banded_edges(2048, 3, 50, 1), 2048, block_ell=True).to(cuda_device)
    ops = (g.bell_senders, g.bell_mask, g.bell_out_senders, g.bell_out_receivers,
           g.bell_out_mask)
    with pytest.raises(ValueError, match="float32"):
        tbell.block_ell_spmm(torch.zeros(2048, 4, device=cuda_device).double(), *ops,
                             2048, g.bell_block, g.bell_wp)
    with pytest.raises(ValueError, match="geometry"):
        tbell.block_ell_spmm(torch.zeros(2048, 4, device=cuda_device), *ops, 2048,
                             g.bell_block + 8, g.bell_wp)


WEIGHTED_CASES = [
    (4096, 16, (1, -1, 5, -5, 63, -63)),
    (2048, 3, (2, -7, 9)),
    (131072, 128, (17, -17, 32, -32, 52, -52, 39, -39)),
    (296, 20, (1, -1, 7, -7)),            # small, odd row count
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,F,offsets", WEIGHTED_CASES)
def test_cuda_weighted_banded_matches_plain(cuda_device, n, F, offsets):
    rng = np.random.default_rng(6)
    x = torch.tensor(rng.normal(size=(n, F)).astype(np.float32))
    w = torch.tensor((rng.random((n, len(offsets))) + 0.5).astype(np.float32))
    dy = torch.tensor(rng.normal(size=(n, F)).astype(np.float32))
    before = tb.LAUNCHES["banded_spmm"]
    xc = x.to(cuda_device).requires_grad_(True)
    wc = w.to(cuda_device).requires_grad_(True)
    yc = tb.banded_spmm(xc, wc, offsets)
    yc.backward(dy.to(cuda_device))
    torch.cuda.synchronize()
    assert tb.LAUNCHES["banded_spmm"] == before + 2
    xp = x.clone().requires_grad_(True)
    wp = w.clone().requires_grad_(True)
    yp = tb.banded_spmm(xp, wp, offsets)
    yp.backward(dy)
    assert_kernel_close(yc.detach().cpu(), yp.detach())
    assert_kernel_close(xc.grad.cpu(), xp.grad)
    torch.testing.assert_close(wc.grad.cpu(), wp.grad, rtol=1e-4, atol=1e-4)


BENCH_OFFSETS = (17, -17, 32, -32, 52, -52, 39, -39)
# K5: (D, n_shard, F, offsets, block) on a ring of D shards on one card
HALO_K5_CASES = [
    (1, 4096, 128, BENCH_OFFSETS, 1024),
    (2, 4096, 16, (1, -1, 5, -5, 63, -63), 1024),
    (4, 2048, 3, BENCH_OFFSETS, 1024),        # the class width
    (4, 64, 20, (1, -1, 7, -7, 60, -60), 64),  # one block per shard, Wp = n_shard
]
# K6: (D, n_loc, F, r, offsets)
HALO_K6_CASES = [
    (1, 4096, 16, 8, (63, -63, 1, -1)),
    (2, 8192, 16, 8, (9, -9, 2, -2, 33, -33)),
    (4, 512, 16, 8, (63, -63, 1, -1)),         # Wp = m_loc = 64
    (4, 384, 8, 3, (2, -2, 9, -9)),            # L = 24
]


def _ring(cuda_device, n_dev):
    return make_mesh(devices=[cuda_device] * n_dev)


def _plain_ring_and_grad(xs, dy, mesh, offsets, r=None):
    """The plain ring op and its gradient, taken in float32 and rounded
    once to the shards' dtype.  The float32 gradient is autograd's; the
    bfloat16 one is the plain version of the adjoint (negated offsets),
    which sums in the kernel's order (autograd sums in another, and after
    cancellation two float32 sums can round to bfloat16 values more than
    one ulp apart)."""
    xp = [t.detach().float().requires_grad_(True) for t in xs]
    dys = list(dy.float().split(xs[0].shape[0]))
    yp = th.halo_ring_plain(xp, offsets, mesh, r=r)
    torch.autograd.backward(yp, dys)
    dtype = xs[0].dtype
    if dtype == torch.float32:
        return torch.cat(yp).detach(), torch.cat([t.grad for t in xp])
    adjoint = th.halo_ring_plain(dys, [-o for o in offsets], mesh, r=r)
    return torch.cat(yp).detach().to(dtype), torch.cat(adjoint).to(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", HALO_K5_CASES, ids=range(len(HALO_K5_CASES)))
def test_cuda_halo_k5_matches_plain(cuda_device, case, dtype):
    n_dev, n_shard, F, offsets, block = case
    mesh = _ring(cuda_device, n_dev)
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.normal(size=(n_dev * n_shard, F)).astype(np.float32))
    w = torch.tensor((rng.random((n_dev * n_shard, len(offsets))) + 0.5).astype(np.float32))
    dy = torch.tensor(rng.normal(size=x.shape).astype(np.float32)).to(dtype)
    xs = list(x.to(cuda_device, dtype).split(n_shard))
    ws = list(w.to(cuda_device).split(n_shard))
    before = th.LAUNCHES["halo_banded_spmm"]
    yw = th.halo_banded_spmm(xs, ws, offsets, mesh, block)
    xk = [t.clone().requires_grad_(True) for t in xs]
    yk = th.halo_banded_spmm_unit(xk, offsets, mesh, block)
    torch.autograd.backward(yk, list(dy.to(cuda_device).split(n_shard)))
    torch.cuda.synchronize()
    assert th.LAUNCHES["halo_banded_spmm"] == before + 3 * n_dev
    yp, gp = _plain_ring_and_grad(xs, dy.to(cuda_device), mesh, offsets)
    assert_kernel_close(torch.cat(yw), torch.cat(th.halo_ring_plain(xs, offsets, mesh, ws=ws)))
    assert_kernel_close(torch.cat(yk).detach(), yp)
    assert_kernel_close(torch.cat([t.grad for t in xk]), gp)
    if dtype == torch.float32 and 2 * tb.padded_bandwidth(offsets) <= x.shape[0]:
        # the same rows through the circulant kernels on the gathered array
        xg, wg = x.to(cuda_device), w.to(cuda_device)
        assert torch.equal(torch.cat(yw), tb.banded_spmm(xg, wg, offsets))
        assert torch.equal(torch.cat(yk).detach(), tb.banded_spmm_unit(xg, offsets))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", HALO_K6_CASES, ids=range(len(HALO_K6_CASES)))
def test_cuda_halo_k6_matches_plain(cuda_device, case, dtype):
    n_dev, n_loc, F, r, offsets = case
    mesh = _ring(cuda_device, n_dev)
    rng = np.random.default_rng(8)
    x = torch.tensor(rng.normal(size=(n_dev * n_loc, F)).astype(np.float32))
    dy = torch.tensor(rng.normal(size=x.shape).astype(np.float32)).to(dtype)
    xs = list(x.to(cuda_device, dtype).split(n_loc))
    before = th.LAUNCHES["halo_banded_spmm_unit_packed"]
    xk = [t.clone().requires_grad_(True) for t in xs]
    yk = th.halo_banded_spmm_unit_packed(xk, offsets, r, mesh)
    torch.autograd.backward(yk, list(dy.to(cuda_device).split(n_loc)))
    torch.cuda.synchronize()
    assert th.LAUNCHES["halo_banded_spmm_unit_packed"] == before + 2 * n_dev
    yp, gp = _plain_ring_and_grad(xs, dy.to(cuda_device), mesh, offsets, r)
    assert_kernel_close(torch.cat(yk).detach(), yp)
    assert_kernel_close(torch.cat([t.grad for t in xk]), gp)
    if dtype == torch.float32 and 2 * tb.padded_bandwidth(offsets) <= x.shape[0] // r:
        assert torch.equal(torch.cat(yk).detach(),
                           tb.banded_spmm_unit_packed(x.to(cuda_device), offsets, r))


@pytest.mark.cuda
def test_cuda_halo_trainer_matches_cpu_ring(cuda_device):
    cfg = tgb.PackedHaloGiantConfig(d=8, bandwidth=31, epochs=4, agg_dtype=None, mu_dtype=None)
    p0 = tgiant.packed_params(4096, seed=0, device="cpu")
    rc = tgb.train_halo_giant_packed(1024, cfg, _ring(cuda_device, 4), params=p0,
                                     return_assignment=True)
    rp = tgb.train_halo_giant_packed(1024, cfg, make_mesh(devices=["cpu"] * 4), params=p0,
                                     return_assignment=True)
    np.testing.assert_allclose(rc["history"], rp["history"], rtol=1e-3)
    assert np.mean(rc["assignment"] == rp["assignment"]) >= 0.999


# ---- the design probes' kernels (ops/probe_kernels.py), forward only

# (n, F, d, B, Wp): the last has a 3072-row window, so F is cut into
# column tiles (8 columns in float32, 16 in bfloat16) with a ragged last one
WINDOW_CASES = [(2048, 16, 8, 256, 64), (600, 20, 5, 200, 24), (2048, 40, 3, 1024, 1024)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", WINDOW_CASES, ids=range(len(WINDOW_CASES)))
def test_cuda_window_gather_matches_plain(cuda_device, case, dtype):
    n, F, d, B, Wp = case
    rng = np.random.default_rng(7)
    xpad = torch.tensor(rng.normal(size=(n + 2 * Wp, F)).astype(np.float32)).to(dtype)
    # a few slots outside the window, which both versions skip
    lidx = torch.tensor(rng.integers(-3, B + 2 * Wp + 3, size=(n, d)).astype(np.int32))
    w = torch.tensor((rng.random((n, d)) + 0.5).astype(np.float32))
    before = tpk.LAUNCHES["window_gather"]
    y = tpk.window_gather(xpad.to(cuda_device), lidx.to(cuda_device), w.to(cuda_device), B, Wp)
    torch.cuda.synchronize()
    assert tpk.LAUNCHES["window_gather"] == before + 1
    assert y.dtype == torch.float32
    assert_kernel_close(y.cpu(), tpk.window_gather_plain(xpad.float(), lidx, w, B, Wp))


@pytest.mark.cuda
@pytest.mark.parametrize("n,F,B,wp", [(2048, 16, 256, 64), (1200, 3, 240, 40)])
def test_cuda_subblock_spmm_matches_plain(cuda_device, n, F, B, wp):
    rng = np.random.default_rng(8)
    i = np.arange(n)[:, None]
    # senders up to 40 rows beyond the slice, across the wrap at both ends
    sidx = torch.tensor(((i + rng.integers(-wp - 40, wp + 41, size=(n, 6))) % n).astype(np.int32))
    w = torch.tensor((rng.random((n, 6)) + 0.5).astype(np.float32))
    x = torch.tensor(rng.normal(size=(n, F)).astype(np.float32))
    before = tpk.LAUNCHES["subblock_spmm"]
    y = tpk.subblock_spmm(x.to(cuda_device), sidx.to(cuda_device), w.to(cuda_device), n, B, wp)
    torch.cuda.synchronize()
    assert tpk.LAUNCHES["subblock_spmm"] == before + 1
    assert_kernel_close(y.cpu(), tpk.subblock_spmm_plain(x, sidx, w, n, B, wp))


@pytest.mark.cuda
@pytest.mark.parametrize("n,F,B,wp,w_p", [(2048, 16, 256, 64, 2), (1536, 130, 384, 64, 3)])
def test_cuda_panel_ell_spmm_matches_plain(cuda_device, n, F, B, wp, w_p):
    from gcn_maxcut_tpu_torch.experiments.panel_ell_probe import build_panel_tables

    rng = np.random.default_rng(9)
    edges = _banded_edges(n, 4, wp, 3, [(0, n // 2)])
    s, r = edges[:, 0], edges[:, 1]
    wts = (rng.random(s.shape[0]) + 0.5).astype(np.float32)
    idx, wgt, _, _ = build_panel_tables(s, r, wts, n, B, wp, w_p)
    assert (idx < 0).any() and (idx >= 0).any()
    x = torch.tensor(rng.normal(size=(n, F)).astype(np.float32))
    ii, wg = torch.tensor(idx), torch.tensor(wgt)
    before = tpk.LAUNCHES["panel_ell_spmm"]
    y = tpk.panel_ell_spmm(x.to(cuda_device), ii.to(cuda_device), wg.to(cuda_device),
                           n, B, wp, w_p)
    torch.cuda.synchronize()
    assert tpk.LAUNCHES["panel_ell_spmm"] == before + 1
    assert_kernel_close(y.cpu(), tpk.panel_ell_spmm_plain(x, ii, wg, n, B, wp, w_p))


@pytest.mark.cuda
@pytest.mark.parametrize("n,F,offsets", WEIGHTED_CASES)
def test_cuda_banded_spmm_cols_matches_plain(cuda_device, n, F, offsets):
    rng = np.random.default_rng(10)
    x = torch.tensor(rng.normal(size=(n, F)).astype(np.float32))
    wc = torch.tensor((rng.random((len(offsets), n)) + 0.5).astype(np.float32))
    before = tpk.LAUNCHES["banded_spmm_cols"]
    y = tpk.banded_spmm_cols(x.to(cuda_device), wc.to(cuda_device), offsets)
    torch.cuda.synchronize()
    assert tpk.LAUNCHES["banded_spmm_cols"] == before + 1
    assert_kernel_close(y.cpu(), tpk.banded_spmm_cols_plain(x, wc, offsets))
    # bit for bit K4 on the row-major weights
    assert torch.equal(y, tb.banded_spmm(x.to(cuda_device), wc.t().contiguous().to(cuda_device),
                                         offsets))


@pytest.mark.cuda
def test_cuda_probe_kernels_reject_what_they_do_not_take(cuda_device):
    n, F, d, B, Wp = 512, 8, 4, 128, 16
    xpad = torch.zeros(n + 2 * Wp, F, device=cuda_device)
    lidx = torch.zeros(n, d, dtype=torch.int32, device=cuda_device)
    w = torch.ones(n, d, device=cuda_device)
    with pytest.raises(ValueError, match="lie on"):
        tpk.window_gather(xpad, lidx.cpu(), w, B, Wp)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tpk.window_gather(xpad.double(), lidx, w, B, Wp)
    with pytest.raises(ValueError, match="int32"):
        tpk.window_gather(xpad, lidx.long(), w, B, Wp)
    with pytest.raises(ValueError, match="contiguous"):
        tpk.window_gather(xpad.t().contiguous().t(), lidx, w, B, Wp)
    x = torch.zeros(n, F, device=cuda_device)
    with pytest.raises(ValueError, match="lie on"):
        tpk.subblock_spmm(x, lidx.cpu(), w, n, B, Wp)
    with pytest.raises(ValueError, match="float32"):
        tpk.subblock_spmm(x.half(), lidx, w, n, B, Wp)
    idx = torch.full((n, 2 * 2), -1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="lie on"):
        tpk.panel_ell_spmm(x, idx, torch.zeros(n, 4).cpu(), n, B, 64, 2)
    with pytest.raises(ValueError, match="float32"):
        tpk.panel_ell_spmm(x.double(), idx, torch.zeros(n, 4, device=cuda_device), n, B, 64, 2)
    with pytest.raises(ValueError, match="lie on"):
        tpk.banded_spmm_cols(x, torch.ones(2, n), (1, -1))
    with pytest.raises(ValueError, match="float32"):
        tpk.banded_spmm_cols(x, torch.ones(2, n, device=cuda_device).double(), (1, -1))
