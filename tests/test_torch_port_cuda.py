"""The port's CUDA kernels against their plain PyTorch versions, on the card.

This file imports no JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_cuda.py -q

(``--noconftest`` skips the JAX set-up of tests/conftest.py).  Without a
CUDA device every test here skips.

Tolerances: float32 rtol = atol = 1e-5 (the kernel sums in the plain
version's order, so it is usually exact); bfloat16 within one bf16 ulp of
the plain version, which sums in float32 and rounds once.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

from gcn_maxcut_tpu_torch.baselines.local_search import greedy_flip_local_search
from gcn_maxcut_tpu_torch.bench import giant_demo as tgiant
from gcn_maxcut_tpu_torch.bench.microbench import banded_random_edges
from gcn_maxcut_tpu_torch.core.graph import graph_from_dense, graph_from_edges, pad_graph_batch
from gcn_maxcut_tpu_torch.data.generate import generate_graph_dataset, random_regular_edges
from gcn_maxcut_tpu_torch.data.process import DataConfig, process_graphs
from gcn_maxcut_tpu_torch.eval.decode import refine_multi_start_from_uniforms
from gcn_maxcut_tpu_torch.models.gcn import embedding_init, gcn_dev_init
from gcn_maxcut_tpu_torch.objectives.cut_loss import hard_cut_value
from gcn_maxcut_tpu_torch.ops import banded as tb
from gcn_maxcut_tpu_torch.ops import block_ell as tbell
from gcn_maxcut_tpu_torch.ops import climb as tclimb
from gcn_maxcut_tpu_torch.ops import halo as th
from gcn_maxcut_tpu_torch.ops import launches as tlaunches
from gcn_maxcut_tpu_torch.ops import probe_kernels as tpk
from gcn_maxcut_tpu_torch.ops import segment as tseg
from gcn_maxcut_tpu_torch.ops.launches import LAUNCHES
from gcn_maxcut_tpu_torch.ops.segment import spmm
from gcn_maxcut_tpu_torch.parallel import data_parallel as tdp
from gcn_maxcut_tpu_torch.parallel import giant as tpgiant
from gcn_maxcut_tpu_torch.parallel import giant_banded as tgb
from gcn_maxcut_tpu_torch.parallel import hybrid as thybrid
from gcn_maxcut_tpu_torch.parallel import partition as tpart
from gcn_maxcut_tpu_torch.parallel import spmm as tspmm
from gcn_maxcut_tpu_torch.parallel.mesh import make_mesh
from gcn_maxcut_tpu_torch.train import chunks as tchunks
from gcn_maxcut_tpu_torch.train import loop as tloop
from gcn_maxcut_tpu_torch.train import qubo_loop as tqubo
from gcn_maxcut_tpu_torch.train.config import TrainingConfig
from gcn_maxcut_tpu_torch.utils.timing import Timer

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


def launches(op, counts=None):
    """Launches of a circulant op on either kernel: ``halo_stream.cu``
    (under the op's name) or its earlier body (the op's name + "_window")."""
    counts = LAUNCHES if counts is None else counts
    return counts[op] + counts[op + "_window"]


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
        before = dict(LAUNCHES)
        xc = x.to(cuda_device).requires_grad_(True)
        yc = fn(xc)
        yc.backward(dy.to(cuda_device))
        torch.cuda.synchronize()
        name = "banded_spmm_unit_packed" if packed else "banded_spmm_unit"
        # forward + backward, counted by the kernel that ran
        assert launches(name) == launches(name, before) + 2
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
    before = launches("banded_spmm_unit")
    xc = x.to(cuda_device).requires_grad_(True)
    yc = tb.banded_spmm_unit(xc, offsets)
    yc.backward(dy.to(cuda_device))
    torch.cuda.synchronize()
    assert launches("banded_spmm_unit") == before + 2
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
    with pytest.raises(ValueError, match="exceeds"):
        tb.banded_spmm_unit(x[:, :3].contiguous(), (40, -40))   # on the earlier body
    with pytest.raises(ValueError, match="exceeds"):
        tb.banded_spmm_unit_packed(torch.zeros(512, 16, device=cuda_device), (40, -40), 8)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tb.banded_spmm_unit(x.half(), (1, -1))


def _circulant(x, offsets, r):
    return tb.banded_spmm_unit(x, offsets) if r == 1 else tb.banded_spmm_unit_packed(x, offsets, r)


def _circulant_plain(x, offsets, r):
    if r == 1:
        return tb.banded_spmm_unit_plain(x, offsets)
    return tb.banded_spmm_unit_packed_plain(x, offsets, r)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("packed", [False, True], ids=["K2", "K3"])
@pytest.mark.parametrize("case", CASES, ids=range(len(CASES)))
def test_cuda_circulant_stream_equals_plain_and_earlier_body(cuda_device, case, packed, dtype):
    """K2 and K3 on ``halo_stream.cu`` (a one-shard ring on the wrap tiles)
    wherever the rows are whole 16-byte pieces, else on the earlier body:
    forward and gradient bit for bit to the plain version and to the
    earlier body called directly; each launch counted under its kernel's
    key."""
    n, F, r, offsets = case
    r = r if packed else 1
    op = "banded_spmm_unit_packed" if packed else "banded_spmm_unit"
    rng = np.random.default_rng(17)
    x = torch.tensor(rng.normal(size=(n, F)).astype(np.float32)).to(cuda_device, dtype)
    dy = torch.tensor(rng.normal(size=(n, F)).astype(np.float32)).to(cuda_device, dtype)
    m, L = n // r, r * F
    stream = L * x.element_size() % 16 == 0
    key = op if stream else op + "_window"
    before = dict(LAUNCHES)
    xk = x.clone().requires_grad_(True)
    yk = _circulant(xk, offsets, r)
    yk.backward(dy)
    torch.cuda.synchronize()
    assert {k: LAUNCHES[k] - before[k] for k in LAUNCHES} == {
        k: 2 if k == key else 0 for k in LAUNCHES}
    y, g = yk.detach(), xk.grad
    neg = tuple(-o for o in offsets)
    # the plain versions sum in float32 in offset order and round once, as
    # both kernels do: equal bit for bit in both dtypes
    assert torch.equal(y, _circulant_plain(x, offsets, r))
    assert torch.equal(g, _circulant_plain(dy, neg, r))
    assert torch.equal(y, tb._launch(x.view(m, L), offsets, F, op=op).view(n, F))
    assert torch.equal(g, tb._launch(dy.view(m, L), neg, F, op=op).view(n, F))
    if stream:
        assert torch.equal(y, tb._circulant_launch(x.view(m, L), offsets, F, op=op).view(n, F))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cuda_circulant_misaligned_or_narrow_rows_take_the_earlier_body(cuda_device, dtype):
    offsets = (1, -1, 7, -7)
    rng = np.random.default_rng(18)
    # (n, F, r, misaligned): an x one element off 16-byte alignment (its
    # gradient is fresh, so aligned), rows of 3 values (12 or 6 bytes; K3
    # at r = 2: 24 or 12 bytes), and K3 at r = 8, F = 3 (96 or 48 bytes)
    for n, F, r, misaligned in ((4096, 16, 1, True), (4096, 16, 8, True), (4096, 3, 1, False),
                                (4096, 3, 2, False), (4096, 3, 8, False)):
        op = "banded_spmm_unit" if r == 1 else "banded_spmm_unit_packed"
        x = torch.tensor(rng.normal(size=(n, F)).astype(np.float32)).to(cuda_device, dtype)
        if misaligned:
            x = torch.empty(n * F + 1, dtype=dtype, device=cuda_device)[1:].view(n, F).copy_(x)
            assert x.data_ptr() % 16
        dy = torch.tensor(rng.normal(size=(n, F)).astype(np.float32)).to(cuda_device, dtype)
        row_bytes = r * F * x.element_size()
        fwd_stream = row_bytes % 16 == 0 and not misaligned
        bwd_stream = row_bytes % 16 == 0
        before = dict(LAUNCHES)
        xk = x.detach().requires_grad_(True)             # x's own address
        yk = _circulant(xk, offsets, r)
        yk.backward(dy)
        torch.cuda.synchronize()
        want = {op: int(fwd_stream) + int(bwd_stream),
                op + "_window": 2 - int(fwd_stream) - int(bwd_stream)}
        assert {k: LAUNCHES[k] - before[k] for k in want} == want
        assert sum(LAUNCHES[k] - before[k] for k in LAUNCHES) == 2
        assert torch.equal(yk.detach(), _circulant_plain(x, offsets, r))
        assert torch.equal(xk.grad, _circulant_plain(dy, [-o for o in offsets], r))
        if (r, F) == (8, 3):
            assert fwd_stream                            # the pre-rotated tiles: 16-byte rows


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
        before = LAUNCHES["block_ell_spmm"]
        xc = x.to(cuda_device).requires_grad_(True)
        yc = spmm(gc, xc, None if ew is None else gc.weights)
        yc.backward(dy.to(cuda_device))
        torch.cuda.synchronize()
        assert LAUNCHES["block_ell_spmm"] == before + 2     # forward + backward
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
    before = launches("banded_spmm")
    xc = x.to(cuda_device).requires_grad_(True)
    wc = w.to(cuda_device).requires_grad_(True)
    yc = tb.banded_spmm(xc, wc, offsets)
    yc.backward(dy.to(cuda_device))
    torch.cuda.synchronize()
    assert launches("banded_spmm") == before + 2
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
    def launches():     # counted by the kernel that ran: the new one, or the earlier body (F = 3)
        return LAUNCHES["halo_banded_spmm"] + LAUNCHES["halo_banded_spmm_window"]

    before = launches()
    yw = th.halo_banded_spmm(xs, ws, offsets, mesh, block)
    xk = [t.clone().requires_grad_(True) for t in xs]
    yk = th.halo_banded_spmm_unit(xk, offsets, mesh, block)
    torch.autograd.backward(yk, list(dy.to(cuda_device).split(n_shard)))
    torch.cuda.synchronize()
    assert launches() == before + 3 * n_dev
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
    before = LAUNCHES["halo_banded_spmm_unit_packed"]
    xk = [t.clone().requires_grad_(True) for t in xs]
    yk = th.halo_banded_spmm_unit_packed(xk, offsets, r, mesh)
    torch.autograd.backward(yk, list(dy.to(cuda_device).split(n_loc)))
    torch.cuda.synchronize()
    assert LAUNCHES["halo_banded_spmm_unit_packed"] == before + 2 * n_dev
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

# (n, F, d, B, Wp): the last has a 3072-row window; F = 20 takes the warp
# gather's VEC = 4 path with a partial warp, F = 40 two float4 chunks of
# the row
WINDOW_CASES = [(2048, 16, 8, 256, 64), (600, 20, 5, 200, 24), (2048, 40, 3, 1024, 1024)]


def _window_operands(n, F, d, B, Wp, dtype, seed=7):
    rng = np.random.default_rng(seed)
    xpad = torch.tensor(rng.normal(size=(n + 2 * Wp, F)).astype(np.float32)).to(dtype)
    # a few slots outside the window, which every version skips
    lidx = torch.tensor(rng.integers(-3, B + 2 * Wp + 3, size=(n, d)).astype(np.int32))
    w = torch.tensor((rng.random((n, d)) + 0.5).astype(np.float32))
    return xpad, lidx, w


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", WINDOW_CASES, ids=range(len(WINDOW_CASES)))
def test_cuda_window_gather_matches_plain(cuda_device, case, dtype):
    n, F, d, B, Wp = case
    xpad, lidx, w = _window_operands(n, F, d, B, Wp, dtype)
    xc, lc, wc = xpad.to(cuda_device), lidx.to(cuda_device), w.to(cuda_device)
    before = dict(LAUNCHES)
    y = tpk.window_gather(xc, lc, wc, B, Wp)
    torch.cuda.synchronize()
    assert LAUNCHES == {**before, "window_gather": before["window_gather"] + 1}
    assert y.dtype == torch.float32
    # bit for bit: the plain version's slot order and roundings
    assert torch.equal(y.cpu(), tpk.window_gather_plain(xpad, lidx, w, B, Wp))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("F", [16, 3, 130])
def test_cuda_window_gather_vec1_equals_plain(cuda_device, F, dtype):
    # a misaligned xpad (F = 16) and rows that are not 4 columns (F = 3,
    # 130: five 32-column chunks) take the VEC = 1 gather
    n, d, B, Wp = 1024, 16, 256, 64
    xpad, lidx, w = _window_operands(n, F, d, B, Wp, dtype, seed=F)
    xc = _misaligned(xpad) if F == 16 else xpad.to(cuda_device)
    lc, wc = lidx.to(cuda_device), w.to(cuda_device)
    assert tpk.warp_gather_shape(n, F, vec4=tpk._aligned4(xc))[0] == 1
    y = tpk.window_gather(xc, lc, wc, B, Wp)
    assert torch.equal(y.cpu(), tpk.window_gather_plain(xpad, lidx, w, B, Wp))


def _misaligned(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of x on the card that starts one element past a
    16-byte boundary: the kernels take their VEC = 1 path."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device="cuda")
    y = flat[1:].view(x.shape)
    y.copy_(x)
    assert y.data_ptr() % 16
    return y


# (n, F, B, Wp, misaligned): P3's ring at F = 16 (16-byte copies), R0 = B =
# 240 at F = 3 and F = 130 (the VEC = 1 path), Wp = 512 at F = 128 (a
# 1280-row ring), and a misaligned x at F = 16 (VEC = 1)
SUBBLOCK_CASES = [(2048, 16, 256, 64, False), (1200, 3, 240, 40, False),
                  (4096, 128, 512, 512, False), (2048, 130, 256, 128, False),
                  (2048, 16, 256, 64, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,F,B,wp,misaligned", SUBBLOCK_CASES)
def test_cuda_subblock_spmm_matches_plain(cuda_device, n, F, B, wp, misaligned):
    rng = np.random.default_rng(8)
    i = np.arange(n)[:, None]
    # senders up to 40 rows beyond the slice, across the wrap at both ends
    sidx = torch.tensor(((i + rng.integers(-wp - 40, wp + 41, size=(n, 6))) % n).astype(np.int32))
    w = torch.tensor((rng.random((n, 6)) + 0.5).astype(np.float32))
    x = torch.tensor(rng.normal(size=(n, F)).astype(np.float32))
    xc = _misaligned(x) if misaligned else x.to(cuda_device)
    sc, wc = sidx.to(cuda_device), w.to(cuda_device)
    before = dict(LAUNCHES)
    y = tpk.subblock_spmm(xc, sc, wc, n, B, wp)
    torch.cuda.synchronize()
    assert LAUNCHES == {**before, "subblock_spmm": before["subblock_spmm"] + 1}
    # bit for bit: the plain version's slot order and roundings
    assert torch.equal(y.cpu(), tpk.subblock_spmm_plain(x, sidx, w, n, B, wp))


@pytest.mark.cuda
@pytest.mark.parametrize("n,wp", [(100_352, 256), (100_352, 512), (1_048_576, 256)])
def test_cuda_subblock_stream_blocks_per_sm_match_the_geometry(cuda_device, n, wp):
    # the strip fills one wave only if the card holds as many blocks an SM
    # as the geometry counts (chip_smoke.py's P3 shapes)
    g = tpk.subblock_stream_shape(n, 128, 128, wp, 8, 4)
    blocks = ctypes.c_int(0)
    query = tpk._fn("subblock_stream_blocks_per_sm", (ctypes.c_int,) * 3 + (ctypes.c_void_p,),
                    "subblock_stream")
    assert query(g.vec, g.threads, g.smem_bytes, ctypes.addressof(blocks)) == 0
    assert blocks.value == g.blocks_per_sm
    assert torch.cuda.get_device_properties(0).multi_processor_count == tpk.SM_COUNT


# (n, F, B, Wp, W_P, misaligned): 6, 9 and 48 slots (a 1536-row window of
# 12 panels, two 32-slot passes), F = 130 (the VEC = 1 path in 5 column
# chunks), Wp = 512, and a misaligned x at F = 128 (VEC = 1)
PANEL_CASES = [(2048, 16, 256, 64, 2, False), (1536, 130, 384, 64, 3, False),
               (4096, 128, 512, 512, 4, False), (4096, 128, 512, 512, 4, True)]


@pytest.mark.cuda
@pytest.mark.parametrize("n,F,B,wp,w_p,misaligned", PANEL_CASES)
def test_cuda_panel_ell_spmm_matches_plain(cuda_device, n, F, B, wp, w_p, misaligned):
    from gcn_maxcut_tpu_torch.experiments.panel_ell_probe import build_panel_tables

    rng = np.random.default_rng(9)
    edges = _banded_edges(n, 8 if wp == 512 else 4, wp, 3, [(0, n // 2)])
    s, r = edges[:, 0], edges[:, 1]
    wts = (rng.random(s.shape[0]) + 0.5).astype(np.float32)
    idx, wgt, _, _ = build_panel_tables(s, r, wts, n, B, wp, w_p)
    assert (idx < 0).any() and (idx >= 0).any()
    assert idx.shape[1] == (B + 2 * wp) // tpk.PANEL * w_p
    x = torch.tensor(rng.normal(size=(n, F)).astype(np.float32))
    ii, wg = torch.tensor(idx), torch.tensor(wgt)
    xc = _misaligned(x) if misaligned else x.to(cuda_device)
    ic, gc = ii.to(cuda_device), wg.to(cuda_device)
    before = dict(LAUNCHES)
    y = tpk.panel_ell_spmm(xc, ic, gc, n, B, wp, w_p)
    torch.cuda.synchronize()
    assert LAUNCHES == {**before, "panel_ell_spmm": before["panel_ell_spmm"] + 1}
    # bit for bit: the plain version's slot order and roundings
    assert torch.equal(y.cpu(), tpk.panel_ell_spmm_plain(x, ii, wg, n, B, wp, w_p))


# WEIGHTED_CASES, then n % 4 != 0 (4-byte weight copies) with a ragged
# last strip, F = 130 (the earlier body) and a misaligned x (the earlier body)
COLS_CASES = [(n, F, offsets, False) for n, F, offsets in WEIGHTED_CASES] + [
    (5001, 16, (1, -1, 5, -5, 63, -63), False),
    (1030, 8, (7, -7, 64, -64, 2), False),
    (4096, 130, (17, -17, 32, -32), False),
    (4096, 16, (3, -9), True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,F,offsets,misaligned", COLS_CASES)
def test_cuda_banded_spmm_cols_matches_plain(cuda_device, n, F, offsets, misaligned):
    rng = np.random.default_rng(10)
    x = torch.tensor(rng.normal(size=(n, F)).astype(np.float32))
    wc = torch.tensor((rng.random((len(offsets), n)) + 0.5).astype(np.float32))
    xc = _misaligned(x) if misaligned else x.to(cuda_device)
    wcc = wc.to(cuda_device)
    ring = F % 4 == 0 and not misaligned
    before = dict(LAUNCHES)
    y = tpk.banded_spmm_cols(xc, wcc, offsets)
    earlier = tpk._banded_cols_window_launch(xc, wcc, offsets)
    torch.cuda.synchronize()
    # K4's ring in its column-weight mode where the rows are 16-byte pieces
    # on an aligned x, else the earlier body; each counted by the kernel that ran
    key = "banded_spmm_cols" if ring else "banded_spmm_cols_window"
    assert LAUNCHES == {**before, key: before[key] + 1,
                        "banded_spmm_cols_window": before["banded_spmm_cols_window"]
                        + (1 if ring else 2)}
    # bit for bit: the plain version, K4 on the row-major weights, the earlier body
    assert torch.equal(y.cpu(), tpk.banded_spmm_cols_plain(x, wc, offsets))
    assert torch.equal(y, tb.banded_spmm(xc, wcc.t().contiguous(), offsets))
    assert torch.equal(y, earlier)


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
    with pytest.raises(ValueError, match="slots"):
        tpk.panel_ell_spmm(x, idx, torch.zeros(n, 4, device=cuda_device), n, B, 64, 3)
    # the C launchers refuse what their kernels do not take, and launch nothing
    before = dict(LAUNCHES)
    ring = tpk._fn("subblock_stream_launch", (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 11
                   + (ctypes.c_void_p,), "subblock_stream")
    gather = tpk._fn("panel_ell_gather_launch", (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 7
                     + (ctypes.c_void_p,))
    g = tpk.subblock_stream_shape(n, F, 128, Wp, d, 4)
    y = torch.empty_like(x)
    ptrs = (x.data_ptr(), lidx.data_ptr(), w.data_ptr(), y.data_ptr())
    stream = torch.cuda.current_stream().cuda_stream
    geom = (g.r0, g.vec, g.strip, g.cols, g.ring_rows, g.threads)
    assert ring(*ptrs, n, F, d, Wp, *geom, g.smem_bytes, stream) == 0
    assert ring(*ptrs, n, F, d, Wp, *geom, g.smem_bytes + 16, stream) != 0    # smem sum
    assert ring(*ptrs, n, F, d, Wp, 120, *geom[1:], g.smem_bytes, stream) != 0   # r0 ∤ n
    assert ring(*ptrs, n, 6, d, Wp, *geom, g.smem_bytes, stream) != 0          # F % 4 at vec 4
    assert ring(*ptrs, n, F, d, Wp, *geom[:4], g.ring_rows - 1, g.threads, g.smem_bytes,
                stream) != 0                                                    # ring too short
    assert ring(*ptrs, n, F, d, Wp, g.r0, 2, *geom[2:], g.smem_bytes, stream) != 0   # vec 2
    assert ring(*ptrs, n, F, d, Wp, *geom[:5], 48, g.smem_bytes, stream) != 0  # threads % 32
    assert gather(*ptrs, n, F, 4, 2, B, 64, 4, stream) == 0
    assert gather(*ptrs, n, 6, 4, 2, B, 64, 4, stream) != 0                    # F % 4 at vec 4
    assert gather(*ptrs, n, F, 5, 2, B, 64, 1, stream) != 0                    # slot count
    assert gather(*ptrs, n, F, 4, 2, B, 64, 2, stream) != 0                    # vec
    torch.cuda.synchronize()
    assert LAUNCHES == before
    with pytest.raises(ValueError, match="lie on"):
        tpk.banded_spmm_cols(x, torch.ones(2, n), (1, -1))
    with pytest.raises(ValueError, match="float32"):
        tpk.banded_spmm_cols(x, torch.ones(2, n, device=cuda_device).double(), (1, -1))
    with pytest.raises(ValueError, match="lie on"):
        tpk._banded_cols_window_launch(x, torch.ones(2, n), (1, -1))
    # window_warp_gather's and the column ring's C launchers refuse what
    # their kernels do not take, and launch nothing
    before = dict(LAUNCHES)
    warp = tpk._fn("window_warp_gather_launch", (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 7
                   + (ctypes.c_void_p,))
    out = torch.empty(n, F, device=cuda_device)
    wptrs = (xpad.data_ptr(), lidx.data_ptr(), w.data_ptr(), out.data_ptr())
    assert warp(*wptrs, n, F, d, B, Wp, 4, 0, stream) == 0
    assert warp(*wptrs, n, F, d, 100, Wp, 4, 0, stream) != 0                 # B ∤ n
    assert warp(*wptrs, n, 6, d, B, Wp, 4, 0, stream) != 0                   # F % 4 at vec 4
    assert warp(xpad.data_ptr() + 4, *wptrs[1:], n, F, d, B, Wp, 4, 0, stream) != 0
    assert warp(*wptrs, n, F, d, B, Wp, 2, 0, stream) != 0                   # vec
    assert warp(*wptrs, n, F, d, B, Wp, 4, 2, stream) != 0                   # dtype
    offs = (ctypes.c_int * 2)(1, -1)
    wcols = torch.ones(2, n, device=cuda_device)
    geom = tb.stream_shape(n, F, 8, 2)
    cols = tb._stream_kernel("banded_stream_cols_launch")

    def launch(x_ptr=x.data_ptr(), F=F, smem=geom.smem_bytes):
        return cols(x_ptr, wcols.data_ptr(), out.data_ptr(), n, F, offs, 2, geom.wp,
                    geom.chunk, geom.strip, geom.cols, geom.ring_rows, smem, stream)

    assert launch() == 0
    assert launch(x_ptr=x.data_ptr() + 4) != 0
    assert launch(F=6) != 0
    assert launch(smem=geom.smem_bytes + 16) != 0
    torch.cuda.synchronize()
    assert LAUNCHES == before


# ---- K4 (csrc/banded_stream.cu, a shared-memory ring), K1 (csrc/block_ell_gather.cu)

# (n, F, offsets): n not a multiple of the strip, n below the chunk (one
# strip that wraps at both ends), 2·Wp == n, a partial last chunk of a
# 1024-row strip, rows that are not 16-byte pieces (F = 3, 5, 130: the
# earlier body), column tails, D = 1
STREAM_K4_CASES = [
    (5000, 16, (1, -1, 5, -5, 63, -63)),
    (1000, 8, (7, -7, 60, -60)),
    (40, 8, (7, -7, 16, -16)),
    (128, 12, (64, -64, 3)),
    (300_000, 8, (1, -1, 5, -5, 63, -63)),
    (2048, 3, (2, -7, 9)),
    (2000, 5, (40, -3)),
    (4096, 130, (17, -17, 32, -32, 52, -52, 39, -39)),
    (3000, 32, (5,)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", STREAM_K4_CASES, ids=range(len(STREAM_K4_CASES)))
def test_cuda_banded_stream_matches_plain(cuda_device, case):
    n, F, offsets = case
    rng = np.random.default_rng(12)
    x = torch.tensor(rng.normal(size=(n, F)).astype(np.float32), device=cuda_device)
    w = torch.tensor((rng.random((n, len(offsets))) + 0.5).astype(np.float32),
                     device=cuda_device)
    if F % 4:
        # the ring takes only 16-byte rows: the earlier body runs these
        with pytest.raises(ValueError, match="16-byte"):
            tb._stream_launch(x, w, offsets)
        y = tb._launch(x, offsets, F, w, op="banded_spmm")
    else:
        y = tb._stream_launch(x, w, offsets)
    torch.cuda.synchronize()
    # the plain version's arithmetic and order: equal bit for bit
    assert torch.equal(y, tb.banded_spmm_plain(x, w, offsets))
    # the op, forward and backward: one launch each, counted by the kernel
    # that ran
    key = "banded_spmm" if F % 4 == 0 else "banded_spmm_window"
    before = dict(LAUNCHES)
    xk, wk = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    yk = tb.banded_spmm(xk, wk, offsets)
    dy = torch.tensor(rng.normal(size=(n, F)).astype(np.float32), device=cuda_device)
    yk.backward(dy)
    torch.cuda.synchronize()
    assert {k: LAUNCHES[k] - before[k] for k in LAUNCHES} == {
        k: 2 if k == key else 0 for k in LAUNCHES}
    xp, wq = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
    yp = tb.banded_spmm_plain(xp, wq, offsets)
    yp.backward(dy)
    assert torch.equal(yk.detach(), yp.detach())
    assert_kernel_close(xk.grad, xp.grad)
    torch.testing.assert_close(wk.grad, wq.grad, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_banded_stream_matches_its_earlier_body(cuda_device):
    offsets = (17, -17, 32, -32, 52, -52, 39, -39)
    rng = np.random.default_rng(13)
    x = torch.tensor(rng.normal(size=(131072, 128)).astype(np.float32), device=cuda_device)
    w = torch.tensor((rng.random((131072, 8)) + 0.5).astype(np.float32), device=cuda_device)
    y = tb._stream_launch(x, w, offsets)
    assert torch.equal(y, tb._launch(x, offsets, 128, w, op="banded_spmm"))  # the earlier body
    # the C entry point refuses a misaligned x or rows that are not 16-byte
    # pieces (its scalar path is gone)
    geom = tb.stream_shape(131072, 128, tb.padded_bandwidth(offsets), 8)
    offs = (ctypes.c_int * 8)(*offsets)
    out = torch.empty_like(x)

    def launch(x_ptr=x.data_ptr(), F=128):
        return tb._stream_kernel()(x_ptr, w.data_ptr(), out.data_ptr(), 131072, F, offs, 8,
                                   geom.wp, geom.chunk, geom.strip, geom.cols, geom.ring_rows,
                                   geom.smem_bytes, torch.cuda.current_stream().cuda_stream)

    assert launch() == 0
    torch.cuda.synchronize()
    assert torch.equal(out, y)
    assert launch(x_ptr=x.data_ptr() + 4) != 0
    assert launch(F=126) != 0


def _stream_table(n, width, r0, wp, rng, pad_frac=0.2):
    """An [n, width] table of senders in each receiver's slice, a few
    beyond it (skipped), and padding slots (sender n − 1, weight 0)."""
    i = np.arange(n)[:, None]
    start = i // r0 * r0
    sidx = (start - wp + rng.integers(-8, r0 + 2 * wp + 8, size=(n, width))) % n
    w = (rng.random((n, width)) + 0.5).astype(np.float32)
    pad = rng.random((n, width)) < pad_frac
    sidx[pad], w[pad] = n - 1, 0.0
    return sidx.astype(np.int32), w


# (n, F, block, wp, width): the 16-byte path, R0 = B = 240, width 1, the
# scalar path and column tails (F = 3, 5, 130)
STREAM_K1_CASES = [
    (1280, 16, 256, 64, 6),
    (1280, 64, 256, 320, 8),
    (1200, 3, 240, 40, 4),
    (2048, 5, 512, 192, 8),
    (2048, 130, 256, 128, 3),
    (4096, 128, 512, 192, 8),
    (1024, 8, 256, 64, 1),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", STREAM_K1_CASES, ids=range(len(STREAM_K1_CASES)))
def test_cuda_block_ell_stream_matches_plain(cuda_device, case):
    n, F, block, wp, width = case
    rng = np.random.default_rng(14)
    r0 = tbell.sub_block_rows(block)
    sidx, w = _stream_table(n, width, r0, wp, rng)
    x = torch.tensor(rng.normal(size=(n, F)).astype(np.float32), device=cuda_device)
    si, wt = torch.tensor(sidx, device=cuda_device), torch.tensor(w, device=cuda_device)
    assert tbell.gather_shape(n, F)[0] == (4 if F % 4 == 0 else 1)
    ref = tpk.subblock_spmm_plain(x, si, wt, n, block, wp)    # the same slice test
    assert torch.equal(tbell._launch(x, si, wt, n, block, wp), ref)


@pytest.mark.cuda
def test_cuda_block_ell_stream_launch_counts_and_transpose_plan(cuda_device):
    n = 2048
    rng = np.random.default_rng(15)
    adj = np.zeros((n, n), np.float32)
    edges = _banded_edges(n, 3, 40, 4, [(3, 1500), (700, 10)])
    adj[edges[:, 0], edges[:, 1]] = rng.random(edges.shape[0]) + 0.5
    g = graph_from_dense(adj, block_ell=True)
    assert not g.symmetric and g.bell_t_block is not None
    gc = g.to(cuda_device)
    for F in (3, 8):
        x = torch.tensor(rng.normal(size=(n, F)).astype(np.float32))
        dy = torch.tensor(rng.normal(size=(n, F)).astype(np.float32))
        before = LAUNCHES["block_ell_spmm"]
        xc = x.to(cuda_device).requires_grad_(True)
        yc = spmm(gc, xc, gc.weights)
        yc.backward(dy.to(cuda_device))
        torch.cuda.synchronize()
        assert LAUNCHES["block_ell_spmm"] == before + 2      # forward + transpose plan
        xp = x.clone().requires_grad_(True)
        yp = spmm(g, xp, g.weights)
        yp.backward(dy)
        assert_kernel_close(yc.detach().cpu(), yp.detach())
        assert_kernel_close(xc.grad.cpu(), xp.grad)


# ---- K5, K6 (csrc/halo_stream.cu, a shared-memory ring in halo mode) -------

def _ring_launch(launch, xs, offsets, mesh, r=None, ws=None):
    """A whole ring op on one launcher (``th._launch`` or the earlier body
    ``th._window_launch``): the exchange, then one launch per shard."""
    n_loc, F = xs[0].shape
    views = [x if r is None else x.view(n_loc // r, r * F) for x in xs]
    tiles = th.halo_exchange(views, tb.padded_bandwidth(offsets), mesh,
                             None if r is None else F)
    op = "halo_banded_spmm" if r is None else "halo_banded_spmm_unit_packed"
    return torch.cat([launch(v, pre, post, offsets, None if ws is None else ws[c], op=op)
                      .view(n_loc, F) for c, ((pre, post), v) in enumerate(zip(tiles, views))])


# (D, n_shard, F, r, offsets, misaligned): K5 (r = 1) and K6 (r = 8) on
# rings of 1, 2 and 4 shards; m below one chunk, a partial last chunk and
# strip, Wp = m, L = 3 and 20, shards split from one tensor at F = 3 (pre
# and post are then views at addresses that are not 16-byte aligned), and
# shards of a buffer one element off 16-byte alignment
HALO_STREAM_CASES = [
    (1, 4096, 128, 1, BENCH_OFFSETS, False),
    (2, 40, 16, 1, (1, -1, 5, -5), False),            # m below one chunk
    (4, 1000, 32, 1, (7, -7, 60, -60), False),        # partial last chunk
    (2, 300_000, 8, 1, (1, -1, 5, -5, 63, -63), False),  # partial last strip
    (4, 64, 20, 1, (1, -1, 7, -7, 60, -60), False),   # Wp = m, L = 20
    (4, 2048, 3, 1, BENCH_OFFSETS, False),             # L = 3
    (4, 37 * 8, 3, 1, (1, -1, 7, -7), False),          # m·3·4 ≢ 0 mod 16
    (2, 4096, 16, 1, (2, -2, 9, -9), True),            # misaligned buffer
    (1, 4096, 16, 8, (63, -63, 1, -1), False),         # K6, L = 128
    (2, 8192, 16, 8, (9, -9, 2, -2, 33, -33), False),
    (4, 512, 16, 8, (63, -63, 1, -1), False),          # K6, Wp = m_loc = 64
    (4, 384, 8, 3, (2, -2, 9, -9), False),             # K6, L = 24
]


def _halo_block(n_shard, offsets):
    """The smallest block the K5 ops accept: a multiple of 8 that divides
    the shard and is at least Wp."""
    wp = max(8, tb.padded_bandwidth(offsets))
    return next(b for b in range(wp, n_shard + 1, 8) if n_shard % b == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", HALO_STREAM_CASES, ids=range(len(HALO_STREAM_CASES)))
def test_cuda_halo_stream_equals_plain_and_earlier_body(cuda_device, case, dtype):
    n_dev, n_shard, F, r, offsets, misaligned = case
    mesh = _ring(cuda_device, n_dev)
    rng = np.random.default_rng(16)
    n = n_dev * n_shard
    x = torch.tensor(rng.normal(size=(n, F)).astype(np.float32)).to(cuda_device, dtype)
    if misaligned:
        flat = torch.empty(n * F + 1, dtype=dtype, device=cuda_device)
        x = flat[1:].view(n, F).copy_(x)
    w = torch.tensor((rng.random((n, len(offsets))) + 0.5).astype(np.float32), device=cuda_device)
    dy = torch.tensor(rng.normal(size=(n, F)).astype(np.float32)).to(cuda_device, dtype)
    xs, ws, dys = list(x.split(n_shard)), list(w.split(n_shard)), list(dy.split(n_shard))
    m, L = n_shard // r, r * F
    vec16 = L * x.element_size() % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in xs)
    assert th._vec16(L, x.element_size(), *xs) == vec16
    narrow = (r, F) == (1, 3) or (r, F, dtype) == (1, 20, torch.bfloat16)
    assert vec16 == (not misaligned and not narrow)
    neg = [-o for o in offsets]
    # forward and gradient of the unit op, one launch per shard each,
    # counted by the kernel that ran: shards without 16-byte rows or
    # addresses go to the earlier body (the cotangents are fresh, aligned)
    op = "halo_banded_spmm" if r == 1 else "halo_banded_spmm_unit_packed"
    before = dict(LAUNCHES)
    xk = [t.detach().requires_grad_(True) for t in xs]      # the shards' own addresses
    if r == 1:
        yk = th.halo_banded_spmm_unit(xk, offsets, mesh, _halo_block(n_shard, offsets))
    else:
        yk = th.halo_banded_spmm_unit_packed(xk, offsets, r, mesh)
    fwd = {op: n_dev if vec16 else 0, op + "_window": 0 if vec16 else n_dev}
    assert {k: LAUNCHES[k] - before[k] for k in fwd} == fwd
    torch.autograd.backward(yk, dys)
    torch.cuda.synchronize()
    bwd16 = not narrow
    assert {k: LAUNCHES[k] - before[k] for k in fwd} == {
        op: fwd[op] + (n_dev if bwd16 else 0),
        op + "_window": fwd[op + "_window"] + (0 if bwd16 else n_dev)}
    assert sum(LAUNCHES[k] - before[k] for k in LAUNCHES) == 2 * n_dev
    y, g = torch.cat(yk).detach(), torch.cat([t.grad for t in xk])
    # the plain version sums in float32 in offset order and rounds once, as
    # the kernel does: equal bit for bit, in bfloat16 too; the gradient is
    # the plain version of the adjoint (negated offsets)
    assert torch.equal(y, torch.cat(th.halo_ring_plain(xs, offsets, mesh, r=r)))
    assert torch.equal(g, torch.cat(th.halo_ring_plain(dys, neg, mesh, r=r)))
    assert torch.equal(y, _ring_launch(th._window_launch, xs, offsets, mesh, r))
    assert torch.equal(g, _ring_launch(th._window_launch, dys, neg, mesh, r))
    if r == 1:
        # weighted K5 (forward only)
        yw = torch.cat(th.halo_banded_spmm(xs, ws, offsets, mesh, _halo_block(n_shard, offsets)))
        assert torch.equal(yw, torch.cat(th.halo_ring_plain(xs, offsets, mesh, ws=ws)))
        assert torch.equal(yw, _ring_launch(th._window_launch, xs, offsets, mesh, ws=ws))


@pytest.mark.cuda
def test_cuda_halo_stream_rejects_what_it_does_not_take(cuda_device):
    offsets = (1, -1, 5, -5)
    x = torch.randn(1024, 16, device=cuda_device)
    pre, post = torch.randn(8, 16, device=cuda_device), torch.randn(8, 16, device=cuda_device)
    out = torch.empty_like(x)
    g = th.halo_stream_shape(1024, 16, 8, 0, 4)
    offs = (ctypes.c_int * 4)(*offsets)
    stream = torch.cuda.current_stream().cuda_stream

    def launch(x_ptr=x.data_ptr(), pre_ptr=pre.data_ptr(), L=16, smem=g.smem_bytes):
        return th._stream_kernel()(x_ptr, pre_ptr, post.data_ptr(), None, out.data_ptr(),
                                   1024, L, offs, 4, 8, 0, g.chunk, g.strip, g.cols,
                                   smem, stream)

    assert launch() == 0
    torch.cuda.synchronize()
    assert torch.equal(out, th.halo_banded_spmm_plain(x, None, pre, post, offsets))
    assert launch(smem=g.smem_bytes + 16) != 0          # a smem sum that is not the kernel's
    assert launch(x_ptr=x.data_ptr() + 4) != 0          # 16-byte copies from a misaligned x
    assert launch(pre_ptr=pre.data_ptr() + 4) != 0      # ... or a misaligned tile
    assert launch(L=15) != 0                            # rows that are not 16-byte pieces
    # the op's checks stay, with their messages
    op = "halo_banded_spmm"
    with pytest.raises(ValueError, match="halo tiles"):
        th._launch(x, pre[:4], post, offsets, op=op)
    with pytest.raises(ValueError, match="halo width"):
        th._launch(x, pre, post, (9, -1), op=op)
    with pytest.raises(ValueError, match="weights"):
        th._launch(x, pre, post, offsets, torch.ones(1024, 3, device=cuda_device), op=op)


def _recipe_graphs(count=3):
    """Graphs of the recipe's kind: n = 500, d in [6, 8], padded to 1000."""
    specs, _ = generate_graph_dataset(count, 500, 500, 6, 8, base_seed=77)
    return [g for _, g in sorted(process_graphs(specs, DataConfig(max_nodes=1000)).graphs.items())]


@pytest.mark.cuda
def test_cuda_batched_greedy_flip_equals_cpu(cuda_device):
    """The recipe's graphs (n_pad 1000), 6 starts, 500 steps: the card's
    climb (``csrc/climb.cu``, one launch a graph) against the CPU's eager
    lockstep climb."""
    rng = np.random.default_rng(0)
    for g in _recipe_graphs():
        starts = torch.tensor(rng.integers(0, 3, (6, g.n_pad)))
        starts[:, :3] = torch.arange(3)
        asn, cut = greedy_flip_local_search(g, starts, max_steps=500)
        launched = LAUNCHES["climb"]
        asn_c, cut_c = greedy_flip_local_search(g.to(cuda_device), starts.to(cuda_device),
                                                max_steps=500)
        assert LAUNCHES["climb"] == launched + 1
        assert torch.equal(asn_c.cpu(), asn) and torch.equal(cut_c.cpu(), cut)


def _kernel_against_cpu(g, starts, max_steps, whole_weights=True):
    """The kernel route against the CPU's eager lockstep climb and the
    plain version's move counts; the kernel launched twice.  The cuts are
    the CPU's where the weights are whole numbers; with other weights the
    card's cut sums in another order, so it is held to the card's cut of
    the CPU's assignments."""
    asn, cut = greedy_flip_local_search(g, starts, max_steps=max_steps)
    _, moves = tclimb.greedy_climb_plain(g, starts, 3, 3, max_steps)
    launched = LAUNCHES["climb"]
    gc, sc = g.to("cuda"), starts.to("cuda")
    asn_c, cut_c = greedy_flip_local_search(gc, sc, max_steps=max_steps)
    asn_k, moves_k = tclimb.greedy_climb(gc, sc, 3, 3, max_steps)
    assert LAUNCHES["climb"] == launched + 2
    assert torch.equal(asn_c.cpu(), asn) and torch.equal(asn_k.cpu(), asn)
    assert torch.equal(moves_k.cpu(), moves)
    want = cut if whole_weights else hard_cut_value(gc, asn.to("cuda")).cpu()
    assert torch.equal(cut_c.cpu(), want)
    return moves


@pytest.mark.cuda
@pytest.mark.parametrize("max_steps", [1, 5, 16, 17, 500])
def test_cuda_climb_kernel_cut_short_equals_cpu(cuda_device, max_steps):
    """The cap cuts climbs short at 1, 5, 16 and 17 moves (16 and 17: a
    block of the lockstep loop's, and one more)."""
    rng = np.random.default_rng(max_steps)
    g = _recipe_graphs(1)[0]
    starts = torch.tensor(rng.integers(0, 3, (4, g.n_pad)))
    starts[:, :3] = torch.arange(3)
    moves = _kernel_against_cpu(g, starts, max_steps)
    assert int(moves.max()) == max_steps if max_steps < 500 else int(moves.max()) < 500


@pytest.mark.cuda
def test_cuda_climb_kernel_exact_with_non_integer_weights(cuda_device):
    """Weights in [0.1, 2): W recomputed in CSR order after each move stays
    the CPU's index_add sum bit for bit, and so do the climbs."""
    rng = np.random.default_rng(4)
    edges = np.asarray(random_regular_edges(400, 7, 4))
    w = rng.uniform(0.1, 2.0, len(edges)).astype(np.float32)
    g = graph_from_edges(edges, 400, weights=w, n_pad=512)
    starts = torch.tensor(rng.integers(0, 3, (6, g.n_pad)))
    starts[:, :3] = torch.arange(3)
    assert int(_kernel_against_cpu(g, starts, 500, whole_weights=False).max()) > 50


@pytest.mark.cuda
def test_cuda_climb_kernel_breaks_ties_as_cpu(cuda_device):
    """All-zero starts, beside random ones: many moves share the best gain,
    the first best (lowest node, then class) is taken."""
    g = _recipe_graphs(1)[0]
    starts = torch.zeros((3, g.n_pad), dtype=torch.int64)
    starts[1, :3] = torch.arange(3)
    starts[2] = torch.tensor(np.random.default_rng(5).integers(0, 3, g.n_pad))
    _kernel_against_cpu(g, starts, 500)


@pytest.mark.cuda
def test_cuda_refine_multi_start_equals_cpu(cuda_device):
    gen = torch.Generator().manual_seed(1)
    for g in _recipe_graphs(2):
        probs = torch.softmax(2 * torch.randn((g.n_pad, 3), generator=gen), dim=-1)
        u = torch.rand((200, g.n_pad, 1), generator=gen)
        asn, cut = refine_multi_start_from_uniforms(g, probs, u, 4)
        asn_c, cut_c = refine_multi_start_from_uniforms(
            g.to(cuda_device), probs.to(cuda_device), u.to(cuda_device), 4)
        assert torch.equal(asn_c.cpu(), asn) and float(cut_c) == float(cut)


def _sharded(n, edges, D, mesh, **kw):
    s = np.concatenate([edges[:, 0], edges[:, 1]])
    r = np.concatenate([edges[:, 1], edges[:, 0]])
    sg, _ = tpart.shard_graph(s, r, n, D, **kw)
    return sg, sg.to(mesh)


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["ring", "allgather"])
@pytest.mark.parametrize("build_ell", [True, False], ids=["ell", "coo"])
def test_cuda_sharded_spmm_on_a_virtual_ring_matches_the_cpu_ring(cuda_device, schedule,
                                                                   build_ell):
    D, n, F = 4, 4096, 64
    card, cpu = make_mesh(devices=[cuda_device] * D), make_mesh(devices=["cpu"] * D)
    host, sg = _sharded(n, random_regular_edges(n, 8, seed=3), D, card, build_ell=build_ell)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(D, sg.n_shard, F)).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)
    outs = []
    for mesh, g in ((card, sg), (cpu, host.to(cpu))):
        xs = [torch.tensor(a, device=dev, requires_grad=True) for a, dev in zip(x, mesh.devices)]
        ys = tspmm.sharded_spmm_sym(g, xs, mesh, schedule)
        loss = sum(torch.sum(y * torch.tensor(t, device=y.device)) for y, t in zip(ys, dy))
        grads = torch.autograd.grad(loss, xs)
        outs.append([torch.stack([t.detach().cpu() for t in v]) for v in (ys, grads)])
    for got, ref in zip(*outs):
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("F", [64, 3])
def test_cuda_k1_on_a_hop0_shard_plan_matches_plain(cuda_device, F):
    D, n = 4, 16_384
    card = make_mesh(devices=[cuda_device] * D)
    edges = banded_random_edges(n, 8, 255, 0)
    _, sg = _sharded(n, edges, D, card, local_reorder="rcm", block_ell=True)
    assert sg.bell_block is not None
    rng = np.random.default_rng(5)
    tlaunches.reset()
    for d in range(D):
        x = torch.tensor(rng.normal(size=(sg.n_shard, F)).astype(np.float32), device=cuda_device,
                         requires_grad=True)
        args = (sg.bell_senders[d], sg.bell_weights[d], sg.bell_out_senders[d],
                sg.bell_out_receivers[d], sg.bell_out_weights[d], sg.n_shard, sg.bell_block,
                sg.bell_wp)
        y = tbell.block_ell_spmm(x, *args)
        (dx,) = torch.autograd.grad(torch.sum(y * y), x)
        ref = tbell.block_ell_spmm_plain(x.detach(), *args)
        assert_kernel_close(y, ref)
        assert_kernel_close(dx, tbell.block_ell_spmm_plain(2 * ref, *args))
    assert LAUNCHES["block_ell_spmm"] == 2 * D


TRAINING_VARIANTS = {
    "batched": dict(step_mode="batched"),
    "cosine": dict(lr_schedule="cosine", learning_rate=2e-2),
    "quantile": dict(loss_mode="quantile"),
    "entropy": dict(entropy_weight=0.5),
}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(TRAINING_VARIANTS))
def test_cuda_training_variant_matches_cpu(cuda_device, variant):
    specs, _ = generate_graph_dataset(num_graphs=3, min_nodes=40, max_nodes=56, min_degree=3,
                                      max_degree=6, base_seed=21)
    ds = process_graphs(specs, DataConfig(max_nodes=64))
    batch = pad_graph_batch([ds.graphs[k] for k in sorted(ds.graphs)])
    cfg = TrainingConfig(**{**dict(n_nodes=64, number_epochs=10, learning_rate=5e-3,
                                   patience=100), **TRAINING_VARIANTS[variant]})
    steps = 3 if cfg.step_mode == "per_graph" else 1
    start = tloop.setup_train_state(cfg, steps, device="cpu").params()
    hist = [tloop.train_model(batch, cfg, state=tloop.setup_train_state(
        cfg, steps, params=start, device=dev))[4] for dev in ("cpu", cuda_device)]
    np.testing.assert_allclose(hist[1], hist[0], rtol=1e-4)


@pytest.mark.cuda
def test_cuda_qubo_loop_matches_cpu(cuda_device):
    specs, _ = generate_graph_dataset(num_graphs=1, min_nodes=60, max_nodes=60, min_degree=3,
                                      max_degree=3, base_seed=6)
    g = process_graphs(specs, DataConfig(max_nodes=64)).graphs[0]
    cfg = tqubo.QuboConfig(dim_embedding=16, hidden_dim=8, learning_rate=1e-2,
                           number_epochs=10, seed=1)
    gen = torch.Generator().manual_seed(1)
    start = gcn_dev_init(16, 8, 1, generator=gen)
    start["embed"] = embedding_init(g.n_pad, 16, gen)
    runs = [tqubo.run_gnn_training(g, cfg, device=dev, params=start)[1]
            for dev in ("cpu", cuda_device)]
    np.testing.assert_allclose(runs[1]["loss_history"], runs[0]["loss_history"], rtol=1e-4)
    assert runs[1]["best_cut"] == runs[0]["best_cut"]


def _coo(edges):
    return (np.concatenate([edges[:, 0], edges[:, 1]]),
            np.concatenate([edges[:, 1], edges[:, 0]]))


@pytest.mark.cuda
def test_cuda_hybrid_on_a_2x4_mesh_matches_the_cpu(cuda_device):
    n = 4096
    lists = [_coo(random_regular_edges(n, 8, seed=s)) for s in (1, 2)]
    cfg = tpgiant.GiantConfig(number_epochs=10, log_every=1)
    tlaunches.reset()
    runs = [thybrid.train_hybrid(lists, n, cfg, mesh=make_mesh(
        ("data", "graph"), shape=(2, 4), devices=[dev] * 8)) for dev in (cuda_device, "cpu")]
    for key in ("loss_history", "per_graph_cuts"):    # float sums in another order
        np.testing.assert_allclose(runs[0][key], runs[1][key], rtol=1e-3)
    assert LAUNCHES["block_ell_spmm"] == 0          # expanders: no plan


@pytest.mark.cuda
def test_cuda_dp_epochs_match_the_cpu(cuda_device):
    specs, _ = generate_graph_dataset(num_graphs=8, min_nodes=40, max_nodes=56, min_degree=3,
                                      max_degree=6, base_seed=21)
    ds = process_graphs(specs, DataConfig(max_nodes=64))
    batch = pad_graph_batch([ds.graphs[k] for k in sorted(ds.graphs)])
    cfg = TrainingConfig(n_nodes=64, learning_rate=5e-3)
    start = tloop.setup_train_state(cfg, device="cpu").params()
    hist = []
    for dev in (cuda_device, "cpu"):
        state = tloop.setup_train_state(cfg, params=start, device=dev)
        mesh = make_mesh(("data",), devices=[dev] * 4)
        fn = tdp.make_dp_epoch_fn(cfg, state.optimizer, mesh)
        shards = tdp.shard_batch_for_dp(batch, mesh)
        hist.append([fn(state, shards) for _ in range(10)])
    np.testing.assert_allclose(hist[0], hist[1], rtol=1e-4)


@pytest.mark.cuda
def test_cuda_k1_on_hybrid_shard_plans_matches_plain(cuda_device):
    n, D = 16_384, 4
    lists = [_coo(banded_random_edges(n, 8, 255, s)) for s in (0, 1)]
    mesh = make_mesh(("data", "graph"), shape=(2, D), devices=[cuda_device] * (2 * D))
    sgb = thybrid.stack_sharded_graphs([
        tpart.shard_graph(s, r, n, D, local_reorder="rcm", block_ell=True)[0] for s, r in lists])
    rng = np.random.default_rng(5)
    for sg, row in zip(sgb, mesh.rows):
        sg = sg.to(row)
        assert sg.bell_senders is not None and len(sg.bell_senders) == D
        for d in range(D):
            x = torch.tensor(rng.normal(size=(sg.n_shard, 64)).astype(np.float32),
                             device=cuda_device)
            args = (sg.bell_senders[d], sg.bell_weights[d], sg.bell_out_senders[d],
                    sg.bell_out_receivers[d], sg.bell_out_weights[d], sg.n_shard,
                    sg.bell_block, sg.bell_wp)
            assert_kernel_close(tbell.block_ell_spmm(x, *args),
                                tbell.block_ell_spmm_plain(x, *args))
    cfg = tpgiant.GiantConfig(number_epochs=2, block_ell=True, local_reorder="rcm")
    tlaunches.reset()
    thybrid.train_hybrid(lists, n, cfg, mesh=mesh)
    assert LAUNCHES["block_ell_spmm"] == 2 * D * 6 * 2


@pytest.mark.cuda
def test_cuda_timer_waits_for_the_card(cuda_device):
    x = torch.randn(4096, 4096, device=cuda_device)
    torch.cuda.synchronize()
    with Timer() as unsynced:
        y = x @ x
    with Timer(sync=[y]) as synced:
        y = x @ x
        for _ in range(20):
            y = y @ x * 1e-3
    assert synced.elapsed > unsynced.elapsed


def _solver_graph(n, d, seed):
    specs, _ = generate_graph_dataset(num_graphs=1, min_nodes=n, max_nodes=n, min_degree=d,
                                      max_degree=d, base_seed=seed)
    return process_graphs(specs, DataConfig(max_nodes=n)).graphs[0]


@pytest.mark.cuda
def test_cuda_brute_force_equals_cpu_and_native(cuda_device):
    from gcn_maxcut_tpu_torch.baselines.exact import brute_force_maxcut
    from gcn_maxcut_tpu_torch.native.bindings import brute_force_maxcut_native

    g = _solver_graph(14, 3, 4)
    asn, cut = brute_force_maxcut(g)
    asn_c, cut_c = brute_force_maxcut(g.to(cuda_device), batch=1 << 16)
    assert cut_c == cut
    np.testing.assert_array_equal(asn_c, asn)
    m = g.edge_mask.numpy() > 0
    s, r = g.senders.numpy()[m], g.receivers.numpy()[m]
    edges = np.stack([s[s < r], r[s < r]], axis=1)
    assert brute_force_maxcut_native(edges, 14)[1] == cut


@pytest.mark.cuda
def test_cuda_sa_chains_equal_cpu(cuda_device):
    """The batched SA chains and their climb on the card from the CPU's
    draws.  A float ``exp`` differing by an ulp on a tie could flip one
    acceptance; the best cut is then held to one edge."""
    from gcn_maxcut_tpu_torch.baselines.exact import _sa_restart_batch_from_draws

    g = _solver_graph(100, 6, 2)
    gen = torch.Generator().manual_seed(0)
    R, steps = 8, 500
    draws = (torch.randint(0, 3, (R, g.n_pad), generator=gen),
             torch.randint(3, g.n_pad, (R, steps), generator=gen),
             torch.randint(0, 3, (R, steps), generator=gen),
             torch.rand((R, steps), generator=gen))
    asn, cut = _sa_restart_batch_from_draws(g, *draws, 3, 3)
    asn_c, cut_c = _sa_restart_batch_from_draws(
        g.to(cuda_device), *(t.to(cuda_device) for t in draws), 3, 3)
    assert abs(float(cut_c) - float(cut)) <= 1.0
    if float(cut_c) == float(cut):
        assert torch.equal(asn_c.cpu(), asn)


# Chunks of epochs (train/chunks.py): one captured CUDA graph replayed an
# epoch at a time, against the same epochs run eagerly on the card.

def _python_number_adam_step(params, grads, mu, nu, count, lr, b1=0.9, b2=0.999, eps=1e-8):
    """The Adam step written with Python numbers, as the port had it."""
    bc1, bc2 = 1.0 - b1 ** count, 1.0 - b2 ** count
    for i, (p, g) in enumerate(zip(params, grads)):
        m = (1.0 - b1) * g + b1 * mu[i]
        v = (1.0 - b2) * (g * g) + b2 * nu[i]
        p.add_(((m / bc1) / (torch.sqrt(v / bc2) + eps)) * -lr)
        mu[i], nu[i] = m.to(mu[i].dtype), v


@pytest.mark.cuda
@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_cuda_captured_adam_equals_the_python_number_step(cuda_device, schedule):
    """On the card ``x / python_float`` is a product with the float32
    reciprocal; the tables hold those reciprocals, so the captured step is
    the Python-number step bit for bit, and so is the eager step."""
    from gcn_maxcut_tpu_torch.train.chunks import ChunkRunner
    from gcn_maxcut_tpu_torch.train.optim import Adam, cosine_decay_schedule

    lr = cosine_decay_schedule(3e-2, 12, 0.05) if schedule == "cosine" else 3e-2
    gen = torch.Generator().manual_seed(5)
    start = [torch.randn(s, generator=gen).to(cuda_device) for s in [(64, 33), (33,)]]

    def grads_of(ps):
        return [torch.sin(p * 3.0) * 10.0 for p in ps]

    ref = [p.clone() for p in start]
    mu = [torch.zeros_like(p) for p in ref]
    nu = [torch.zeros_like(p) for p in ref]
    for count in range(1, 31):
        _python_number_adam_step(ref, grads_of(ref), mu, nu, count,
                                 lr(count - 1) if callable(lr) else lr)
    for capture in (None, False):
        got = [p.clone() for p in start]
        opt = Adam(got, lr)

        def step():
            opt.step(grads_of(got))
            return got[0].sum()

        runner = ChunkRunner(step, [cuda_device], 10, capture=capture)
        for _ in range(3):
            runner.run(10)
        assert runner.replays == (29 if capture is None else 0) and opt.count == 30
        for a, b in zip(got + opt.mu + opt.nu, ref + mu + nu):
            assert torch.equal(a, b)


# Adam's step (ops/adam.py): csrc/adam.cu against the plain step on the card,
# bit for bit (a NaN against a NaN, whatever its payload).

ADAM_SIZES = [(1,), (3,), (500,), (1000, 500), (1_000_003,)]
ADAM_UNALIGNED = 4099       # one more leaf, 4 bytes past a 16-byte boundary


def _adam_pairs(device):
    """The leaves twice over (the kernel's and the plain step's): the sizes
    above, then a view at storage offset 1."""
    gen = torch.Generator(device=device).manual_seed(11)
    leaves = [torch.randn(s, generator=gen, device=device) for s in ADAM_SIZES]
    base = torch.randn(1 + ADAM_UNALIGNED, generator=gen, device=device)
    return ([t.clone() for t in leaves] + [base.clone()[1:]],
            [t.clone() for t in leaves] + [base.clone()[1:]])


def _adam_grads(device, step: int):
    """Gradients of the leaves of ``_adam_pairs`` at one step, 1e-3 to 10 in
    scale; the last one also on an unaligned offset."""
    gen = torch.Generator(device=device).manual_seed(1000 + step)
    scale = 10.0 ** (step % 5 - 3)
    grads = [torch.randn(s, generator=gen, device=device) * scale for s in ADAM_SIZES]
    base = torch.randn(1 + ADAM_UNALIGNED, generator=gen, device=device) * scale
    return grads + [base[1:]]


def _same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    ints = {torch.float32: torch.int32, torch.bfloat16: torch.int16, torch.int64: torch.int64}
    same = a.view(ints[a.dtype]) == b.view(ints[b.dtype])
    if a.is_floating_point():
        same |= torch.isnan(a) & torch.isnan(b)
    return bool(same.all())


def _adam_state(opt) -> list:
    return [*opt.params, *opt.mu, *opt.nu, opt._count]


def _adam_launches(before: dict) -> tuple:
    """Update and count launches since ``before``."""
    return tuple(LAUNCHES[k] - before[k] for k in ("adam_update", "adam_count"))


@pytest.mark.cuda
@pytest.mark.parametrize("start", ["zero", "past_the_tables"])
@pytest.mark.parametrize("lr", ["constant", "cosine"])
@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16], ids=["f32_mu", "bf16_mu"])
def test_cuda_adam_kernel_equals_the_plain_step(cuda_device, mu_dtype, lr, start):
    """60 eager steps on the kernel route equal the plain step on the card
    bit for bit, one update and one count launch a step: from count 0 past the cosine's decay
    steps, and from 30 before the tables' last entry past it (the clamp)."""
    from gcn_maxcut_tpu_torch.ops import adam as tadam
    from gcn_maxcut_tpu_torch.train.optim import Adam, cosine_decay_schedule

    rate = cosine_decay_schedule(3e-2, 25, 0.05) if lr == "cosine" else 3e-2
    got, ref = _adam_pairs(cuda_device)
    opt, plain = Adam(got, rate, mu_dtype=mu_dtype), Adam(ref, rate, mu_dtype=mu_dtype)
    if start == "past_the_tables":
        opt.count = plain.count = opt._last - 30
    for step in range(60):
        grads = _adam_grads(cuda_device, step)
        launched = dict(LAUNCHES)
        opt.step(grads)
        assert _adam_launches(launched) == (1, 1)
        tadam.step_plain(plain, grads)
    torch.cuda.synchronize()
    assert opt.count == plain.count == (60 if start == "zero" else opt._last + 30)
    for a, b in zip(_adam_state(opt), _adam_state(plain)):
        assert _same_bits(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16], ids=["f32_mu", "bf16_mu"])
def test_cuda_adam_kernel_flags_a_nonfinite_gradient(cuda_device, mu_dtype):
    """A NaN in one gradient (step 3) and an inf in another (step 5) set
    ``nonfinite`` as the plain step sets it, and the states stay equal."""
    from gcn_maxcut_tpu_torch.ops import adam as tadam
    from gcn_maxcut_tpu_torch.train.optim import Adam

    got, ref = _adam_pairs(cuda_device)
    opt, plain = Adam(got, 1e-2, mu_dtype=mu_dtype), Adam(ref, 1e-2, mu_dtype=mu_dtype)
    for o in (opt, plain):
        o.nonfinite = torch.zeros(1, dtype=torch.bool, device=cuda_device)
    for step in range(8):
        grads = _adam_grads(cuda_device, step)
        if step == 3:
            grads[4][123_457] = float("nan")
        if step == 5:
            grads[2][499] = float("inf")
        opt.step(grads)
        tadam.step_plain(plain, grads)
        assert bool(opt.nonfinite) == bool(plain.nonfinite) == (step >= 3)
    for a, b in zip(_adam_state(opt), _adam_state(plain)):
        assert _same_bits(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("mu_dtype", [torch.float32, torch.bfloat16], ids=["f32_mu", "bf16_mu"])
def test_cuda_captured_adam_kernel_equals_the_plain_step(cuda_device, mu_dtype):
    """The kernel's step captured in a ``ChunkRunner`` (one eager epoch, one
    capture, 59 replays) equals 60 eager plain steps bit for bit; the
    counters carry the captured launches over the replays, two a step."""
    from gcn_maxcut_tpu_torch.ops import adam as tadam
    from gcn_maxcut_tpu_torch.train.chunks import ChunkRunner
    from gcn_maxcut_tpu_torch.train.optim import Adam, cosine_decay_schedule

    rate = cosine_decay_schedule(3e-2, 40, 0.05)
    got, ref = _adam_pairs(cuda_device)
    opt, plain = Adam(got, rate, mu_dtype=mu_dtype), Adam(ref, rate, mu_dtype=mu_dtype)

    def grads_of(ps):
        return [torch.sin(p * 3.0) * 10.0 for p in ps]

    def step():
        opt.step(grads_of(got))
        return got[0].sum()

    launched = dict(LAUNCHES)
    runner = ChunkRunner(step, [cuda_device], 10)
    for _ in range(6):
        runner.run(10)
    assert runner.replays == 59 and _adam_launches(launched) == (60, 60)
    for _ in range(60):
        tadam.step_plain(plain, grads_of(ref))
    torch.cuda.synchronize()
    assert opt.count == plain.count == 60
    for a, b in zip(_adam_state(opt), _adam_state(plain)):
        assert _same_bits(a, b)


@pytest.mark.cuda
def test_cuda_chunk_runner_counts_a_kernel_it_never_names(cuda_device):
    """A step that launches the climb kernel (``ops/climb.py``, which the
    chunk runner does not import): after ``run(k)`` the registry counts it
    k times, one eager launch and k - 1 replays, and the replayed climbs
    give the eager climb's assignments."""
    from gcn_maxcut_tpu_torch.train.chunks import ChunkRunner

    g = _recipe_graphs(1)[0].to(cuda_device)
    starts = torch.tensor(np.random.default_rng(3).integers(0, 3, (4, g.n_pad)),
                          device=cuda_device)
    starts[:, :3] = torch.arange(3, device=cuda_device)
    want, _ = tclimb.greedy_climb(g, starts, 3, 3, 500)
    out = torch.empty_like(starts)

    def step():
        out.copy_(tclimb.greedy_climb(g, starts, 3, 3, 500)[0])

    k = 4
    launched = LAUNCHES["climb"]
    runner = ChunkRunner(step, [cuda_device], k)
    runner.run(k)
    torch.cuda.synchronize()
    assert runner.replays == k - 1 and runner.captured_launches == {"climb": 1}
    assert LAUNCHES["climb"] == launched + k
    assert torch.equal(out, want)


@pytest.mark.cuda
def test_cuda_adam_kernel_splits_past_its_leaf_limit(cuda_device):
    """70 leaves, past the 64 a launch takes: two updates and the count a
    step, equal to the plain step."""
    from gcn_maxcut_tpu_torch.ops import adam as tadam
    from gcn_maxcut_tpu_torch.train.optim import Adam

    gen = torch.Generator(device=cuda_device).manual_seed(4)
    sizes = [1 + 37 * i for i in range(70)]
    start = [torch.randn(n, generator=gen, device=cuda_device) for n in sizes]
    got, ref = [t.clone() for t in start], [t.clone() for t in start]
    opt, plain = Adam(got, 1e-2), Adam(ref, 1e-2)
    for step in range(5):
        grads = [torch.randn(n, generator=gen, device=cuda_device) for n in sizes]
        launched = dict(LAUNCHES)
        opt.step(grads)
        assert _adam_launches(launched) == (2, 1)
        tadam.step_plain(plain, grads)
    for a, b in zip(_adam_state(opt), _adam_state(plain)):
        assert _same_bits(a, b)


@pytest.mark.cuda
def test_cuda_adam_kernel_on_a_mesh_of_two_cards(cuda_device):
    """Leaves on two cards: one update launch on each and the count on the
    first, equal to the plain step."""
    from gcn_maxcut_tpu_torch.ops import adam as tadam
    from gcn_maxcut_tpu_torch.train.optim import Adam

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    devs = [torch.device("cuda", 0), torch.device("cuda", 1)]
    gen = torch.Generator().manual_seed(6)
    start = [torch.randn(n, generator=gen) for n in (5, 4099, 70_001)]
    places = [devs[0], devs[1], devs[1]]
    got = [t.to(d) for t, d in zip(start, places)]
    ref = [t.to(d) for t, d in zip(start, places)]
    opt, plain = Adam(got, 1e-2, mu_dtype=torch.bfloat16), Adam(ref, 1e-2, mu_dtype=torch.bfloat16)
    for o in (opt, plain):
        o.nonfinite = torch.zeros(1, dtype=torch.bool, device=devs[0])
    for step in range(12):
        grads = [(torch.randn(t.shape, generator=gen) * 10.0 ** (step % 3 - 1)).to(d)
                 for t, d in zip(start, places)]
        launched = dict(LAUNCHES)
        opt.step(grads)
        assert _adam_launches(launched) == (2, 1)
        tadam.step_plain(plain, grads)
    torch.cuda.synchronize()
    assert not bool(opt.nonfinite) and opt.count == plain.count == 12
    for a, b in zip(_adam_state(opt), _adam_state(plain)):
        assert _same_bits(a, b)


@pytest.mark.cuda
def test_cuda_adam_kernel_rests_on_bf16_times_a_python_number_in_float32(cuda_device):
    """What ``csrc/adam.cu`` follows: on the card ``b1 * mu`` of a bfloat16
    ``mu`` multiplies by float32(b1) in float32 and rounds to bfloat16."""
    gen = torch.Generator(device=cuda_device).manual_seed(8)
    mu = (torch.randn(1 << 16, generator=gen, device=cuda_device)
          * 10.0 ** torch.randint(-6, 3, (1 << 16,), generator=gen, device=cuda_device)
          ).to(torch.bfloat16)
    for b1 in (0.9, 0.99, 0.5):
        want = (mu.float() * torch.tensor(b1, dtype=torch.float32, device=cuda_device))
        assert _same_bits(b1 * mu, want.to(torch.bfloat16))


def _chunk_batch():
    specs, _ = generate_graph_dataset(num_graphs=3, min_nodes=40, max_nodes=56, min_degree=3,
                                      max_degree=6, base_seed=21)
    ds = process_graphs(specs, DataConfig(max_nodes=64))
    return pad_graph_batch([ds.graphs[k] for k in sorted(ds.graphs)])


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["per_graph", "batched"])
def test_cuda_recipe_chunk_equals_eager(cuda_device, mode):
    """The monitored recipe epoch replayed in chunks of 8, with a stop inside
    a chunk, equals the eager epochs on the card bit for bit; and
    ``train_model`` at K = 8 equals K = 1."""
    from gcn_maxcut_tpu_torch.train.chunks import ChunkRunner

    batch = _chunk_batch()
    cfg = TrainingConfig(n_nodes=64, number_epochs=40, learning_rate=2e-2, patience=3,
                         tolerance=8.0, step_mode=mode, epochs_per_call=8)
    steps = 3 if mode == "per_graph" else 1
    start = tloop.setup_train_state(cfg, steps, device="cpu").params()
    runs = []
    for capture in (True, False):
        state = tloop.setup_train_state(cfg, steps, params=start, device=cuda_device)
        es = tloop.init_early_stop_state(state.params())
        gen = torch.Generator(device=cuda_device).manual_seed(cfg.seed + 1)
        epoch = tloop.make_monitored_epoch_fn(
            state, tloop.epoch_inputs(batch.to(cuda_device), cfg), es, gen)
        runner = ChunkRunner(epoch, [cuda_device], 8, capture=capture)
        chunks = [runner.run(8) for _ in range(5)]
        runs.append((chunks, state.params(), es))
        assert (runner.graph is not None) == capture
    (c_cap, p_cap, es_cap), (c_eag, p_eag, es_eag) = runs
    for (l1, s1), (l2, s2) in zip(c_cap, c_eag):
        np.testing.assert_array_equal(l1, l2)
        np.testing.assert_array_equal(s1, s2)
    assert c_cap[-1][1].all() and not c_cap[0][1].all()     # the run stopped
    for key in ("conv1", "conv2"):
        for k in ("w", "b"):
            assert torch.equal(p_cap[key][k], p_eag[key][k])
            assert torch.equal(es_cap["best_params"][key][k], es_eag["best_params"][key][k])
    assert float(es_cap["best_loss"]) == float(es_eag["best_loss"])
    ks = [tloop.train_model(batch, dataclasses.replace(cfg, epochs_per_call=K),
                            state=tloop.setup_train_state(cfg, steps, params=start,
                                                          device=cuda_device))
          for K in (1, 8)]
    assert ks[0][4] == ks[1][4] and ks[0][2] == ks[1][2] < 39
    assert torch.equal(ks[0][0]["conv1"]["w"], ks[1][0]["conv1"]["w"])


@pytest.mark.cuda
def test_cuda_recipe_chunk_with_dropout_equals_eager(cuda_device):
    """Dropout draws from the loop's own generator, which the runner
    registers with the graph: the captured chunks of 8 with dropout 0.5
    equal the eager epochs on the card bit for bit, and ``train_model`` at
    K = 8 (captured) equals K = 1."""
    from gcn_maxcut_tpu_torch.train.chunks import ChunkRunner

    batch = _chunk_batch()
    cfg = TrainingConfig(n_nodes=64, number_epochs=24, learning_rate=2e-2, dropout=0.5,
                         step_mode="per_graph", epochs_per_call=8)
    start = tloop.setup_train_state(cfg, 3, device="cpu").params()
    runs = []
    for capture in (None, False):
        state = tloop.setup_train_state(cfg, 3, params=start, device=cuda_device)
        es = tloop.init_early_stop_state(state.params())
        gen = torch.Generator(device=cuda_device).manual_seed(cfg.seed + 1)
        epoch = tloop.make_monitored_epoch_fn(
            state, tloop.epoch_inputs(batch.to(cuda_device), cfg), es, gen)
        runner = ChunkRunner(epoch, [cuda_device], 8, capture=capture, generators=[gen])
        losses = np.concatenate([runner.run(8)[0] for _ in range(3)])
        assert (runner.graph is not None) == (capture is None)
        runs.append((losses, state.params()))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    for key in ("conv1", "conv2"):
        for k in ("w", "b"):
            assert torch.equal(runs[0][1][key][k], runs[1][1][key][k])
    ks = [tloop.train_model(batch, dataclasses.replace(cfg, epochs_per_call=K),
                            state=tloop.setup_train_state(cfg, 3, params=start,
                                                          device=cuda_device))
          for K in (1, 8)]
    assert ks[0][4] == ks[1][4] and ks[0][2] == ks[1][2]
    assert torch.equal(ks[0][0]["conv1"]["w"], ks[1][0]["conv1"]["w"])


@pytest.mark.cuda
def test_cuda_packed_giant_chunks_equal_eager(cuda_device, monkeypatch):
    """The packed giant trainer (K3) at K = 4 captured, at K = 1 captured and
    eagerly: one history bit for bit; K3's launches counted exactly."""
    import functools

    from gcn_maxcut_tpu_torch.train.chunks import ChunkRunner

    kw = dict(n=65_536, bandwidth=31, epochs=8, device=cuda_device)
    runs = {}
    for name, K, capture in (("k4", 4, None), ("k1", 1, None), ("eager", 4, False)):
        monkeypatch.setattr(tchunks, "ChunkRunner", functools.partial(ChunkRunner,
                                                                      capture=capture))
        tlaunches.reset()
        runs[name] = tgiant.train_banded_giant_packed(epochs_per_call=K, **kw)
        assert LAUNCHES["banded_spmm_unit_packed"] == 6 * 8
        assert all(LAUNCHES[k] == 8 for k in HEAD_LAUNCHES)
    assert runs["k4"]["history"] == runs["k1"]["history"] == runs["eager"]["history"]


@pytest.mark.cuda
def test_cuda_k1_sharded_chunks_equal_eager(cuda_device, monkeypatch):
    """The node-sharded trainer's chunk (``make_giant_step``) with hop 0 on
    K1, a 4-shard ring of the card, K = 5: captured and eager give one loss
    history, and K1's launches under replay equal the eager count."""
    import functools

    from gcn_maxcut_tpu_torch.bench.locality import locality_params
    from gcn_maxcut_tpu_torch.train.chunks import ChunkRunner

    n, D = 16_384, 4
    s, r = _coo(banded_random_edges(n, 8, 255, 0))
    cfg = tpgiant.GiantConfig(epochs_per_call=5, block_ell=True, local_reorder="rcm")
    ring = make_mesh(devices=[cuda_device] * D)
    sg = tpart.shard_graph(s, r, n, D, local_reorder="rcm", block_ell=True)[0].to(ring)
    assert sg.bell_senders is not None
    runs, counts = [], []
    for capture in (None, False):
        monkeypatch.setattr(tchunks, "ChunkRunner", functools.partial(ChunkRunner,
                                                                      capture=capture))
        params = locality_params(D * sg.n_shard, 128, 64, 3, 0)
        params["embed"] = params["embed"].reshape(D, sg.n_shard, -1)
        state = tpgiant.GiantState.create(params, ring, cfg.learning_rate)
        step = tpgiant.make_giant_step(sg, ring, cfg, state)
        tlaunches.reset()
        runs.append(np.concatenate([step(), step()]))
        counts.append(LAUNCHES["block_ell_spmm"])
        assert step.runner.replays == (9 if capture is None else 0)
    assert counts[0] == counts[1] == D * 6 * 10
    np.testing.assert_array_equal(runs[0], runs[1])


@pytest.mark.cuda
def test_cuda_capture_raises_on_a_host_read(cuda_device):
    """A step that reads the card on the host cannot be captured: the
    runner raises instead of running it eagerly."""
    from gcn_maxcut_tpu_torch.train.chunks import ChunkRunner

    w = torch.ones(8, device=cuda_device)

    def step():
        loss = (w * w).sum()
        w.mul_(0.5 if float(loss) > 1.0 else 1.0)       # a host read
        return loss

    runner = ChunkRunner(step, [cuda_device], 4)
    with pytest.raises(RuntimeError, match="capturing the epoch"):
        runner.run(4)
    assert runner.graph is None and runner.replays == 0


@pytest.mark.cuda
@pytest.mark.parametrize("where", ["loss", "gradient"])
def test_cuda_checked_raises_after_a_replayed_nan(cuda_device, where):
    """``checked`` on captured chunks: a replayed epoch (the third) whose
    loss, or whose gradient as Adam sees it, is NaN raises after its chunk;
    the flag is cleared between chunks, so a clean chunk after a NaN loss
    does not raise."""
    from gcn_maxcut_tpu_torch.train.chunks import ChunkRunner
    from gcn_maxcut_tpu_torch.train.optim import Adam
    from gcn_maxcut_tpu_torch.utils.debug import checked

    w = torch.tensor([1.0, 2.0], device=cuda_device, requires_grad=True)
    opt = Adam([w], 0.1)
    epoch = torch.zeros((), dtype=torch.int64, device=cuda_device)
    nan = torch.tensor(float("nan"), device=cuda_device)

    def step():
        poison = torch.where(epoch == 2, nan, torch.zeros_like(nan))
        loss = (w * w).sum()
        (g,) = torch.autograd.grad(loss, [w])
        if where == "gradient":
            g = g + poison
        opt.step([g])
        epoch.add_(1)
        return loss.detach() + poison if where == "loss" else loss.detach()

    runner = ChunkRunner(step, [cuda_device], 4, optimizer=opt)
    run = checked(runner.run)
    losses, _ = run(2)                          # the eager epoch and a replay
    assert np.isfinite(losses).all() and runner.graph is not None
    with pytest.raises(FloatingPointError, match="non-finite"):
        run(2)                                  # the third epoch is a replay
    assert runner.replays == 3
    if where == "loss":
        losses, _ = run(2)                      # clean again: the flag was reset
        assert np.isfinite(losses).all() and runner.replays == 5


# The JAX package's one-device-call loops and step builders on the card:
# the greedy climb and the SA chains captured a step at a time, make_epoch_fn
# and the halo step builders, each against the same steps run eagerly
# (ChunkRunner(capture=False)), bit for bit.

def _eager_runner(monkeypatch, module):
    import functools

    monkeypatch.setattr(module, "ChunkRunner",
                        functools.partial(module.ChunkRunner, capture=False))


def _captured_route(monkeypatch):
    """The climb takes the captured lockstep route on any graph: no start
    fits the kernel's shared memory."""
    monkeypatch.setattr(tclimb, "_SMEM_LIMIT", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("max_steps", [37, 500])
def test_cuda_captured_climb_equals_eager_with_one_capture(cuda_device, monkeypatch,
                                                           max_steps):
    """Four recipe graphs of one padded shape climb on one captured step
    (copied into its buffers graph by graph), equal to the eager climb;
    500 = 31 blocks of 16 and one of 4."""
    from gcn_maxcut_tpu_torch.baselines import local_search as tls

    _captured_route(monkeypatch)
    rng = np.random.default_rng(max_steps)
    cases = []
    for g in _recipe_graphs(4):
        starts = torch.tensor(rng.integers(0, 3, (4, g.n_pad)))
        starts[:, :3] = torch.arange(3)
        cases.append((g.to(cuda_device), starts.to(cuda_device)))
    tls.clear_climbs()
    captured = [tls.greedy_flip_local_search(g, s, max_steps=max_steps) for g, s in cases]
    assert len(tls._CLIMBS) == 1
    (climb,) = tls._CLIMBS.values()
    assert climb.runner.graph is not None and climb.runner.eager_epochs == 1
    assert climb.runner.replays > 0
    tls.clear_climbs()
    _eager_runner(monkeypatch, tls)
    eager = [tls.greedy_flip_local_search(g, s, max_steps=max_steps) for g, s in cases]
    tls.clear_climbs()
    for (a, c), (b, d) in zip(captured, eager):
        assert torch.equal(a, b) and torch.equal(c, d)


@pytest.mark.cuda
def test_cuda_captured_sa_chains_equal_eager(cuda_device, monkeypatch):
    """R = 8 chains of 1,500 steps (a chunk of 1,024 and one of 476) on one
    set of draws, captured and eager."""
    from gcn_maxcut_tpu_torch.baselines import local_search as tls
    from gcn_maxcut_tpu_torch.baselines.exact import _sa_restart_batch_from_draws

    g = _solver_graph(100, 6, 2).to(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    R, steps = 8, 1500
    draws = (torch.randint(0, 3, (R, g.n_pad), generator=gen, device=cuda_device),
             torch.randint(3, g.n_pad, (R, steps), generator=gen, device=cuda_device),
             torch.randint(0, 3, (R, steps), generator=gen, device=cuda_device),
             torch.rand((R, steps), generator=gen, device=cuda_device))
    tls.clear_climbs()
    asn, cut = _sa_restart_batch_from_draws(g, *draws, 3, 3)
    tls.clear_climbs()
    _eager_runner(monkeypatch, tls)
    asn_e, cut_e = _sa_restart_batch_from_draws(g, *draws, 3, 3)
    tls.clear_climbs()
    assert torch.equal(asn, asn_e) and float(cut) == float(cut_e)


@pytest.mark.cuda
@pytest.mark.parametrize("step_mode", ["per_graph", "batched"])
def test_cuda_make_epoch_fn_k10_equals_k1(cuda_device, monkeypatch, step_mode):
    specs, _ = generate_graph_dataset(4, 100, 100, 6, 8, base_seed=5)
    ds = process_graphs(specs, DataConfig(max_nodes=128))
    batch = pad_graph_batch([ds.graphs[k] for k in sorted(ds.graphs)])
    cfg = TrainingConfig(n_nodes=128, seed=2, learning_rate=1e-2, step_mode=step_mode)
    start = tloop.setup_train_state(cfg, device="cpu").params()

    def run(max_chunk):
        st = tloop.setup_train_state(cfg, params=start, device=cuda_device)
        fn = tloop.make_epoch_fn(cfg, st, max_chunk=max_chunk)
        gen = torch.Generator(device=cuda_device).manual_seed(0)
        losses = np.concatenate([fn(batch, gen, 10), fn(batch, gen, 10)])
        return losses, st.params(), fn.runner

    l10, p10, runner = run(10)
    assert runner.graph is not None and runner.replays == 19
    l1, p1, _ = run(1)
    _eager_runner(monkeypatch, tloop)
    le, pe, eager = run(10)
    assert eager.graph is None
    for losses, params in ((l1, p1), (le, pe)):
        np.testing.assert_array_equal(losses, l10)
        for layer in ("conv1", "conv2"):
            for name in ("w", "b"):
                assert torch.equal(params[layer][name], p10[layer][name])


@pytest.mark.cuda
def test_cuda_halo_step_builders_equal_trainers_and_eager(cuda_device, monkeypatch):
    """On a ring of four shards of the card: each halo trainer's history is
    its builder's captured chunks from the same start, and the same chunks
    run eagerly, bit for bit."""
    ring = make_mesh(devices=[cuda_device] * 4)
    offsets = tgiant.circulant_offsets(4, 15, 0)
    packed = tgb.PackedHaloGiantConfig(d=4, bandwidth=15, epochs=6, epochs_per_call=3)
    p0 = tgiant.packed_params(4096, seed=0, device="cpu")
    plain = tgb.HaloGiantConfig(d=4, dim_embedding=16, hidden_dim=128, epochs=6,
                                epochs_per_call=3, bandwidth=15, block=64)
    q0 = tgiant.plain_params(1024, 16, 128, 3, seed=0, device="cpu")

    def builder_history():
        out = {}
        state = tpgiant.GiantState.create(tgb._blocks(p0, ring, 128), ring,
                                          packed.learning_rate, packed.mu_dtype)
        step, _ = tgb.make_packed_halo_step(ring, offsets, packed, state, 128)
        out["packed"] = np.concatenate([step(), step()])
        state = tpgiant.GiantState.create(tgb._blocks(q0, ring, 256), ring, plain.learning_rate)
        step, _ = tgb.make_halo_giant_step(ring, offsets, plain, state, 256)
        out["plain"] = np.concatenate([step(), step()])
        return out

    trained = {"packed": tgb.train_halo_giant_packed(1024, packed, ring, params=p0),
               "plain": tgb.train_halo_giant(256, plain, ring, params=q0)}
    captured = builder_history()
    _eager_runner(monkeypatch, tchunks)
    eager = builder_history()
    for name in ("packed", "plain"):
        hist = np.asarray(trained[name]["history"], np.float32)
        np.testing.assert_array_equal(captured[name], hist)
        np.testing.assert_array_equal(eager[name], hist)


# The program's spans and counters on the card (utils/profiling.py): a
# capture, the replays after it, and the climbs captured again.

def _profiled_cpu():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


@pytest.mark.cuda
def test_cuda_climb_captures_count_each_recapture(cuda_device, monkeypatch):
    """One more padded shape than the card keeps: after a warm-up cycle
    every climb of a cycle over all of them captures again, and a cycle
    over the kept ones captures none."""
    from gcn_maxcut_tpu_torch.baselines import local_search as tls
    from gcn_maxcut_tpu_torch.utils import profiling

    _captured_route(monkeypatch)
    graphs = [_solver_graph(24 + 8 * i, 4, 3).to(cuda_device)
              for i in range(tls._CLIMBS_KEPT + 1)]
    assert len({g.n_pad for g in graphs}) == len(graphs)
    gen = torch.Generator(device=cuda_device).manual_seed(0)

    def cycle(gs):
        profiling.reset()
        with _profiled_cpu():
            for g in gs:
                starts = torch.randint(0, 3, (4, g.n_pad), generator=gen, device=cuda_device)
                starts[:, :3] = torch.arange(3, device=cuda_device)
                greedy_flip_local_search(g, starts, max_steps=100)
        return profiling.counts()

    tls.clear_climbs()
    try:
        cycle(graphs)                                   # warm-up: the last four kept
        assert cycle(graphs).get("climb.captures") == len(graphs)
        kept = cycle(graphs[1:])
        assert kept.get("climb.captures", 0) == 0 and kept["climb.steps"] > 0
    finally:
        tls.clear_climbs()
        profiling.reset()


@pytest.mark.cuda
@pytest.mark.parametrize("route", ["kernel", "not_symmetric"])
def test_cuda_climb_routes_by_the_graph(cuda_device, route):
    """A symmetric recipe graph climbs in one kernel launch, with no
    capture and no kept climb; a graph that is not symmetric (each edge
    stored one way) takes the captured route.  Both equal the CPU's climb,
    and the counters say which route ran."""
    from gcn_maxcut_tpu_torch.baselines import local_search as tls
    from gcn_maxcut_tpu_torch.utils import profiling

    if route == "kernel":
        g = _recipe_graphs(1)[0]
    else:
        rng = np.random.default_rng(6)
        edges = np.asarray(random_regular_edges(200, 6, 6))
        g = graph_from_edges(edges, 200, weights=rng.integers(1, 4, len(edges)), n_pad=256,
                             symmetrize=False)
        assert not g.symmetric
    starts = torch.tensor(np.random.default_rng(7).integers(0, 3, (4, g.n_pad)))
    starts[:, :3] = torch.arange(3)
    asn, cut = greedy_flip_local_search(g, starts, max_steps=500)
    tls.clear_climbs()
    launched = LAUNCHES["climb"]
    profiling.reset()
    try:
        with _profiled_cpu():
            asn_c, cut_c = greedy_flip_local_search(g.to(cuda_device), starts.to(cuda_device),
                                                    max_steps=500)
        counts = profiling.counts()
        kept = len(tls._CLIMBS)
    finally:
        tls.clear_climbs()
        profiling.reset()
    assert torch.equal(asn_c.cpu(), asn) and torch.equal(cut_c.cpu(), cut)
    assert counts["climb.runs"] == 1 and counts["climb.steps"] > 0
    if route == "kernel":
        assert LAUNCHES["climb"] == launched + 1 and kept == 0
        assert counts["climb.kernel"] == 1 and "climb.captures" not in counts
    else:
        assert LAUNCHES["climb"] == launched and kept == 1
        assert counts["climb.captures"] == 1 and "climb.kernel" not in counts


@pytest.mark.cuda
def test_cuda_a_captured_runner_records_one_capture_then_replays(cuda_device):
    from gcn_maxcut_tpu_torch.train.chunks import ChunkRunner
    from gcn_maxcut_tpu_torch.utils import profiling

    x = torch.zeros((), device=cuda_device)

    def step():
        x.add_(1.0)
        return x * 1.0

    runner = ChunkRunner(step, [cuda_device], 4)
    profiling.reset()
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            losses = np.concatenate([runner.run(k)[0] for k in (4, 4, 2)])
        totals = profiling.span_totals()
    finally:
        profiling.reset()
    np.testing.assert_array_equal(losses, np.arange(1, 11, dtype=np.float32))
    assert runner.replays == 9 and runner.eager_epochs == 1
    assert totals["chunk.capture"]["count"] == 1
    assert totals["chunk.run"]["count"] == totals["chunk.replay"]["count"] == 3
    order = [e.name for e in sorted(prof.events(), key=lambda e: e.time_range.start)
             if str(e.device_type).endswith("CPU") and e.name in ("chunk.capture", "chunk.replay")]
    assert order == ["chunk.capture"] + ["chunk.replay"] * 3


def _sddmm_graphs():
    """One graph of each of the recipe's degrees 6, 7 and 8 (n = 500), made
    together by the recipe's data path: one shared padding (n_pad 504,
    e_pad 4,096), so the d = 6 and d = 7 graphs end in runs of 1,096 and 596
    padded slots."""
    from gcn_maxcut_tpu_torch.data.generate import generate_graph

    specs = [generate_graph(500, d, "reg", seed=40 + d) for d in (6, 7, 8)]
    return process_graphs(specs, DataConfig(max_nodes=1000)).graphs


def _sddmm_runs(g, x, y, de, op):
    """``op``'s scores and its gradients in x and y (one gradient when y is
    x) at cotangent ``de``."""
    xr = x.clone().requires_grad_(True)
    yr = xr if y is x else y.clone().requires_grad_(True)
    e = op(g, xr, yr)
    return (e, *torch.autograd.grad(e, [xr] if yr is xr else [xr, yr], de))


def _assert_sddmm_equals_plain(g, x, y, de):
    """The card's op and its launches against the plain op on the card, bit
    for bit (zeros up to their sign)."""
    before = dict(LAUNCHES)
    got = _sddmm_runs(g, x, y, de, tseg.sddmm)
    assert (LAUNCHES["sddmm"] - before["sddmm"],
            LAUNCHES["sddmm_backward"] - before["sddmm_backward"]) == (1, 1)
    want = _sddmm_runs(g, x, y, de, tseg.sddmm_plain)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype == torch.float32 and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("same", [True, False], ids=["x_is_y", "x_and_y"])
@pytest.mark.parametrize("d", [6, 7, 8])
def test_cuda_sddmm_equals_plain_at_the_recipes_shapes(cuda_device, d, same):
    """``csrc/sddmm.cu`` against the plain op on the card at the recipe's
    shapes (k = 3), scores and gradients bit for bit, for one tensor as x
    and y (the cut loss) and for two."""
    g = _sddmm_graphs()[d - 6].to(cuda_device)
    assert g.n_pad == 504 and g.e_pad == 4096 and int(g.n_edges) == 500 * d
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    x = torch.softmax(torch.randn(g.n_pad, 3, generator=gen, device=cuda_device), dim=-1)
    y = x if same else torch.randn(g.n_pad, 3, generator=gen, device=cuda_device)
    de = torch.randn(g.e_pad, generator=gen, device=cuda_device)
    _assert_sddmm_equals_plain(g, x, y, de)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2, 5, 8, 33, 100])
def test_cuda_sddmm_equals_plain_at_other_widths(cuda_device, k):
    """Rows of other widths: the forward keeps ``torch.sum``'s lane order
    (one to 32 lanes a row, up to four products a lane)."""
    g = _sddmm_graphs()[0].to(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(k)
    x = torch.randn(g.n_pad, k, generator=gen, device=cuda_device)
    y = torch.randn(g.n_pad, k, generator=gen, device=cuda_device)
    _assert_sddmm_equals_plain(g, x, x, torch.randn(g.e_pad, generator=gen, device=cuda_device))
    _assert_sddmm_equals_plain(g, x, y, torch.randn(g.e_pad, generator=gen, device=cuda_device))


@pytest.mark.cuda
def test_cuda_sddmm_on_column_slices_equals_plain(cuda_device):
    """The pairwise variant's k = 1 column slices of one [n_pad, 3] tensor,
    made contiguous by the op: the gradient that reaches the tensor is the
    plain op's."""
    g = _sddmm_graphs()[1].to(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    s0 = torch.softmax(torch.randn(g.n_pad, 3, generator=gen, device=cuda_device), dim=-1)
    de = torch.randn(g.e_pad, generator=gen, device=cuda_device)
    outs = []
    for op in (tseg.sddmm, tseg.sddmm_plain):
        s = s0.clone().requires_grad_(True)
        e = op(g, s[:, 0:1], s[:, 2:3]) + op(g, s[:, 2:3], s[:, 0:1])
        outs.append((e, *torch.autograd.grad(e, [s], de)))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_sddmm_on_a_graph_that_is_not_symmetric_equals_plain(cuda_device):
    """Directed edges with repeats and self loops: a node's out-edges and
    in-edges differ, so the sender-order walk and the row walk differ."""
    rng = np.random.default_rng(9)
    edges = rng.integers(0, 300, (2500, 2))
    g = graph_from_edges(edges, 300, symmetrize=False, e_pad=3072).to(cuda_device)
    assert not g.symmetric and int(g.n_edges) == 2500
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    x = torch.randn(g.n_pad, 3, generator=gen, device=cuda_device)
    y = torch.randn(g.n_pad, 3, generator=gen, device=cuda_device)
    de = torch.randn(g.e_pad, generator=gen, device=cuda_device)
    _assert_sddmm_equals_plain(g, x, x, de)
    _assert_sddmm_equals_plain(g, x, y, de)


@pytest.mark.cuda
def test_cuda_sddmm_on_a_graph_with_no_padded_edges_equals_plain(cuda_device):
    """e_pad equal to the directed edge count: no padded slot, and node
    n_pad - 1 is a real node with real edges."""
    edges = random_regular_edges(512, 6, seed=3)
    g = graph_from_edges(edges, 512, n_pad=512, e_pad=3072).to(cuda_device)
    assert int(g.n_edges) == g.e_pad == 3072 and int(g.sender_ptr[-1]) == 3072
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.softmax(torch.randn(g.n_pad, 3, generator=gen, device=cuda_device), dim=-1)
    y = torch.randn(g.n_pad, 3, generator=gen, device=cuda_device)
    de = torch.randn(g.e_pad, generator=gen, device=cuda_device)
    _assert_sddmm_equals_plain(g, x, x, de)
    _assert_sddmm_equals_plain(g, x, y, de)


@pytest.mark.cuda
def test_cuda_sddmm_on_a_stacked_batchs_graph_equals_plain(cuda_device):
    """A graph taken from a stacked batch on the card (``index``), as the
    trainers take theirs: its tables are views that the op reads as they
    are."""
    graphs = _sddmm_graphs()
    batch = pad_graph_batch([graphs[i] for i in sorted(graphs)]).to(cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(11)
    for i in range(3):
        g = batch.index(i)
        x = torch.softmax(torch.randn(g.n_pad, 3, generator=gen, device=cuda_device), dim=-1)
        _assert_sddmm_equals_plain(g, x, x, torch.randn(g.e_pad, generator=gen,
                                                        device=cuda_device))


@pytest.mark.cuda
def test_cuda_sddmm_rejects_what_it_does_not_take(cuda_device):
    """No fallback on the card: another dtype, a batch, a graph without the
    sender-order table or operands on two devices raise."""
    graphs = _sddmm_graphs()
    g = graphs[0].to(cuda_device)
    x = torch.rand(g.n_pad, 3, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        tseg.sddmm(g, x.double(), x.double())
    with pytest.raises(ValueError, match="float32"):
        tseg.sddmm(g, x, x.half())
    with pytest.raises(ValueError, match="not a batch"):
        tseg.sddmm(pad_graph_batch([graphs[0], graphs[1]]).to(cuda_device), x, x)
    with pytest.raises(ValueError, match="sender-order"):
        tseg.sddmm(dataclasses.replace(g, sender_order=None, sender_ptr=None), x, x)
    with pytest.raises(ValueError, match="one card"):
        tseg.sddmm(g, x, x.cpu())
    with pytest.raises(ValueError, match=r"\[n_pad"):
        tseg.sddmm(g, x[:100], x[:100])


@pytest.mark.cuda
def test_cuda_recipe_captured_epoch_counts_the_sddmm_launches(cuda_device):
    """The recipe's monitored epoch captured in a ``ChunkRunner``: one
    forward and one backward launch a graph step, so 3k of each after
    ``run(k)`` on 3 graphs; the epochs equal the eager ones, which take the
    same kernels."""
    from gcn_maxcut_tpu_torch.train.chunks import ChunkRunner

    batch = _chunk_batch()
    cfg = TrainingConfig(n_nodes=64, number_epochs=12, learning_rate=2e-2, patience=100,
                         epochs_per_call=4)
    start = tloop.setup_train_state(cfg, 3, device="cpu").params()
    runs = []
    for capture in (None, False):
        state = tloop.setup_train_state(cfg, 3, params=start, device=cuda_device)
        es = tloop.init_early_stop_state(state.params())
        gen = torch.Generator(device=cuda_device).manual_seed(cfg.seed + 1)
        epoch = tloop.make_monitored_epoch_fn(
            state, tloop.epoch_inputs(batch.to(cuda_device), cfg), es, gen)
        runner = ChunkRunner(epoch, [cuda_device], 4, capture=capture, generators=[gen])
        before = dict(LAUNCHES)
        losses = runner.run(4)[0]
        torch.cuda.synchronize()
        counts = {k: LAUNCHES[k] - before[k] for k in ("sddmm", "sddmm_backward")}
        assert counts == {"sddmm": 12, "sddmm_backward": 12}
        if capture is None:
            assert runner.replays == 3
            assert runner.captured_launches["sddmm"] == 3
            assert runner.captured_launches["sddmm_backward"] == 3
        runs.append((losses, state.params()))
    np.testing.assert_array_equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1]["conv1"]["w"], runs[1][1]["conv1"]["w"])


# ---- C4: the packed giant's head and cut loss (csrc/group_head.cu) ------------

HEAD_LAUNCHES = ("group_head", "cut_dot", "group_head_backward")


def _head_inputs(device, dtype, n, seed=0):
    """z [n, 16] in ``dtype`` with tied rows (two and three equal largest
    real lanes), b2 [16] (one bias on the three real lanes), the shifts of
    one job's graph."""
    rng = np.random.default_rng(seed)
    z = rng.normal(scale=8.0, size=(n, 16)).astype(np.float32)
    z[10:40, 1] = z[10:40, 0] = np.abs(z[10:40, :3]).max(axis=1) + 1.0
    z[40:60, :3] = 5.0
    z[n - 20:, 2] = z[n - 20:, 0] = np.abs(z[n - 20:, :3]).max(axis=1) + 0.5
    b2 = np.full(16, 0.25, np.float32)
    b2[3:] = rng.normal(size=13)
    return (torch.tensor(z).to(dtype).to(device), torch.tensor(b2).to(device),
            tgiant.circulant_offsets(8, 31, seed))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4096, 1_048_576], ids=["4k", "1m"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_cuda_group_head_matches_the_composition(cuda_device, dtype, n):
    """``csrc/group_head.cu`` against the composition on the card
    (``group_head_cut_plain``, K3 the same kernel), at 4,096 rows and at
    1,048,576 (several rows a thread in the dot and the backward): the
    one-hot bit for bit on every row (ties, terminal rows); the loss's dot
    within 1e-6 relative (the kernel sums exact integer products, the
    composition a float32 dot); z's cotangent within one ulp of its dtype
    (the softmax adjoint p·(G − ⟨G, p⟩) is taken in another order than
    autograd's); b2's gradient, a float32 sum over the rows in another
    order than the composition's, within rtol 1e-5 plus one float32 ulp of
    the sum of its terms' magnitudes (the rows' gradients cancel to a sum
    far smaller than their magnitudes); one launch of each kernel and K3's
    two; a second call the same bits; and three planted faults (the
    softmax adjoint less its ⟨G, p⟩ term, inv_d applied twice, one block's
    partial of b2's gradient lost) each fail that tolerance."""
    from gcn_maxcut_tpu_torch.ops import group_head as tgh

    z0, b20, offsets = _head_inputs(cuda_device, dtype, n)
    inv_d, k, r = 1.0 / 8, 3, 8
    s = tgh.group_head_onehot(z0, b20, inv_d, k)
    class_ok, term = tgh._masks(k, cuda_device)
    h = z0.float() * inv_d + b20
    onehot = tgh.group_onehot(tgh.pin_group_head(tgh.group_softmax(h, class_ok), term), class_ok)
    assert torch.equal(s, onehot.to(dtype))
    assert s[10:40, :2].all() and s[40:60, :3].all() and s[n - 20:, 0].all()
    assert torch.equal(s[:k].float(), torch.eye(16, device=cuda_device)[:k])

    def fwd_bwd(op):
        z, b2 = z0.clone().requires_grad_(True), b20.clone().requires_grad_(True)
        same = op(z, b2, inv_d, k, offsets, r)
        return (same.detach(), *torch.autograd.grad(-(n * 4 - 0.5 * same), [z, b2]))

    tlaunches.reset()
    got = fwd_bwd(tgh.group_head_cut)
    assert {key: v for key, v in LAUNCHES.items() if v} == {
        "group_head": 1, "cut_dot": 1, "group_head_backward": 1, "banded_spmm_unit_packed": 2}
    again = fwd_bwd(tgh.group_head_cut)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    want = fwd_bwd(tgh.group_head_cut_plain)
    assert abs(float(got[0]) - float(want[0])) <= 1e-6 * abs(float(want[0]))
    dz_x, db2_x = tgh.gradient_excess(got[1], got[2], want[1], want[2], inv_d)
    assert dz_x <= 1 and db2_x <= 1
    assert got[1].dtype == dtype and not got[2][k:].any()
    # the tolerance fails a wrong backward: planted faults on the op's gradients
    y = tb.banded_spmm_unit_packed(s, offsets, r).float()
    at = tb.banded_spmm_unit_packed(s, [-o for o in offsets], r).float()
    p = tgh.group_softmax(h, class_ok)
    no_dot = (p * 0.5 * (y + at) * inv_d).to(dtype)     # the adjoint less ⟨G, p⟩
    rows = torch.arange(n, device=cuda_device)
    block0 = (rows // 256) % tgh._grid(n, cuda_device) == 0   # the backward's block 0
    lost = got[2] - (want[1].float() / inv_d)[block0].sum(0)  # that block's partial dropped
    faults = {"adjoint less <G, p>": tgh.gradient_excess(no_dot, got[2], *want[1:], inv_d)[0],
              "inv_d twice": tgh.gradient_excess(got[1] * inv_d, got[2], *want[1:], inv_d)[0],
              "block 0's partial lost": tgh.gradient_excess(got[1], lost, *want[1:], inv_d)[1]}
    print(f"group head {dtype} n={n}: excess dz {dz_x:.3g}, db2 {db2_x:.3g}; planted faults "
          + ", ".join(f"{name} {v:.3g}" for name, v in faults.items()))
    assert all(v > 1 for v in faults.values())


@pytest.mark.cuda
def test_cuda_packed_giant_runs_the_head_op_once_an_epoch(cuda_device, monkeypatch):
    """The packed trainer on the card: one launch of each of the head's
    kernels an epoch, captured, and ``giant_demo.group_onehot`` never
    called; with bfloat16 activations (the benchmark's control) the
    composition and none of the head's launches."""
    calls = []
    real = tgiant.group_onehot

    def counted(pinned, class_ok):
        calls.append(pinned.dtype)
        return real(pinned, class_ok)

    monkeypatch.setattr(tgiant, "group_onehot", counted)
    kw = dict(n=65_536, bandwidth=31, epochs=8, epochs_per_call=4, device=cuda_device)
    tlaunches.reset()
    res = tgiant.train_banded_giant_packed(**kw)
    assert all(LAUNCHES[k] == 8 for k in HEAD_LAUNCHES) and not calls
    assert LAUNCHES["banded_spmm_unit_packed"] == 6 * 8
    assert all(np.isfinite(res["history"]))
    tlaunches.reset()
    tgiant.train_banded_giant_packed(act_dtype="bfloat16", **kw)
    assert all(LAUNCHES[k] == 0 for k in HEAD_LAUNCHES)
    assert calls and set(calls) == {torch.bfloat16}    # the eager and captured epochs' calls
