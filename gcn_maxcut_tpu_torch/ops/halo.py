"""Node-sharded banded SpMM over a ring of devices: the halo exchange, the
hand-written CUDA kernels and their plain PyTorch versions.

Port of ``gcn_maxcut_tpu/ops/pallas_halo.py``.  A banded graph is node-
sharded contiguously over a ``parallel.mesh.Mesh``: shard c holds global
rows [c·m, (c + 1)·m) on ``mesh.devices[c]``, and every offset satisfies
|o| ≤ Wp (the largest |o| rounded up to 8), so the rows a shard needs beyond
its own are the last Wp rows of shard c − 1 and the first Wp rows of shard
c + 1, across the global wrap at the ends.  An op takes and returns a tuple
of per-shard tensors, one on each mesh device:

  * ``halo_exchange`` stages, for each shard, its ``pre`` tile (the last Wp
    rows of shard c − 1) and its ``post`` tile (the first Wp rows of shard
    c + 1) on the shard's device: the sender-staged tiles of the TPU kernel
    (``send_r`` / ``send_l``).  In the packed layout the sender rotates the
    tile that crosses the global wrap by ±F along columns.  On a mesh of one
    shard the tiles are the shard's own rows: exactly the circulant wrap;
  * ``halo_banded_spmm`` (K5): y[i] = Σ_k w[i, k]·win[Wp + i + o_k], with
    win = cat([pre, x, post]), x float32 or bfloat16 [n_shard, F], w float32
    [n_shard, D], summed in float32, output in x's dtype.  Forward only, as
    in JAX;
  * ``halo_banded_spmm_unit``: K5 with unit weights, differentiable: its
    backward is the same op on dy with negated offsets;
  * ``halo_banded_spmm_unit_packed`` (K6): the unit sum on shards of the
    interleaved node order (``ops.banded.pack_interleaved``), run on the
    [n_shard / r, r·F] view, where every node shift is a row shift and only
    the tiles across the global wrap rotate their lane groups.

CUDA shards run one launch per shard after the exchange (the TPU kernel's
overlap of the exchange with the interior sweep is not ported): of
``csrc/halo_stream.cu``, which streams each short strip of a shard's rows
into shared memory in 16-byte pieces (its binding and geometry:
``ops/halo_stream.py``),
where the width and the operands' addresses allow 16-byte copies; else of
the earlier body, the halo mode of ``csrc/banded_window.cu``
(``_window_launch``), which is faster there (F = 3).  CPU shards run the
plain versions; a shard on any other device, or on another device than its
mesh entry, raises.

Deviation from JAX: a mesh of one shard runs the halo kernel on its
loopback tiles.  JAX routes it to the circulant kernels (K4, K3) only
because a loopback RDMA faults the TPU runtime; the function is the same.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from gcn_maxcut_tpu_torch import build
from gcn_maxcut_tpu_torch.ops import halo_stream as hs
from gcn_maxcut_tpu_torch.ops import launches
from gcn_maxcut_tpu_torch.ops.banded import MAX_OFFSETS, padded_bandwidth, tile_shape
from gcn_maxcut_tpu_torch.ops.halo_stream import (  # noqa: F401  (re-exported)
    _DTYPE_CODES,
    HALO_CHUNK,
    HALO_COLS,
    HALO_STRIP,
    HALO_THREADS,
    SMEM_LIMIT,
    HaloStreamGeometry,
    _stream_kernel,
    _vec16,
    halo_stream_shape,
    halo_stream_smem_bytes,
)
from gcn_maxcut_tpu_torch.parallel.mesh import Mesh

DEFAULT_BLOCK = 1024


@functools.cache
def _kernel():
    fn = build.load("banded_window").halo_window_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _weighted_kernel():
    fn = build.load("banded_window").halo_window_weighted_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _check_shard(
    x: torch.Tensor, pre: torch.Tensor, post: torch.Tensor,
    offsets: Sequence[int], w: torch.Tensor | None,
) -> int:
    """One shard's operand rules on the card; returns Wp."""
    if x.device.type != "cuda":
        raise ValueError(f"kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    if x.dim() != 2 or not x.is_contiguous():
        raise ValueError("kernel needs a contiguous 2-D shard")
    m, L = x.shape
    wp = pre.shape[0]
    for t in (pre, post):
        if (t.device != x.device or t.dtype != x.dtype or not t.is_contiguous()
                or tuple(t.shape) != (wp, L)):
            raise ValueError(f"halo tiles must be contiguous [{wp}, {L}] {x.dtype} "
                             f"on {x.device}")
    if not offsets or len(offsets) > MAX_OFFSETS:
        raise ValueError(f"need 1..{MAX_OFFSETS} offsets, got {len(offsets)}")
    if max(abs(o) for o in offsets) > wp:
        raise ValueError(f"an offset exceeds the halo width {wp}")
    if m * L >= 2**31:
        raise ValueError(f"shard [{m}, {L}] too large for 32-bit indexing")
    if w is not None and (
        w.dtype != torch.float32 or w.device != x.device or not w.is_contiguous()
        or tuple(w.shape) != (m, len(offsets))
    ):
        raise ValueError(f"weights must be contiguous float32 [{m}, {len(offsets)}] "
                         f"on {x.device}")
    return wp


def _launch(
    x: torch.Tensor, pre: torch.Tensor, post: torch.Tensor,
    offsets: Sequence[int], w: torch.Tensor | None = None, *, op: str,
) -> torch.Tensor:
    """One shard's launch of ``op`` (a ``launches.LAUNCHES`` key; K5 counts
    its weighted and unit launches together) on a contiguous
    [m, L] CUDA tensor and its [Wp, L] tiles, with a float32 [m, D] weight
    table or (``w`` None) unit weights: ``halo_stream_launch`` in
    ``halo_stream_shape``'s geometry where the shard takes 16-byte copies
    (``_vec16``), else the earlier body ``_window_launch``, which beat a
    scalar path of the new kernel at F = 3 (PERF.md).  One rule by shape
    and address: a failed launch raises."""
    _check_shard(x, pre, post, offsets, w)
    if not _vec16(x.shape[1], x.element_size(), x, pre, post):
        return _window_launch(x, pre, post, offsets, w, op=op)
    out = hs.launch(x, pre, post, offsets, w)
    launches.LAUNCHES[op] += 1
    return out


def _window_launch(
    x: torch.Tensor, pre: torch.Tensor, post: torch.Tensor,
    offsets: Sequence[int], w: torch.Tensor | None = None, *, op: str,
) -> torch.Tensor:
    """The earlier body, the halo mode of ``csrc/banded_window.cu``:
    ``halo_window_launch``, or with weights ``halo_window_weighted_launch``;
    the same operands and result as ``_launch``, counted under ``op`` +
    "_window"."""
    wp = _check_shard(x, pre, post, offsets, w)
    m, L = x.shape
    rows, cols = tile_shape(L, wp, x.element_size(), 0 if w is None else 4 * len(offsets))
    out = torch.empty_like(x)
    offs = (ctypes.c_int * len(offsets))(*offsets)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if w is None:
            err = _kernel()(
                x.data_ptr(), pre.data_ptr(), post.data_ptr(), out.data_ptr(), m, L,
                offs, len(offsets), wp, _DTYPE_CODES[x.dtype], rows, cols, stream,
            )
        else:
            err = _weighted_kernel()(
                x.data_ptr(), pre.data_ptr(), post.data_ptr(), w.data_ptr(),
                out.data_ptr(), m, L, offs, len(offsets), wp, _DTYPE_CODES[x.dtype],
                rows, cols, stream,
            )
    if err != 0:
        raise RuntimeError(f"halo_window launch failed: CUDA error {err}")
    launches.LAUNCHES[op + "_window"] += 1
    return out


# ---- the exchange and the plain versions --------------------------------

def halo_exchange(
    xs: Sequence[torch.Tensor], wp: int, mesh: Mesh, lane_group: int | None = None
) -> tuple[tuple[torch.Tensor, torch.Tensor], ...]:
    """(pre, post) for each shard c, on ``mesh.devices[c]``: the last ``wp``
    rows of shard c − 1 and the first ``wp`` rows of shard c + 1 (mod the
    mesh size).  With ``lane_group`` F (the packed layout) the sender of a
    tile across the global wrap rotates it along columns: the last shard's
    last rows by +F, the first shard's first rows by −F.  Differentiable."""
    D = mesh.size
    tiles = []
    for c, dev in enumerate(mesh.devices):
        left, right = xs[(c - 1) % D], xs[(c + 1) % D]
        pre, post = left[left.shape[0] - wp:], right[:wp]
        if lane_group is not None and c == 0:
            pre = torch.roll(pre, lane_group, dims=1)
        if lane_group is not None and c == D - 1:
            post = torch.roll(post, -lane_group, dims=1)
        tiles.append((pre.to(dev).contiguous(), post.to(dev).contiguous()))
    return tuple(tiles)


def halo_banded_spmm_plain(
    x: torch.Tensor, w: torch.Tensor | None, pre: torch.Tensor, post: torch.Tensor,
    offsets: Sequence[int],
) -> torch.Tensor:
    """One shard: Σ_k w[:, k]·win[Wp + o_k : Wp + o_k + m] with win =
    cat([pre, x, post]) and Wp the tiles' row count, summed in float32 in
    offset order from zero, cast to x's dtype; ``w`` None means unit weights."""
    m, wp = x.shape[0], pre.shape[0]
    win = torch.cat([pre, x, post]).float()
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for k, o in enumerate(offsets):
        rows = win[wp + o: wp + o + m]
        acc = acc + (rows if w is None else w[:, k: k + 1] * rows)
    return acc.to(x.dtype)


def halo_banded_spmm_unit_packed_plain(
    p: torch.Tensor, pre: torch.Tensor, post: torch.Tensor, offsets: Sequence[int]
) -> torch.Tensor:
    """One shard of the packed [m_loc, r·F] view: the unit sum over
    cat([pre, p, post]) (the counterpart of ``_packed_halo_xla``, with the
    sum in float32 as the kernel takes it)."""
    return halo_banded_spmm_plain(p, None, pre, post, offsets)


def halo_ring_plain(
    xs: Sequence[torch.Tensor], offsets: Sequence[int], mesh: Mesh,
    r: int | None = None, ws: Sequence[torch.Tensor] | None = None,
) -> tuple[torch.Tensor, ...]:
    """The plain version of a whole ring op on shards of any device: the
    exchange, then ``halo_banded_spmm_plain`` on each shard; differentiable
    through PyTorch ops.  ``r`` None: K5 (``ws`` None for unit weights);
    else K6 on the packed layout."""
    return _ring_sum(xs, tuple(int(o) for o in offsets), mesh, r, ws, plain=True)


# ---- dispatch: plain on the CPU, the kernel on CUDA ----------------------

def _check_shards(xs: Sequence[torch.Tensor], mesh: Mesh) -> None:
    if len(xs) != mesh.size:
        raise ValueError(f"{len(xs)} shards for a mesh of {mesh.size}")
    for c, x in enumerate(xs):
        if x.device != mesh.devices[c]:
            raise ValueError(f"shard {c} is on {x.device}, its mesh device is "
                             f"{mesh.devices[c]}")
        if x.device.type not in ("cpu", "cuda"):
            raise ValueError(f"shards must be on the CPU or CUDA, got {x.device}")
        if x.shape != xs[0].shape or x.dtype != xs[0].dtype:
            raise ValueError("every shard must have one shape and dtype")


def _ring_sum(
    xs: Sequence[torch.Tensor], offsets: tuple[int, ...], mesh: Mesh,
    r: int | None = None, ws: Sequence[torch.Tensor] | None = None,
    plain: bool = False,
) -> tuple[torch.Tensor, ...]:
    """Exchange, then one sum per shard.  ``r`` None: the node layout (K5);
    else the packed layout (K6), on each shard's [n/r, r·F] view."""
    n_loc, F = xs[0].shape
    wp = padded_bandwidth(offsets)
    views = [x.contiguous() if r is None else x.contiguous().view(n_loc // r, r * F)
             for x in xs]
    op = "halo_banded_spmm" if r is None else "halo_banded_spmm_unit_packed"
    tiles = halo_exchange(views, wp, mesh, None if r is None else F)
    outs = []
    for c, ((pre, post), v) in enumerate(zip(tiles, views)):
        w = None if ws is None else ws[c]
        if plain or v.device.type == "cpu":
            y = halo_banded_spmm_plain(v, w, pre, post, offsets)
        else:
            y = _launch(v, pre, post, offsets, None if w is None else w.contiguous(), op=op)
        outs.append(y.view(n_loc, F))
    return tuple(outs)


class _HaloUnit(torch.autograd.Function):
    """The unit-weight ring sum over all shards at once; the adjoint of a
    shift set is the negated set, in the same layout (and, packed, with the
    same sender-side rotation)."""

    @staticmethod
    def forward(ctx, offsets, mesh, r, *xs):
        ctx.offsets, ctx.mesh, ctx.r = offsets, mesh, r
        ctx.like = [(x.shape, x.dtype, x.device) for x in xs]
        return _ring_sum(xs, offsets, mesh, r)

    @staticmethod
    def backward(ctx, *dys):
        dys = [torch.zeros(s, dtype=t, device=d) if dy is None else dy
               for dy, (s, t, d) in zip(dys, ctx.like)]
        neg = tuple(-o for o in ctx.offsets)
        return (None, None, None, *_ring_sum(dys, neg, ctx.mesh, ctx.r))


def _check_block(n_shard: int, wp: int, block: int) -> None:
    if n_shard % block:
        raise ValueError(f"n_shard={n_shard} must be a multiple of {block}")
    if block % 8:
        raise ValueError(f"block={block} must be a multiple of 8")
    if wp > block:
        raise ValueError(f"bandwidth (padded {wp}) must be <= block={block}")


def halo_banded_spmm(
    xs: Sequence[torch.Tensor], ws: Sequence[torch.Tensor], offsets: Sequence[int],
    mesh: Mesh, block: int = DEFAULT_BLOCK,
) -> tuple[torch.Tensor, ...]:
    """K5: per shard y = Σ_k w[:, k]·(rows shifted by o_k across the ring),
    on x [n_shard, F] float32 or bfloat16 and w [n_shard, D] float32.

    Replaces ``pallas_halo.halo_banded_spmm``, with its checks
    (n_shard % block == 0, block % 8 == 0, Wp ≤ block); ``block`` is
    otherwise unused: the kernel tiles rows itself.  Forward only, as in
    JAX: it raises on inputs that require a gradient.
    """
    offsets = tuple(int(o) for o in offsets)
    _check_shards(xs, mesh)
    _check_block(xs[0].shape[0], padded_bandwidth(offsets), block)
    for c, w in enumerate(ws):
        if w.device != mesh.devices[c] or w.dtype != torch.float32 or (
                tuple(w.shape) != (xs[0].shape[0], len(offsets))):
            raise ValueError(f"weights of shard {c} must be float32 "
                             f"[{xs[0].shape[0]}, {len(offsets)}] on {mesh.devices[c]}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (*xs, *ws)):
        raise ValueError("halo_banded_spmm is forward only; differentiate "
                         "halo_banded_spmm_unit")
    return _ring_sum(xs, offsets, mesh, ws=ws)


def halo_banded_spmm_unit(
    xs: Sequence[torch.Tensor], offsets: Sequence[int], mesh: Mesh,
    block: int = DEFAULT_BLOCK,
) -> tuple[torch.Tensor, ...]:
    """K5 with unit weights, differentiable in every shard.

    Replaces ``pallas_halo.halo_banded_spmm_unit``; checks as
    ``halo_banded_spmm``.
    """
    offsets = tuple(int(o) for o in offsets)
    _check_shards(xs, mesh)
    _check_block(xs[0].shape[0], padded_bandwidth(offsets), block)
    return _HaloUnit.apply(offsets, mesh, None, *xs)


def halo_banded_spmm_unit_packed(
    xs: Sequence[torch.Tensor], offsets: Sequence[int], r: int, mesh: Mesh,
    block: int | None = None,
) -> tuple[torch.Tensor, ...]:
    """K6: the unit ring sum on shards [n_loc, F] of the interleaved node
    order, differentiable in every shard.

    Replaces ``pallas_halo.halo_banded_spmm_unit_packed``.  Needs
    n_loc % r == 0 and Wp ≤ n_loc / r (a halo tile lies in one neighbour).
    ``block`` is accepted for the JAX signature and unused: the kernel tiles
    rows itself, at any width (no lane padding and no fallback path).
    """
    offsets = tuple(int(o) for o in offsets)
    r = int(r)
    _check_shards(xs, mesh)
    n_loc = xs[0].shape[0]
    if n_loc % r:
        raise ValueError(f"n_loc={n_loc} must be a multiple of r={r}")
    wp = padded_bandwidth(offsets)
    if wp > n_loc // r:
        raise ValueError(f"bandwidth (padded {wp}) exceeds the {n_loc // r} packed "
                         "rows of a shard")
    return _HaloUnit.apply(offsets, mesh, r, *xs)
