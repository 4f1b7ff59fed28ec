"""Banded (circulant) SpMM: the hand-written CUDA kernel and its plain
PyTorch versions.

Port of ``gcn_maxcut_tpu/ops/pallas_banded.py``:

  * ``banded_spmm_unit`` (K2): y[i] = Σ_k x[(i + o_k) mod n];
  * ``banded_spmm`` (K4): y[i] = Σ_k w[i, k]·x[(i + o_k) mod n], float32
    x [n, F] and w [n, D] only (the JAX contract), differentiable in x and
    w; the "mxu" and "vpu" modes both compute exact float32 here.  Its dx
    is the kernel on dy with negated offsets and each w_k rolled by +o_k;
    its dw stays PyTorch ops, as it was XLA outside the Pallas kernel;
  * ``banded_spmm_unit_packed`` (K3): the same sum on arrays stored in the
    interleaved node order (``pack_interleaved``: node u·m + j at position
    j·r + u), where every node shift is a row shift of the [m, r·F] view
    and only the wrap rows rotate their lane groups by F.

On CUDA tensors K2 and K3 run ``csrc/halo_stream.cu`` as a one-shard
ring (``_circulant_launch``): the circulant wrap is staged as two [Wp, L]
tiles, as the TPU kernel stages it (K2: the views x[m - Wp:] and x[:Wp];
K3: those rows of the [m, r·F] view with their lane groups rotated by ±F),
and the kernel sums pure row shifts of x and the tiles.  K4 runs
``csrc/banded_stream.cu``, which streams each strip of rows through a
shared-memory ring once (geometry: ``stream_shape``); its column-weight
mode (``_stream_call(cols=True)``) runs P5a, K4's function on [D, n]
weights (``ops/probe_kernels.banded_spmm_cols``).  Both take only
rows of whole 16-byte pieces with 16-byte aligned operands; anything else
(F = 3 float32, a misaligned view) runs the earlier body,
``csrc/banded_window.cu`` (``_launch``), by that one rule of shape and
address.  CPU tensors take the plain versions; a tensor on any other
device raises.  The unit ops take float32 or bfloat16; sums are taken in
float32 and the output has the input's dtype.
The unit ops are differentiable: the adjoint of a circulant shift set is
the negated set, so the backward is the same kernel with negated offsets.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Sequence

import torch

from gcn_maxcut_tpu_torch import build
from gcn_maxcut_tpu_torch.ops import halo_stream as hs
from gcn_maxcut_tpu_torch.ops import launches
from gcn_maxcut_tpu_torch.ops.halo_stream import _DTYPE_CODES, SMEM_LIMIT, _vec16

MAX_OFFSETS = 32            # csrc/banded_window.cu BANDED_MAX_OFFSETS
_TILE_BYTES = 96 * 1024     # shared memory for one block's window
_TILE_ROWS_MAX = 256
_TILE_COLS_MAX = 128
# K4's streaming geometry (csrc/banded_stream.cu): rows a chunk, widest
# column tile, longest strip, and the blocks below which strips shorten;
# chosen on the H100 at n = 131,072 and 1,250,304, F = 128 (PERF.md)
STREAM_CHUNK = 64
STREAM_COLS = 64
STREAM_STRIP_MAX = 1024
STREAM_MIN_BLOCKS = 256
STREAM_THREADS = 256          # csrc/banded_stream.cu BSTREAM_THREADS


def padded_bandwidth(offsets: Sequence[int]) -> int:
    """Wp: the largest |offset| rounded up to a multiple of 8."""
    w = max(abs(int(o)) for o in offsets)
    return (w + 7) // 8 * 8


def tile_shape(L: int, wp: int, elsize: int, row_bytes: int = 0) -> tuple[int, int]:
    """(rows, cols) of one block's output tile; the staged window is
    (rows + 2·wp) × cols elements and, with ``row_bytes`` more for each
    row (K4's weights, after a 16-byte alignment), fits ``_TILE_BYTES``."""
    cols = min(L, _TILE_COLS_MAX)
    slack = 16 if row_bytes else 0
    fit = (_TILE_BYTES - slack - 2 * wp * cols * elsize) // (cols * elsize + row_bytes)
    rows = min(_TILE_ROWS_MAX, fit // 32 * 32)
    if rows < 32:
        raise ValueError(f"bandwidth {wp} too wide for the kernel's window")
    return rows, cols


@dataclasses.dataclass(frozen=True)
class StreamGeometry:
    """K4's launch: a block of ``STREAM_THREADS`` threads owns ``cols``
    columns and a strip of ``strip`` rows, walked in chunks of ``chunk``
    rows through a ring of ``ring_rows`` = 2·chunk + 2·Wp source rows (the
    current chunk's window and the next chunk's new rows) beside two
    chunks' [chunk, D] weights.  A thread owns 4 adjacent columns:
    16-byte copies, loads and stores."""

    n: int
    F: int
    wp: int
    chunk: int
    strip: int
    cols: int
    ring_rows: int
    smem_bytes: int

    @property
    def grid(self) -> tuple[int, int]:
        """(strips, column tiles) of the launch."""
        return -(-self.n // self.strip), -(-self.F // self.cols)


def stream_smem_bytes(ring_rows: int, cols: int, D: int) -> int:
    """The ring (rounded up to 16 bytes) and two chunks of weights."""
    return (ring_rows * cols * 4 + 15) // 16 * 16 + 2 * STREAM_CHUNK * D * 4


@functools.cache
def stream_shape(n: int, F: int, wp: int, D: int) -> StreamGeometry:
    """K4's launch geometry for float32 x [n, F] whose rows are whole
    16-byte pieces (F % 4 == 0), Wp and D offsets.  The column tile is
    halved from ``STREAM_COLS`` until the ring fits; the strip is the
    longest multiple of the chunk up to ``STREAM_STRIP_MAX`` that still
    launches ``STREAM_MIN_BLOCKS`` blocks, and at least one chunk."""
    if F % 4:
        raise ValueError(f"rows of {F} floats are not whole 16-byte pieces")
    chunk = STREAM_CHUNK
    cols = max(4, min(F, STREAM_COLS) // 4 * 4)
    ring_rows = 2 * chunk + 2 * wp
    while stream_smem_bytes(ring_rows, cols, D) > SMEM_LIMIT and cols > 4:
        cols = max(4, cols // 2 // 4 * 4)
    smem = stream_smem_bytes(ring_rows, cols, D)
    if smem > SMEM_LIMIT:
        raise ValueError(f"a ring of {ring_rows} rows does not fit the block's shared memory")
    strips_wanted = -(-STREAM_MIN_BLOCKS // -(-F // cols))
    strip = max(1, min(STREAM_STRIP_MAX // chunk, n // (chunk * strips_wanted))) * chunk
    return StreamGeometry(n=n, F=F, wp=wp, chunk=chunk, strip=strip, cols=cols,
                          ring_rows=ring_rows, smem_bytes=smem)


@functools.cache
def _kernel():
    fn = build.load("banded_window").banded_window_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _weighted_kernel():
    fn = build.load("banded_window").banded_window_weighted_launch
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _stream_kernel(entry: str = "banded_stream_launch"):
    """K4's C entry point, or P5a's ``banded_stream_cols_launch``: the
    same arguments, the weights [n, D] or [D, n]."""
    fn = getattr(build.load("banded_stream"), entry)
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.POINTER(ctypes.c_int), ctypes.c_int,
        *[ctypes.c_int] * 6, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _check_weighted(x: torch.Tensor, w: torch.Tensor, offsets: Sequence[int]) -> int:
    """K4's operand rules on the card; returns Wp."""
    if x.device.type != "cuda":
        raise ValueError(f"kernel needs a CUDA tensor, got {x.device}")
    if (x.dtype != torch.float32 or w.dtype != torch.float32 or w.device != x.device
            or x.dim() != 2 or tuple(w.shape) != (x.shape[0], len(offsets))):
        raise ValueError("weighted kernel takes float32 x [n, F] and w [n, len(offsets)] "
                         "on one device")
    if not x.is_contiguous() or not w.is_contiguous():
        raise ValueError("kernel needs contiguous tensors")
    if not offsets or len(offsets) > MAX_OFFSETS:
        raise ValueError(f"need 1..{MAX_OFFSETS} offsets, got {len(offsets)}")
    n, F = x.shape
    if n * F >= 2**31:
        raise ValueError(f"bad shape [{n}, {F}]")
    wp = padded_bandwidth(offsets)
    if 2 * wp > n:
        raise ValueError(f"2*Wp = {2 * wp} exceeds the {n} rows")
    return wp


def _stream_call(x: torch.Tensor, w: torch.Tensor, offsets: Sequence[int], wp: int, *,
                 cols: bool = False) -> torch.Tensor:
    """One launch of ``banded_stream.cu`` in ``stream_shape``'s geometry on
    checked contiguous float32 operands on the card: K4's weights w [n, D],
    or with ``cols`` P5a's column-major wc [D, n].  x's rows must be whole
    16-byte pieces and x 16-byte aligned (``_vec16``): the kernel refuses
    anything else.  Raises if the launch fails; the caller counts it."""
    n, F = x.shape
    geom = stream_shape(n, F, wp, len(offsets))
    out = torch.empty_like(x)
    offs = (ctypes.c_int * len(offsets))(*[int(o) for o in offsets])
    entry = "banded_stream_cols_launch" if cols else "banded_stream_launch"
    with torch.cuda.device(x.device):
        err = _stream_kernel(entry)(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), n, F, offs, len(offsets), wp,
            geom.chunk, geom.strip, geom.cols, geom.ring_rows, geom.smem_bytes,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"{entry} failed: CUDA error {err}")
    return out


def _stream_launch(x: torch.Tensor, w: torch.Tensor, offsets: Sequence[int]) -> torch.Tensor:
    """K4: ``banded_stream_launch`` on contiguous float32 x [n, F] and
    w [n, D] on the card, counted under "banded_spmm"."""
    out = _stream_call(x, w, offsets, _check_weighted(x, w, offsets))
    launches.LAUNCHES["banded_spmm"] += 1
    return out


def _check_unit(x: torch.Tensor, offsets: Sequence[int], F: int) -> int:
    """The operand rules of a launch on a [m, L] CUDA tensor of lane groups
    of F columns; returns Wp."""
    if x.device.type != "cuda":
        raise ValueError(f"kernel needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise ValueError(f"kernel takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous() or x.dim() != 2:
        raise ValueError("kernel needs a contiguous 2-D tensor")
    m, L = x.shape
    if not offsets or len(offsets) > MAX_OFFSETS:
        raise ValueError(f"need 1..{MAX_OFFSETS} offsets, got {len(offsets)}")
    if L % F or m * L >= 2**31:
        raise ValueError(f"bad shape [{m}, {L}] for lane group {F}")
    wp = padded_bandwidth(offsets)
    if 2 * wp > m:
        raise ValueError(f"2*Wp = {2 * wp} exceeds the {m} rows")
    return wp


def wrap_tiles(x: torch.Tensor, wp: int, F: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The circulant wrap of [m, L] x as a one-shard ring's (pre, post)
    tiles: the last and the first Wp rows.  In the packed layout (L = r·F,
    r > 1) a node shift across the wrap also moves one lane group, so the
    tiles are rotated by +F and −F along columns: the TPU kernel's
    ``wrap_lo`` and ``wrap_hi``.  At r = 1 they are views of x."""
    pre, post = x[x.shape[0] - wp:], x[:wp]
    if x.shape[1] != F:
        pre, post = torch.roll(pre, F, dims=1), torch.roll(post, -F, dims=1)
    return pre, post


def _circulant_launch(x: torch.Tensor, offsets: Sequence[int], F: int, *, op: str) -> torch.Tensor:
    """K2 and K3 on ``csrc/halo_stream.cu``: the wrap tiles
    (``wrap_tiles``), then one launch of the one-shard ring on a contiguous
    [m, L] CUDA tensor whose rows are whole 16-byte pieces, 16-byte
    aligned, counted under ``op``."""
    wp = _check_unit(x, offsets, F)
    pre, post = wrap_tiles(x, wp, F)
    out = hs.launch(x, pre, post, offsets)
    launches.LAUNCHES[op] += 1
    return out


def _launch(
    x: torch.Tensor, offsets: Sequence[int], F: int, w: torch.Tensor | None = None, *,
    op: str,
) -> torch.Tensor:
    """The earlier body, ``csrc/banded_window.cu``: ``banded_window_launch``
    on a contiguous [m, L] CUDA tensor, or with a [m, D] weight table
    ``banded_window_weighted_launch`` (float32, L = F), counted under
    ``op`` + "_window"."""
    wp = _check_unit(x, offsets, F)
    if w is not None and (
        x.dtype != torch.float32 or w.dtype != torch.float32 or w.device != x.device
        or not w.is_contiguous() or tuple(w.shape) != (x.shape[0], len(offsets))
        or x.shape[1] != F
    ):
        raise ValueError("weighted kernel takes float32 x [n, F] and w [n, len(offsets)] "
                         "on one device")
    m, L = x.shape
    rows, cols = tile_shape(L, wp, x.element_size(), 0 if w is None else 4 * len(offsets))
    out = torch.empty_like(x)
    offs = (ctypes.c_int * len(offsets))(*[int(o) for o in offsets])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if w is None:
            err = _kernel()(
                x.data_ptr(), out.data_ptr(), m, L, F, offs, len(offsets), wp,
                _DTYPE_CODES[x.dtype], rows, cols, stream,
            )
        else:
            err = _weighted_kernel()(
                x.data_ptr(), w.data_ptr(), out.data_ptr(), m, F, offs,
                len(offsets), wp, rows, cols, stream,
            )
    if err != 0:
        raise RuntimeError(f"banded_window_launch failed: CUDA error {err}")
    launches.LAUNCHES[op + "_window"] += 1
    return out


# ---- plain versions ------------------------------------------------------

def banded_spmm_unit_plain(x: torch.Tensor, offsets: Sequence[int]) -> torch.Tensor:
    """Σ_k roll(x, -o_k) along rows, summed in float32 in offset order, cast
    back to x's dtype."""
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    xf = x.float()
    for o in offsets:
        out = out + torch.roll(xf, -int(o), dims=0)
    return out.to(x.dtype)


def banded_spmm_plain(
    x: torch.Tensor, w: torch.Tensor, offsets: Sequence[int]
) -> torch.Tensor:
    """Σ_k w[:, k]·roll(x, -o_k) along rows, summed in offset order."""
    out = torch.zeros_like(x)
    for k, o in enumerate(offsets):
        out = out + w[:, k : k + 1] * torch.roll(x, -int(o), dims=0)
    return out


def pack_interleaved(x: torch.Tensor, r: int) -> torch.Tensor:
    """Reorder nodes so node u·m + j lands at position j·r + u (m = n/r)."""
    n, F = x.shape
    if n % r:
        raise ValueError(f"n={n} must be a multiple of r={r}")
    return x.reshape(r, n // r, F).transpose(0, 1).reshape(n, F)


def unpack_interleaved(x: torch.Tensor, r: int) -> torch.Tensor:
    """Inverse of ``pack_interleaved``."""
    n, F = x.shape
    if n % r:
        raise ValueError(f"n={n} must be a multiple of r={r}")
    return x.reshape(n // r, r, F).transpose(0, 1).reshape(n, F)


def banded_spmm_unit_packed_plain(
    x: torch.Tensor, offsets: Sequence[int], r: int
) -> torch.Tensor:
    """``pack(plain(unpack(x)))``: the packed op through node order."""
    return pack_interleaved(
        banded_spmm_unit_plain(unpack_interleaved(x, r), offsets), r
    )


# ---- dispatch: plain on the CPU, the kernel on CUDA ----------------------

def _unit_route(x: torch.Tensor, offsets: tuple[int, ...], F: int, op: str) -> torch.Tensor:
    """One rule by shape and address: a contiguous [m, L] CUDA tensor whose
    rows are whole 16-byte pieces and that starts 16-byte aligned runs
    ``halo_stream.cu`` (its wrap tiles are then aligned too), anything else
    the earlier body.  A failed launch raises."""
    if _vec16(x.shape[1], x.element_size(), x):
        return _circulant_launch(x, offsets, F, op=op)
    return _launch(x, offsets, F, op=op)


def _unit_raw(x: torch.Tensor, offsets: tuple[int, ...]) -> torch.Tensor:
    if x.device.type == "cpu":
        return banded_spmm_unit_plain(x, offsets)
    return _unit_route(x.contiguous(), offsets, x.shape[1], "banded_spmm_unit")


def _packed_raw(x: torch.Tensor, offsets: tuple[int, ...], r: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return banded_spmm_unit_packed_plain(x, offsets, r)
    n, F = x.shape
    if n % r:
        raise ValueError(f"n={n} must be a multiple of r={r}")
    out = _unit_route(x.contiguous().view(n // r, r * F), offsets, F,
                      "banded_spmm_unit_packed")
    return out.view(n, F)


def _weighted_raw(x: torch.Tensor, w: torch.Tensor, offsets: tuple[int, ...]) -> torch.Tensor:
    """K4 by the same rule: 16-byte rows and an aligned x run
    ``banded_stream.cu``, anything else (F = 3) the earlier body, which beat
    the ring's scalar path there (PERF.md)."""
    if x.device.type == "cpu":
        return banded_spmm_plain(x, w, offsets)
    x, w = x.contiguous(), w.contiguous()
    if _vec16(x.shape[1], x.element_size(), x):
        return _stream_launch(x, w, offsets)
    return _launch(x, offsets, x.shape[1], w, op="banded_spmm")


class _BandedUnit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, offsets):
        ctx.offsets = offsets
        return _unit_raw(x, offsets)

    @staticmethod
    def backward(ctx, dy):
        return _unit_raw(dy, tuple(-o for o in ctx.offsets)), None


class _BandedUnitPacked(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, offsets, r):
        ctx.offsets, ctx.r = offsets, r
        return _packed_raw(x, offsets, r)

    @staticmethod
    def backward(ctx, dy):
        neg = tuple(-o for o in ctx.offsets)
        return _packed_raw(dy, neg, ctx.r), None, None


class _Banded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, offsets):
        ctx.save_for_backward(x, w)
        ctx.offsets = offsets
        return _weighted_raw(x, w, offsets)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        offsets = ctx.offsets
        dx = dw = None
        if ctx.needs_input_grad[0]:
            # Aᵀ = Σ_k S_{-o_k} diag(w_k): negated offsets, w_k rolled by +o_k
            w_t = torch.stack([torch.roll(w[:, k], o) for k, o in enumerate(offsets)], dim=1)
            dx = _weighted_raw(dy.contiguous(), w_t, tuple(-o for o in offsets))
        if ctx.needs_input_grad[1]:
            # dL/dw[i, k] = <dy[i], x[(i + o_k) mod n]>
            dw = torch.stack(
                [torch.sum(dy * torch.roll(x, -o, dims=0), dim=1) for o in offsets], dim=1
            )
        return dx, dw, None


def banded_spmm(
    x: torch.Tensor,
    w: torch.Tensor,
    offsets: Sequence[int],
    block: int | None = None,
    mode: str = "mxu",
) -> torch.Tensor:
    """y[i] = Σ_k w[i, k]·x[(i + o_k) mod n] on float32 x [n, F] and
    w [n, D]; differentiable in x and w.

    Replaces ``pallas_banded.banded_spmm``.  ``block`` is checked as the JAX
    package checks it (n % block == 0, max |o| ≤ block) and otherwise
    unused: the kernel tiles rows itself.  CUDA tensors need 2·Wp ≤ n.
    """
    if mode not in ("mxu", "vpu"):
        raise ValueError(f"mode must be 'mxu' or 'vpu', got {mode!r}")
    if x.dtype != torch.float32:
        raise ValueError("weighted banded_spmm requires float32 features")
    n = x.shape[0]
    W = max(abs(int(o)) for o in offsets)
    if block is not None and n % block:
        raise ValueError(f"n={n} must be a multiple of block={block}")
    if W > n:
        raise ValueError(f"bandwidth {W} exceeds n={n}")
    if block is not None and W > block:
        raise ValueError(f"bandwidth {W} must be <= block={block}")
    return _Banded.apply(x, w, tuple(int(o) for o in offsets))


def banded_spmm_unit(x: torch.Tensor, offsets: Sequence[int]) -> torch.Tensor:
    """y[i] = Σ_k x[(i + o_k) mod n] on x [n, F] (float32 or bfloat16).

    Replaces ``pallas_banded.banded_spmm_unit``.  CUDA tensors need
    2·Wp ≤ n, with Wp the largest |offset| rounded up to 8.
    """
    return _BandedUnit.apply(x, tuple(int(o) for o in offsets))


def banded_spmm_unit_packed(
    x: torch.Tensor, offsets: Sequence[int], r: int
) -> torch.Tensor:
    """Unit-weight circulant SpMM on x [n, F] stored in interleaved node
    order: y_pos(i) = Σ_k x_pos((i + o_k) mod n).

    Replaces ``pallas_banded.banded_spmm_unit_packed``.  CUDA tensors need
    n % r == 0 and 2·Wp ≤ n / r.
    """
    return _BandedUnitPacked.apply(x, tuple(int(o) for o in offsets), int(r))
