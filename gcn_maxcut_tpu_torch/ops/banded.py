"""Unit-weight banded (circulant) SpMM: the hand-written CUDA kernel and its
plain PyTorch version.

Port of ``gcn_maxcut_tpu/ops/pallas_banded.py`` (unit-weight paths only):

  * ``banded_spmm_unit`` (K2): y[i] = Σ_k x[(i + o_k) mod n];
  * ``banded_spmm_unit_packed`` (K3): the same sum on arrays stored in the
    interleaved node order (``pack_interleaved``: node u·m + j at position
    j·r + u), where every node shift is a row shift of the [m, r·F] view
    and only the wrap rows rotate their lane groups by F.

Both run ``csrc/banded_window.cu`` on CUDA tensors (K2 is the kernel at
r = 1) and their plain versions on CPU tensors; a tensor on any other device
raises.  Inputs may be float32 or bfloat16; sums are taken in float32 and the
output has the input's dtype.  Both ops are differentiable: the adjoint of a
circulant shift set is the negated set, so the backward is the same kernel
with negated offsets.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from gcn_maxcut_tpu_torch import build

# Launches of the CUDA kernel made by each op, counted where it launches.
LAUNCHES = {"banded_spmm_unit": 0, "banded_spmm_unit_packed": 0}

MAX_OFFSETS = 32            # csrc/banded_window.cu BANDED_MAX_OFFSETS
_TILE_BYTES = 96 * 1024     # shared memory for one block's window
_TILE_ROWS_MAX = 256
_TILE_COLS_MAX = 128
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def padded_bandwidth(offsets: Sequence[int]) -> int:
    """Wp: the largest |offset| rounded up to a multiple of 8."""
    w = max(abs(int(o)) for o in offsets)
    return (w + 7) // 8 * 8


def tile_shape(L: int, wp: int, elsize: int) -> tuple[int, int]:
    """(rows, cols) of one block's output tile; the staged window is
    (rows + 2·wp) × cols elements and fits ``_TILE_BYTES``."""
    cols = min(L, _TILE_COLS_MAX)
    fit = _TILE_BYTES // (cols * elsize) - 2 * wp
    rows = min(_TILE_ROWS_MAX, fit // 32 * 32)
    if rows < 32:
        raise ValueError(f"bandwidth {wp} too wide for the kernel's window")
    return rows, cols


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


def _launch(x: torch.Tensor, offsets: Sequence[int], F: int) -> torch.Tensor:
    """Run ``banded_window_launch`` on a contiguous [m, L] CUDA tensor."""
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
    rows, cols = tile_shape(L, wp, x.element_size())
    out = torch.empty_like(x)
    offs = (ctypes.c_int * len(offsets))(*[int(o) for o in offsets])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _kernel()(
            x.data_ptr(), out.data_ptr(), m, L, F, offs, len(offsets), wp,
            _DTYPE_CODES[x.dtype], rows, cols, stream,
        )
    if err != 0:
        raise RuntimeError(f"banded_window_launch failed: CUDA error {err}")
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

def _unit_raw(x: torch.Tensor, offsets: tuple[int, ...]) -> torch.Tensor:
    if x.device.type == "cpu":
        return banded_spmm_unit_plain(x, offsets)
    out = _launch(x.contiguous(), offsets, x.shape[1])
    LAUNCHES["banded_spmm_unit"] += 1
    return out


def _packed_raw(x: torch.Tensor, offsets: tuple[int, ...], r: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return banded_spmm_unit_packed_plain(x, offsets, r)
    n, F = x.shape
    if n % r:
        raise ValueError(f"n={n} must be a multiple of r={r}")
    out = _launch(x.contiguous().view(n // r, r * F), offsets, F)
    LAUNCHES["banded_spmm_unit_packed"] += 1
    return out.view(n, F)


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
