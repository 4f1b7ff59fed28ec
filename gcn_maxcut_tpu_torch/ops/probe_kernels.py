"""The SpMM design probes' kernels (P1–P5): wrappers of
``csrc/probe_kernels.cu`` and their plain PyTorch versions.

The JAX package's ``experiments/`` probe K1's and K4's designs on the TPU;
their ports (``gcn_maxcut_tpu_torch/experiments/``) run on these ops:

  * ``window_gather`` (P1, P2): y[i] = Σ_j w[i, j]·xpad[bi·B + lidx[i, j]],
    bi = i // B, over slots with 0 ≤ lidx < B + 2·Wp; xpad is x with Wp
    zero rows before and after.  x is float32, or bfloat16 summed in
    float32 (the TPU's "default" precision); y is float32.
  * ``subblock_spmm`` (P3): y[i] = Σ_j w[i, j]·x[sidx[i, j]] over the slots
    whose sender lies in row i's 128-row sub-block slice
    [s·128 − Wp, s·128 + 128 + Wp) mod n: K1's function and K1's kernel
    (``ops/block_ell._launch``) on P3's exact-degree table.
  * ``panel_ell_spmm`` (P4): y[i] = Σ_s wgt[i, s]·xwin_i[(s // W_P)·128 +
    idx[i, s]] over slots with 0 ≤ idx < 128, where xwin_i[t] =
    x[(bi·B − Wp + t) mod n].
  * ``banded_spmm_cols`` (P5a): K4's y[i] = Σ_k wc[k, i]·x[(i + o_k) mod n]
    with column-major [D, n] weights.

Each wrapper runs its plain version on CPU tensors only; on a CUDA tensor
it launches its kernel or raises, and counts the launch.  The ops are
forward only: the probes differentiate nothing.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch

from gcn_maxcut_tpu_torch import build
from gcn_maxcut_tpu_torch.ops import block_ell as tbell
from gcn_maxcut_tpu_torch.ops.banded import (
    MAX_OFFSETS,
    banded_spmm_plain,
    padded_bandwidth,
    tile_shape,
)

# Launches of each CUDA kernel, counted where it launches.
LAUNCHES = {"window_gather": 0, "panel_ell_spmm": 0, "banded_spmm_cols": 0,
            "subblock_spmm": 0}

PANEL = 128                  # rows of one P4 panel (csrc PROBE_PANEL)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _fn(name: str, argtypes: tuple):
    fn = getattr(build.load("probe_kernels"), name)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return fn


_P, _I = ctypes.c_void_p, ctypes.c_int


def _check_cuda(name: str, *tensors: torch.Tensor) -> None:
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} needs CUDA tensors, got {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: every tensor must lie on {dev}, got one on {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} needs contiguous tensors")


def _dispatch(name: str, x: torch.Tensor) -> bool:
    """True for the plain path (a CPU tensor), False for the kernel."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{name} takes CPU or CUDA tensors, got {x.device}")
    return False


def _check_table(name: str, idx: torch.Tensor, w: torch.Tensor, rows: int) -> None:
    if idx.dtype != torch.int32 or w.dtype != torch.float32:
        raise ValueError(f"{name} takes an int32 index table and float32 weights, "
                         f"got {idx.dtype}, {w.dtype}")
    if idx.dim() != 2 or idx.shape != w.shape or idx.shape[0] != rows:
        raise ValueError(f"{name} needs tables [{rows}, width] of one shape, "
                         f"got {tuple(idx.shape)} and {tuple(w.shape)}")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


# ---- P1, P2: window_gather ------------------------------------------------

def _window_geometry(xpad, lidx, w, block: int, wp: int) -> int:
    if xpad.dtype not in _DTYPE_CODES:
        raise ValueError(f"window_gather takes float32 or bfloat16 x, got {xpad.dtype}")
    if xpad.dim() != 2:
        raise ValueError("window_gather needs xpad [n + 2*wp, F]")
    n = xpad.shape[0] - 2 * wp
    _check_table("window_gather", lidx, w, n)
    if block < 1 or wp < 0 or n < block or n % block:
        raise ValueError(f"bad geometry: xpad has {xpad.shape[0]} rows, block={block}, wp={wp}")
    return n


def window_gather_plain(xpad: torch.Tensor, lidx: torch.Tensor, w: torch.Tensor,
                        block: int, wp: int) -> torch.Tensor:
    """The block-window gather-sum in PyTorch ops: slot-order sums of
    w·xpad rows in float32, slots outside the window skipped."""
    n = _window_geometry(xpad, lidx, w, block, wp)
    base = (torch.arange(n, device=xpad.device) // block * block)[:, None]
    valid = (lidx >= 0) & (lidx < block + 2 * wp)
    rows = base + torch.where(valid, lidx, 0)
    wv = torch.where(valid, w, 0.0)
    xf = xpad.float()
    out = wv[:, 0:1] * xf[rows[:, 0]]
    for j in range(1, rows.shape[1]):
        out = out + wv[:, j : j + 1] * xf[rows[:, j]]
    return out


def window_gather(xpad: torch.Tensor, lidx: torch.Tensor, w: torch.Tensor,
                  block: int, wp: int) -> torch.Tensor:
    """P1/P2's kernel: y [n, F] float32 from xpad [n + 2·wp, F] (float32 or
    bfloat16), block-local indices lidx int32 [n, d] and weights w float32
    [n, d]; n a multiple of ``block``."""
    if _dispatch("window_gather", xpad):
        return window_gather_plain(xpad, lidx, w, block, wp)
    n = _window_geometry(xpad, lidx, w, block, wp)
    _check_cuda("window_gather", xpad, lidx, w)
    F, d = xpad.shape[1], lidx.shape[1]
    fc = tbell.column_tile(F, block + 2 * wp, xpad.element_size())
    out = torch.empty((n, F), dtype=torch.float32, device=xpad.device)
    with torch.cuda.device(xpad.device):
        err = _fn("window_gather_launch", (_P, _P, _P, _P) + (_I,) * 7 + (_P,))(
            xpad.data_ptr(), lidx.data_ptr(), w.data_ptr(), out.data_ptr(),
            n, F, d, block, wp, fc, _DTYPE_CODES[xpad.dtype], _stream(xpad))
    if err != 0:
        raise RuntimeError(f"window_gather_launch failed: CUDA error {err}")
    LAUNCHES["window_gather"] += 1
    return out


# ---- P3: subblock_spmm (K1's kernel) -------------------------------------

def _subblock_geometry(x, sidx, w, n: int, block: int, wp: int) -> None:
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] != n:
        raise ValueError(f"subblock_spmm takes float32 x [{n}, F], got {x.dtype} {tuple(x.shape)}")
    _check_table("subblock_spmm", sidx, w, n)
    if block < 1 or wp < 0 or n % block or block + 2 * wp > n:
        raise ValueError(f"bad geometry: n={n}, block={block}, wp={wp}")


def subblock_spmm_plain(x: torch.Tensor, sidx: torch.Tensor, w: torch.Tensor,
                        n: int, block: int, wp: int) -> torch.Tensor:
    """Slot-order sums of w·x[sidx] over the slots whose sender lies in the
    receiver's sub-block slice, in PyTorch ops."""
    _subblock_geometry(x, sidx, w, n, block, wp)
    r0 = tbell.sub_block_rows(block)
    start = (torch.arange(n, device=x.device) // r0 * r0)[:, None]
    valid = (sidx.long() - start + wp) % n < r0 + 2 * wp
    return tbell._ell_sum_exact(x, sidx, torch.where(valid, w, 0.0))


def subblock_spmm(x: torch.Tensor, sidx: torch.Tensor, w: torch.Tensor,
                  n: int, block: int, wp: int) -> torch.Tensor:
    """P3's sub-blocked SpMM: x float32 [n, F], absolute sender ids sidx
    int32 [n, d] and weights w float32 [n, d]; runs K1's kernel, which
    stages each 128-row sub-block's slice (``ops/block_ell.py``)."""
    if _dispatch("subblock_spmm", x):
        return subblock_spmm_plain(x, sidx, w, n, block, wp)
    _subblock_geometry(x, sidx, w, n, block, wp)
    _check_cuda("subblock_spmm", x, sidx, w)
    out = tbell._launch(x, sidx, w, n, block, wp)
    LAUNCHES["subblock_spmm"] += 1
    return out


# ---- P4: panel_ell_spmm ---------------------------------------------------

def _panel_geometry(x, idx, wgt, n: int, block: int, wp: int, w_p: int) -> None:
    if x.dtype != torch.float32 or x.dim() != 2 or x.shape[0] != n:
        raise ValueError(f"panel_ell_spmm takes float32 x [{n}, F], got {x.dtype} {tuple(x.shape)}")
    _check_table("panel_ell_spmm", idx, wgt, n)
    win = block + 2 * wp
    if block < 1 or wp < 0 or w_p < 1 or n % block or win > n or win % PANEL:
        raise ValueError(f"bad geometry: n={n}, block={block}, wp={wp} (the window must "
                         f"be a multiple of {PANEL} rows)")
    if idx.shape[1] != win // PANEL * w_p:
        raise ValueError(f"the table needs {win // PANEL * w_p} slots, has {idx.shape[1]}")


def panel_ell_spmm_plain(x: torch.Tensor, idx: torch.Tensor, wgt: torch.Tensor,
                         n: int, block: int, wp: int, w_p: int) -> torch.Tensor:
    """Slot-order sums over the panel table's filled slots, in PyTorch ops."""
    _panel_geometry(x, idx, wgt, n, block, wp, w_p)
    first = (torch.arange(n, device=x.device) // block * block - wp)[:, None]
    slot_base = (torch.arange(idx.shape[1], device=x.device) // w_p * PANEL)[None, :]
    valid = (idx >= 0) & (idx < PANEL)
    rows = (first + slot_base + torch.where(valid, idx, 0)) % n
    return tbell._ell_sum_exact(x, rows, torch.where(valid, wgt, 0.0))


def panel_ell_spmm(x: torch.Tensor, idx: torch.Tensor, wgt: torch.Tensor,
                   n: int, block: int, wp: int, w_p: int) -> torch.Tensor:
    """P4's kernel: x float32 [n, F], panel-local indices idx int32
    [n, n_panels·W_P] (−1 for an empty slot) and weights wgt float32 of the
    same shape (``experiments/panel_ell_probe.build_panel_tables``)."""
    if _dispatch("panel_ell_spmm", x):
        return panel_ell_spmm_plain(x, idx, wgt, n, block, wp, w_p)
    _panel_geometry(x, idx, wgt, n, block, wp, w_p)
    _check_cuda("panel_ell_spmm", x, idx, wgt)
    F = x.shape[1]
    fc = tbell.column_tile(F, block + 2 * wp)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _fn("panel_ell_launch", (_P, _P, _P, _P) + (_I,) * 7 + (_P,))(
            x.data_ptr(), idx.data_ptr(), wgt.data_ptr(), out.data_ptr(),
            n, F, idx.shape[1], w_p, block, wp, fc, _stream(x))
    if err != 0:
        raise RuntimeError(f"panel_ell_launch failed: CUDA error {err}")
    LAUNCHES["panel_ell_spmm"] += 1
    return out


# ---- P5a: banded_spmm_cols ------------------------------------------------

def _cols_geometry(x, wc, offsets: Sequence[int]) -> int:
    if x.dtype != torch.float32 or wc.dtype != torch.float32 or x.dim() != 2:
        raise ValueError(f"banded_spmm_cols takes float32 x [n, F] and wc [D, n], "
                         f"got {x.dtype}, {wc.dtype}")
    n = x.shape[0]
    if not offsets or len(offsets) > MAX_OFFSETS:
        raise ValueError(f"need 1..{MAX_OFFSETS} offsets, got {len(offsets)}")
    if tuple(wc.shape) != (len(offsets), n):
        raise ValueError(f"wc must be [{len(offsets)}, {n}], got {tuple(wc.shape)}")
    wp = padded_bandwidth(offsets)
    if 2 * wp > n:
        raise ValueError(f"2*Wp = {2 * wp} exceeds the {n} rows")
    return wp


def banded_spmm_cols_plain(x: torch.Tensor, wc: torch.Tensor,
                           offsets: Sequence[int]) -> torch.Tensor:
    """K4's plain version on the transposed weights."""
    _cols_geometry(x, wc, offsets)
    return banded_spmm_plain(x, wc.t(), offsets)


def banded_spmm_cols(x: torch.Tensor, wc: torch.Tensor,
                     offsets: Sequence[int]) -> torch.Tensor:
    """P5a's kernel: y[i] = Σ_k wc[k, i]·x[(i + o_k) mod n] on float32
    x [n, F] and column-major weights wc [D, n], on K4's tiling."""
    offsets = tuple(int(o) for o in offsets)
    if _dispatch("banded_spmm_cols", x):
        return banded_spmm_cols_plain(x, wc, offsets)
    wp = _cols_geometry(x, wc, offsets)
    _check_cuda("banded_spmm_cols", x, wc)
    n, F = x.shape
    rows, cols = tile_shape(F, wp, 4, 4 * len(offsets))
    out = torch.empty_like(x)
    offs = (ctypes.c_int * len(offsets))(*offsets)
    with torch.cuda.device(x.device):
        err = _fn("banded_cols_launch",
                  (_P, _P, _P, _I, _I, ctypes.POINTER(ctypes.c_int)) + (_I,) * 4 + (_P,))(
            x.data_ptr(), wc.data_ptr(), out.data_ptr(), n, F, offs, len(offsets),
            wp, rows, cols, _stream(x))
    if err != 0:
        raise RuntimeError(f"banded_cols_launch failed: CUDA error {err}")
    LAUNCHES["banded_spmm_cols"] += 1
    return out
