"""The SpMM design probes' kernels (P1–P5): wrappers of
``csrc/probe_kernels.cu``, ``csrc/subblock_stream.cu`` and K4's
``csrc/banded_stream.cu`` (P5a), and their plain PyTorch versions.

The JAX package's ``experiments/`` probe K1's and K4's designs on the TPU;
their ports (``gcn_maxcut_tpu_torch/experiments/``) run on these ops:

  * ``window_gather`` (P1, P2): y[i] = Σ_j w[i, j]·xpad[bi·B + lidx[i, j]],
    bi = i // B, over slots with 0 ≤ lidx < B + 2·Wp; xpad is x with Wp
    zero rows before and after.  x is float32, or bfloat16 summed in
    float32 (the TPU's "default" precision); y is float32.  Its kernel
    (``window_warp_gather``) is a warp gather a row that walks only the
    in-window slots.
  * ``subblock_spmm`` (P3): y[i] = Σ_j w[i, j]·x[sidx[i, j]] over the slots
    whose sender lies in row i's R0-row sub-block slice
    [k·R0 − Wp, k·R0 + R0 + Wp) mod n (R0 = ``block_ell.sub_block_rows``):
    K1's function on P3's exact-degree table.  Its kernel
    (``csrc/subblock_stream.cu``) streams a strip of sub-blocks through a
    shared-memory ring, and each sub-block reads only its slice from it
    (geometry ``subblock_stream_shape``).
  * ``panel_ell_spmm`` (P4): y[i] = Σ_s wgt[i, s]·xwin_i[(s // W_P)·128 +
    idx[i, s]] over slots with 0 ≤ idx < 128, where xwin_i[t] =
    x[(bi·B − Wp + t) mod n].  Its kernel (``panel_ell_gather``) is a warp
    gather a row that walks only the filled slots.
  * ``banded_spmm_cols`` (P5a): K4's y[i] = Σ_k wc[k, i]·x[(i + o_k) mod n]
    with column-major [D, n] weights, on K4's ring in its column-weight
    mode (``ops/banded._stream_call``).

Each wrapper runs its plain version on CPU tensors only; on a CUDA tensor
it launches its kernel or raises, and counts the launch (``ops/launches.py``).
The ops are forward only: the probes differentiate nothing.  P5a's rows
that are not whole 16-byte pieces, or a misaligned x, run its earlier body
(``banded_cols_kernel``, ``_banded_cols_window_launch``) by K4's shape rule
(``halo_stream._vec16``), counted under ``banded_spmm_cols_window``.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Sequence

import torch

from gcn_maxcut_tpu_torch import build
from gcn_maxcut_tpu_torch.ops import banded as tb
from gcn_maxcut_tpu_torch.ops import block_ell as tbell
from gcn_maxcut_tpu_torch.ops import launches
from gcn_maxcut_tpu_torch.ops.banded import (
    MAX_OFFSETS,
    banded_spmm_plain,
    padded_bandwidth,
    tile_shape,
)
from gcn_maxcut_tpu_torch.ops.halo_stream import _vec16

PANEL = 128                  # rows of one P4 panel (csrc PROBE_PANEL)
GATHER_ROWS = 8              # rows (warps) of one warp-gather block (csrc PROBE_GATHER_THREADS / 32)
SMEM_LIMIT = 232_448         # dynamic shared memory one block may use on the H100
SM_SMEM = 233_472            # the most shared memory one SM holds (of its 256 KB with L1)
SM_BLOCK_RESERVED = 1024     # shared memory the card reserves for each block
SM_COUNT = 132               # SMs of the H100 SXM
# P3's ring (csrc/subblock_stream.cu): the widest column tile and the most
# threads of a block (csrc SSTREAM_MAX_THREADS), chosen on the H100 by
# tools/sweep_subblock_stream.py (PERF.md)
SUBBLOCK_COLS = 64
SUBBLOCK_THREADS = 512
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@functools.cache
def _fn(name: str, argtypes: tuple, source: str = "probe_kernels"):
    fn = getattr(build.load(source), name)
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


def warp_gather_shape(n: int, F: int, *, vec4: bool = True) -> tuple[int, int]:
    """The warp gathers' launch (``window_warp_gather``, ``panel_ell_gather``):
    (vec, blocks).  A warp owns one row and each lane ``vec`` adjacent
    columns, 4 (16-byte float32 or 8-byte bfloat16 loads, 16-byte stores)
    when F % 4 == 0 and ``vec4`` (the operands' addresses allow it), else
    1; blocks of ``GATHER_ROWS`` warps cover the n rows."""
    return (4 if vec4 and F % 4 == 0 else 1), -(-n // GATHER_ROWS)


def _aligned4(*tensors: torch.Tensor) -> bool:
    """Every operand starts at a multiple of 4 of its elements: the warp
    gathers' VEC = 4 loads and stores (16 bytes of float32, 8 of bfloat16)
    are aligned."""
    return all(t.data_ptr() % (4 * t.element_size()) == 0 for t in tensors)


def _window_warp_launch(xpad: torch.Tensor, lidx: torch.Tensor, w: torch.Tensor,
                        n: int, block: int, wp: int) -> torch.Tensor:
    """``window_warp_gather_launch`` on checked operands; raises if it fails."""
    F, d = xpad.shape[1], lidx.shape[1]
    out = torch.empty((n, F), dtype=torch.float32, device=xpad.device)
    vec, _ = warp_gather_shape(n, F, vec4=_aligned4(xpad, out))
    with torch.cuda.device(xpad.device):
        err = _fn("window_warp_gather_launch", (_P, _P, _P, _P) + (_I,) * 7 + (_P,))(
            xpad.data_ptr(), lidx.data_ptr(), w.data_ptr(), out.data_ptr(),
            n, F, d, block, wp, vec, _DTYPE_CODES[xpad.dtype], _stream(xpad))
    if err != 0:
        raise RuntimeError(f"window_warp_gather_launch failed: CUDA error {err}")
    return out


def window_gather(xpad: torch.Tensor, lidx: torch.Tensor, w: torch.Tensor,
                  block: int, wp: int) -> torch.Tensor:
    """P1/P2's kernel: y [n, F] float32 from xpad [n + 2·wp, F] (float32 or
    bfloat16), block-local indices lidx int32 [n, d] and weights w float32
    [n, d]; n a multiple of ``block``.  Runs ``window_warp_gather``."""
    if _dispatch("window_gather", xpad):
        return window_gather_plain(xpad, lidx, w, block, wp)
    n = _window_geometry(xpad, lidx, w, block, wp)
    _check_cuda("window_gather", xpad, lidx, w)
    out = _window_warp_launch(xpad, lidx, w, n, block, wp)
    launches.LAUNCHES["window_gather"] += 1
    return out


# ---- P3: subblock_spmm ----------------------------------------------------

@dataclasses.dataclass(frozen=True)
class SubblockStreamGeometry:
    """One launch of ``subblock_stream.cu``: a block of ``threads`` threads
    owns ``cols`` columns and a strip of ``strip`` sub-blocks of ``r0``
    rows, streamed through a ring of ``ring_rows`` = 2·r0 + 2·Wp rows (the
    summed sub-block's slice and the next one's new rows in flight) beside
    two buffers of one sub-block's [r0, d] table and its [r0, d] (ring
    slot, weight) pairs.  A thread owns ``vec`` adjacent columns (4:
    16-byte copies).  ``blocks_per_sm`` blocks fit one SM; the strip is
    chosen so that the grid fills one wave of them."""

    n: int
    F: int
    r0: int
    wp: int
    d: int
    vec: int
    threads: int
    cols: int
    strip: int
    ring_rows: int
    smem_bytes: int
    blocks_per_sm: int

    @property
    def grid(self) -> tuple[int, int]:
        """(strips, column tiles) of the launch."""
        return -(-(self.n // self.r0) // self.strip), -(-self.F // self.cols)

    @property
    def reads(self) -> float:
        """Rows of x read for each row of output, at full strips."""
        rows = self.strip * self.r0
        return (rows + 2 * self.wp) / rows


def subblock_stream_smem_bytes(ring_rows: int, cols: int, r0: int, d: int) -> int:
    """The ring (rounded up to 16 bytes), two buffers of a sub-block's
    sender ids and weights and its (slot, weight) pairs (each array of
    r0·d 4-byte values rounded up to 16 bytes)."""
    return (ring_rows * cols * 4 + 15) // 16 * 16 + 6 * ((r0 * d * 4 + 15) // 16 * 16)


@functools.cache
def subblock_stream_shape(n: int, F: int, r0: int, wp: int, d: int,
                          vec: int) -> SubblockStreamGeometry:
    """The launch geometry of P3's ring for x [n, F], R0-row sub-blocks,
    half-window Wp and a d-slot table.  The column tile is all of F up to
    ``SUBBLOCK_COLS`` columns, halved until the ring fits a block's shared
    memory; a block has a thread for each (row, column group) of a
    sub-block, at most ``SUBBLOCK_THREADS``.  The strip is the fewest
    sub-blocks that fill one wave of ``SM_COUNT`` SMs at the blocks that
    fit an SM (by shared memory and by threads), so no block waits for a
    second wave."""
    if vec not in (1, 4) or F % vec:
        raise ValueError(f"vec must be 1 or 4 and divide F, got vec={vec}, F={F}")
    if r0 < 1 or n % r0 or r0 + 2 * wp > n:
        raise ValueError(f"bad geometry: n={n}, r0={r0}, wp={wp}")
    ring_rows = 2 * r0 + 2 * wp
    cols = min(F, SUBBLOCK_COLS) // vec * vec
    while subblock_stream_smem_bytes(ring_rows, cols, r0, d) > SMEM_LIMIT and cols > vec:
        cols = max(vec, cols // 2 // vec * vec)
    smem = subblock_stream_smem_bytes(ring_rows, cols, r0, d)
    if smem > SMEM_LIMIT:
        raise ValueError(f"a ring of {ring_rows} rows does not fit the block's shared memory")
    threads = min(SUBBLOCK_THREADS, -(-r0 * cols // vec // 32) * 32)
    per_sm = min(SM_SMEM // (smem + SM_BLOCK_RESERVED), 2048 // threads)
    tiles = -(-F // cols)
    strips = max(1, SM_COUNT * per_sm // tiles)
    strip = -(-(n // r0) // strips)
    return SubblockStreamGeometry(n=n, F=F, r0=r0, wp=wp, d=d, vec=vec, threads=threads,
                                  cols=cols, strip=strip, ring_rows=ring_rows,
                                  smem_bytes=smem, blocks_per_sm=per_sm)


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


def _subblock_stream_launch(x: torch.Tensor, sidx: torch.Tensor, w: torch.Tensor,
                            n: int, block: int, wp: int) -> torch.Tensor:
    """``subblock_stream_launch`` on checked operands; raises if it fails."""
    F, d = x.shape[1], sidx.shape[1]
    out = torch.empty_like(x)
    vec = 4 if F % 4 == 0 and (x.data_ptr() | out.data_ptr()) % 16 == 0 else 1
    g = subblock_stream_shape(n, F, tbell.sub_block_rows(block), wp, d, vec)
    with torch.cuda.device(x.device):
        err = _fn("subblock_stream_launch", (_P, _P, _P, _P) + (_I,) * 11 + (_P,),
                  "subblock_stream")(
            x.data_ptr(), sidx.data_ptr(), w.data_ptr(), out.data_ptr(), n, F, d, wp,
            g.r0, g.vec, g.strip, g.cols, g.ring_rows, g.threads, g.smem_bytes, _stream(x))
    if err != 0:
        raise RuntimeError(f"subblock_stream_launch failed: CUDA error {err}")
    return out


def subblock_spmm(x: torch.Tensor, sidx: torch.Tensor, w: torch.Tensor,
                  n: int, block: int, wp: int) -> torch.Tensor:
    """P3's sub-blocked SpMM: x float32 [n, F], absolute sender ids sidx
    int32 [n, d] and weights w float32 [n, d]; runs P3's ring
    (``csrc/subblock_stream.cu``), in which each sub-block reads only its
    slice: the design P3 measures."""
    if _dispatch("subblock_spmm", x):
        return subblock_spmm_plain(x, sidx, w, n, block, wp)
    _subblock_geometry(x, sidx, w, n, block, wp)
    _check_cuda("subblock_spmm", x, sidx, w)
    out = _subblock_stream_launch(x, sidx, w, n, block, wp)
    launches.LAUNCHES["subblock_spmm"] += 1
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


def _panel_gather_launch(x: torch.Tensor, idx: torch.Tensor, wgt: torch.Tensor,
                         n: int, block: int, wp: int, w_p: int) -> torch.Tensor:
    """``panel_ell_gather_launch`` on checked operands; raises if it fails."""
    F = x.shape[1]
    out = torch.empty_like(x)
    vec, _ = warp_gather_shape(n, F, vec4=_aligned4(x, out))
    with torch.cuda.device(x.device):
        err = _fn("panel_ell_gather_launch", (_P, _P, _P, _P) + (_I,) * 7 + (_P,))(
            x.data_ptr(), idx.data_ptr(), wgt.data_ptr(), out.data_ptr(),
            n, F, idx.shape[1], w_p, block, wp, vec, _stream(x))
    if err != 0:
        raise RuntimeError(f"panel_ell_gather_launch failed: CUDA error {err}")
    return out


def panel_ell_spmm(x: torch.Tensor, idx: torch.Tensor, wgt: torch.Tensor,
                   n: int, block: int, wp: int, w_p: int) -> torch.Tensor:
    """P4's kernel: x float32 [n, F], panel-local indices idx int32
    [n, n_panels·W_P] (−1 for an empty slot) and weights wgt float32 of the
    same shape (``experiments/panel_ell_probe.build_panel_tables``); runs
    ``panel_ell_gather``."""
    if _dispatch("panel_ell_spmm", x):
        return panel_ell_spmm_plain(x, idx, wgt, n, block, wp, w_p)
    _panel_geometry(x, idx, wgt, n, block, wp, w_p)
    _check_cuda("panel_ell_spmm", x, idx, wgt)
    out = _panel_gather_launch(x, idx, wgt, n, block, wp, w_p)
    launches.LAUNCHES["panel_ell_spmm"] += 1
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
    x [n, F] and column-major weights wc [D, n], on K4's ring in its
    column-weight mode.  K4's rule (``ops/banded._weighted_raw``): rows
    that are not whole 16-byte pieces, or a misaligned x, run the earlier
    body.  A failed launch raises."""
    offsets = tuple(int(o) for o in offsets)
    if _dispatch("banded_spmm_cols", x):
        return banded_spmm_cols_plain(x, wc, offsets)
    wp = _cols_geometry(x, wc, offsets)
    _check_cuda("banded_spmm_cols", x, wc)
    if not _vec16(x.shape[1], x.element_size(), x):
        return _banded_cols_window_launch(x, wc, offsets)
    out = tb._stream_call(x, wc, offsets, wp, cols=True)
    launches.LAUNCHES["banded_spmm_cols"] += 1
    return out


def _banded_cols_window_launch(x: torch.Tensor, wc: torch.Tensor,
                               offsets: Sequence[int]) -> torch.Tensor:
    """P5a's earlier body, ``banded_cols_kernel`` (K4's earlier tiling, each
    tile's window and [D, rows] weights staged), on CUDA tensors: the
    route of rows that are not whole 16-byte pieces, else for comparison
    only."""
    offsets = tuple(int(o) for o in offsets)
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
    launches.LAUNCHES["banded_spmm_cols_window"] += 1
    return out
