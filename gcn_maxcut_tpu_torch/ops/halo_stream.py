"""The binding of ``csrc/halo_stream.cu``: its launch geometry, its 16-byte
rule and its launch, shared by every op that runs it.

The kernel sums pure row shifts of one array [m, L] and its two staged
[Wp, L] tiles, out[i] = Σ_k w[i, k]·src(i + o_k), with src = pre, x or post
by row.  Two callers stage the tiles:

  * ``ops/halo.py`` (K5, K6): the tiles are the ring neighbours' edge rows;
  * ``ops/banded.py`` (K2, K3): a one-shard ring whose tiles are the
    circulant wrap rows of the array itself (in the packed layout rotated
    by one lane group, as the TPU kernel stages them).

This module imports neither, so that both can import it.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Sequence

import torch

from gcn_maxcut_tpu_torch import build

SMEM_LIMIT = 232_448          # dynamic shared memory one block may use on the H100
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# The strip window's geometry: rows a chunk, widest column tile and rows a
# strip (two chunks); chosen on the H100 by a sweep at the halo trainers'
# shards (PERF.md)
HALO_CHUNK = 64
HALO_COLS = 64
HALO_STRIP = 2 * HALO_CHUNK
HALO_THREADS = 256            # csrc/halo_stream.cu HSTREAM_THREADS


@dataclasses.dataclass(frozen=True)
class HaloStreamGeometry:
    """One launch of ``halo_stream.cu``: a block of ``HALO_THREADS``
    threads owns ``cols`` columns and a strip of ``strip`` rows, whose
    window of ``window_rows`` = strip + 2·Wp source rows it stages in
    chunks of ``chunk`` rows, summing each chunk while the next one's rows
    land, beside two chunks' [chunk, D] weights (none for unit weights).
    A thread owns ``vec`` adjacent columns, 16 bytes: 8 bfloat16 or 4
    float32 values."""

    m: int
    L: int
    wp: int
    chunk: int
    strip: int
    cols: int
    window_rows: int
    vec: int
    smem_bytes: int

    @property
    def grid(self) -> tuple[int, int]:
        """(strips, column tiles) of the launch."""
        return -(-self.m // self.strip), -(-self.L // self.cols)


def halo_stream_smem_bytes(window_rows: int, cols: int, elsize: int, D: int) -> int:
    """The strip's window (rounded up to 16 bytes) and two chunks of
    weights (D = 0 for unit weights)."""
    return (window_rows * cols * elsize + 15) // 16 * 16 + 2 * HALO_CHUNK * D * 4


@functools.cache
def halo_stream_shape(m: int, L: int, wp: int, D: int, elsize: int) -> HaloStreamGeometry:
    """The launch geometry for an array [m, L] of ``elsize``-byte values
    whose rows are whole 16-byte pieces, halo width Wp and D weighted
    offsets (0: unit weights).  The column tile is ``HALO_COLS`` wide,
    halved until the window fits; every strip is ``HALO_STRIP`` rows."""
    if L * elsize % 16:
        raise ValueError(f"rows of {L} × {elsize} bytes are not whole 16-byte pieces")
    chunk, strip = HALO_CHUNK, HALO_STRIP
    vec = 16 // elsize
    cols = min(L, HALO_COLS)
    window_rows = strip + 2 * wp
    while halo_stream_smem_bytes(window_rows, cols, elsize, D) > SMEM_LIMIT and cols > vec:
        cols = max(vec, cols // 2 // vec * vec)
    smem = halo_stream_smem_bytes(window_rows, cols, elsize, D)
    if smem > SMEM_LIMIT:
        raise ValueError(f"a window of {window_rows} rows does not fit the block's "
                         "shared memory")
    return HaloStreamGeometry(m=m, L=L, wp=wp, chunk=chunk, strip=strip, cols=cols,
                              window_rows=window_rows, vec=vec, smem_bytes=smem)


def _vec16(L: int, elsize: int, *tensors: torch.Tensor) -> bool:
    """``halo_stream.cu`` takes the launch: every row is a whole number of
    16-byte pieces and every operand starts 16-byte aligned."""
    return L * elsize % 16 == 0 and all(t.data_ptr() % 16 == 0 for t in tensors)


@functools.cache
def _stream_kernel():
    fn = build.load("halo_stream").halo_stream_launch
    fn.argtypes = [
        *[ctypes.c_void_p] * 5, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        *[ctypes.c_int] * 7, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def launch(
    x: torch.Tensor, pre: torch.Tensor, post: torch.Tensor, offsets: Sequence[int],
    w: torch.Tensor | None = None,
) -> torch.Tensor:
    """``halo_stream_launch`` on operands the caller has checked: a
    contiguous [m, L] CUDA tensor, its [Wp, L] tiles (Wp = the tiles' row
    count, |o_k| ≤ Wp) and a float32 [m, D] weight table or (``w`` None)
    unit weights, in ``halo_stream_shape``'s geometry.  A launch the
    kernel refuses (rows that are not 16-byte pieces, a misaligned
    operand) or that fails raises."""
    m, L = x.shape
    wp = pre.shape[0]
    out = torch.empty_like(x)
    geom = halo_stream_shape(m, L, wp, 0 if w is None else len(offsets), x.element_size())
    offs = (ctypes.c_int * len(offsets))(*[int(o) for o in offsets])
    with torch.cuda.device(x.device):
        err = _stream_kernel()(
            x.data_ptr(), pre.data_ptr(), post.data_ptr(),
            None if w is None else w.data_ptr(), out.data_ptr(), m, L, offs, len(offsets),
            wp, _DTYPE_CODES[x.dtype], geom.chunk, geom.strip, geom.cols, geom.smem_bytes,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"halo_stream_launch failed: CUDA error {err}")
    return out
