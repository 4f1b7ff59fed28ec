"""Block-ELL SpMM for locality-reordered graphs (K1): the planner, the
hand-written CUDA kernel's wrapper and its plain PyTorch version.

Port of ``gcn_maxcut_tpu/ops/pallas_block_ell.py``.  A graph whose
neighbour offsets are bounded (after RCM, ``data/reorder.py``) is cut into
blocks of B receivers.  Receivers of block b read senders from the window
of rows [b·B − Wp, b·B + B + Wp) (mod n), and the receivers of each R0-row
sub-block only from its slice [k·R0 − Wp, k·R0 + R0 + Wp) (R0 = 128, or B
when 128 does not divide B).  ``plan_block_ell`` picks (B, Wp) and a table
width, puts every edge that lies in its receiver's slice and within the
width into a compact ELL table, and lists all other edges as outlier COO
triples, so that

    block_ell_spmm(x) = Σ_j w[i, j]·x[sidx[i, j]]  +  outlier scatter
                      = A·x   exactly (up to the order of float sums).

The TPU kernel resolved the in-window indices with a one-hot matrix on the
MXU; ``csrc/block_ell_gather.cu`` computes the same function directly:
one thread per receiver row and 4 (or, when F % 4 != 0, 1) columns loads
its in-slice senders' rows from L2/device memory and sums its table slots
in slot order, in float32 (``gather_shape``).  Table slots whose sender
lies outside the receiver's slice (padding slots: sender n − 1, weight 0)
are skipped, as the one-hot matched nothing for them.
The outlier correction stays a PyTorch ``index_add_`` after the kernel, as
it was an XLA scatter outside the Pallas kernel.

``mode`` ("split" or "fast") is accepted for signature parity only: both
compute in plain float32 here (the TPU's bf16 split undid the MXU's input
truncation).  On CPU tensors the op runs ``block_ell_spmm_plain``; on a
CUDA tensor it launches the kernel or raises.

The backward of y = A·x is Aᵀ·dy.  Without ``transpose`` it reuses the
forward (A symmetric, the JAX package's contract); with ``transpose``, the
plan of Aᵀ, it runs the kernel on that plan.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from gcn_maxcut_tpu_torch import build
from gcn_maxcut_tpu_torch.ops import launches

_R0 = 128                    # row sub-block of the planner's slice guarantee
GATHER_THREADS = 256         # csrc/block_ell_gather.cu BELL_GATHER_THREADS


# ---------------------------------------------------------------- planning

@dataclasses.dataclass(frozen=True)
class BlockEllPlan:
    """Host-side plan: kernel geometry, compact ELL tables (absolute sender
    ids) and padded outlier COO arrays."""

    block: int
    wp: int
    senders: np.ndarray        # int32 [n_pad, width] in-slice table
    weights: np.ndarray        # f32   [n_pad, width], 0 on empty slots
    mask: np.ndarray           # f32   [n_pad, width]
    out_senders: np.ndarray    # int32 [o_pad]
    out_receivers: np.ndarray  # int32 [o_pad]
    out_weights: np.ndarray    # f32   [o_pad], 0 on padding
    out_mask: np.ndarray       # f32   [o_pad], 1 real / 0 padding
    n_outliers: int
    window: int                # block + 2*wp


def _divisor_block(n_pad: int, wp: int, target: int = 256) -> int | None:
    """Divisor of ``n_pad`` in [max(wp, 128), 2048] nearest to ``target``;
    multiples of 128 first, then any multiple of 8."""
    lo = max(wp, 128)
    best = None
    for step in (_R0, 8):
        for b in range(((lo + step - 1) // step) * step, min(2048, n_pad) + 1, step):
            if n_pad % b == 0:
                if best is None or abs(b - target) < abs(best - target):
                    best = b
        if best is not None:
            return best
    return best


def plan_block_ell(
    senders: np.ndarray,
    receivers: np.ndarray,
    weights: np.ndarray,
    n_pad: int,
    *,
    max_wp: int = 512,
    max_outlier_frac: float = 0.05,
    force_wp: int | None = None,
    force_width: int | None = None,
) -> BlockEllPlan | None:
    """Pick (block, wp, width) for the kernel, or None when the graph does
    not band.  Inputs are the real directed COO edges.

    Half-windows are tried smallest first, under an escape budget ladder
    that tightens before it loosens (at most half of
    ``max_outlier_frac``·E escapes); the table width is the smallest whose
    degree spill fits the rest of the budget (at most 2% of E).
    ``force_wp``/``force_width`` pin the geometry and skip the budgets.
    Same rules, same arrays as the JAX package's planner.
    """
    senders = np.asarray(senders, np.int64)
    receivers = np.asarray(receivers, np.int64)
    weights = np.asarray(weights, np.float32)
    e = senders.shape[0]
    if e == 0 or n_pad < 1024:
        return None
    cap = max(256, int(max_outlier_frac * e))
    candidates = [w for w in (64, 128, 192, 256, 320, 384, 448, 512) if w <= max_wp]

    def escapes(wp):
        b = _divisor_block(n_pad, wp)
        if b is None or b + 2 * wp > n_pad:
            return None, None, None
        lidx = (senders - (receivers // b) * b + wp) % n_pad
        # in-window iff the sender lies in its receiver sub-block's slice
        r0 = _R0 if b % _R0 == 0 else b
        k = (receivers % b) // r0
        in_win = (lidx >= k * r0) & (lidx < k * r0 + r0 + 2 * wp)
        return b, in_win, int(e - in_win.sum())

    chosen = None
    if force_wp is not None:
        b, in_win, n_escape = escapes(force_wp)
        if b is not None:
            chosen = (force_wp, b, in_win, n_escape)
    else:
        tiers = sorted({max(64, e // 1000), e // 100, e // 20, e // 10, cap // 2})
        for tier_cap in (t for t in tiers if t <= cap // 2):
            for wp in candidates:
                b, in_win, n_escape = escapes(wp)
                if b is not None and n_escape <= tier_cap:
                    chosen = (wp, b, in_win, n_escape)
                    break
            if chosen:
                break
    if not chosen:
        return None

    wp, b, in_win, n_escape = chosen
    # in-window edges, receiver-major, with their rank inside the row
    order = np.argsort(receivers[in_win], kind="stable")
    r_in = receivers[in_win][order]
    s_in = senders[in_win][order]
    w_in = weights[in_win][order]
    counts = np.bincount(r_in, minlength=n_pad)
    starts = np.zeros(n_pad, np.int64)
    np.cumsum(counts[:-1], out=starts[1:])
    ranks = np.arange(r_in.shape[0]) - starts[r_in]
    max_deg = int(counts.max()) if r_in.size else 0
    spill_budget = max(0, min(cap - n_escape, int(0.02 * e)))
    width = max_deg
    if force_width is not None:
        width = force_width
    elif max_deg:
        rank_counts = np.bincount(ranks, minlength=max_deg)
        spills = r_in.shape[0] - np.cumsum(rank_counts)
        ok_widths = np.nonzero(spills <= spill_budget)[0]
        if ok_widths.size:
            width = int(ok_widths[0]) + 1
    fits = ranks < width
    spill = ~fits
    n_out = n_escape + int(spill.sum())

    table_s = np.full((n_pad, max(1, width)), n_pad - 1, np.int32)
    table_w = np.zeros((n_pad, max(1, width)), np.float32)
    table_m = np.zeros((n_pad, max(1, width)), np.float32)
    table_s[r_in[fits], ranks[fits]] = s_in[fits]
    table_w[r_in[fits], ranks[fits]] = w_in[fits]
    table_m[r_in[fits], ranks[fits]] = 1.0

    o_pad = max(128, int(np.ceil(max(1, n_out) / 128)) * 128)
    out_s = np.full(o_pad, n_pad - 1, np.int32)
    out_r = np.full(o_pad, n_pad - 1, np.int32)
    out_w = np.zeros(o_pad, np.float32)
    out_m = np.zeros(o_pad, np.float32)
    out_s[:n_escape] = senders[~in_win]
    out_r[:n_escape] = receivers[~in_win]
    out_w[:n_escape] = weights[~in_win]
    out_s[n_escape:n_out] = s_in[spill]
    out_r[n_escape:n_out] = r_in[spill]
    out_w[n_escape:n_out] = w_in[spill]
    out_m[:n_out] = 1.0
    return BlockEllPlan(
        block=b, wp=wp, senders=table_s, weights=table_w, mask=table_m,
        out_senders=out_s, out_receivers=out_r, out_weights=out_w,
        out_mask=out_m, n_outliers=n_out, window=b + 2 * wp,
    )


# ---------------------------------------------------------------- the op

class BlockEllOperand(NamedTuple):
    """One operator's plan as tensors: table, outliers and geometry."""

    sidx: torch.Tensor
    w: torch.Tensor
    out_s: torch.Tensor
    out_r: torch.Tensor
    out_w: torch.Tensor
    block: int
    wp: int


def sub_block_rows(block: int) -> int:
    """R0: the rows of one sub-block, which all read from one slice."""
    return _R0 if block % _R0 == 0 else block


def gather_shape(n: int, F: int, *, vec4: bool = True) -> tuple[int, int]:
    """K1's launch (``csrc/block_ell_gather.cu``): (vec, blocks).  A thread
    owns one receiver row and ``vec`` adjacent columns, 4 (16-byte loads and
    stores) when F % 4 == 0 and ``vec4`` (the operands' addresses allow
    it), else 1; blocks of ``GATHER_THREADS`` threads cover n·F/vec
    threads."""
    vec = 4 if vec4 and F % 4 == 0 else 1
    return vec, -(-n * (F // vec) // GATHER_THREADS)


@functools.cache
def _gather_kernel():
    """``block_ell_gather_launch``: four pointers, seven ints, the stream."""
    fn = build.load("block_ell_gather").block_ell_gather_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch(x: torch.Tensor, sidx: torch.Tensor, w: torch.Tensor,
            n: int, block: int, wp: int) -> torch.Tensor:
    """K1: the in-slice table sum of ``csrc/block_ell_gather.cu`` on CUDA,
    after K1's operand rules."""
    if x.device.type != "cuda":
        raise ValueError(f"kernel needs a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32 or w.dtype != torch.float32:
        raise ValueError(f"kernel takes float32 x and w, got {x.dtype}, {w.dtype}")
    if sidx.dtype != torch.int32:
        raise ValueError(f"kernel takes int32 sender ids, got {sidx.dtype}")
    if x.dim() != 2 or sidx.dim() != 2 or sidx.shape != w.shape:
        raise ValueError("kernel needs x [n, F] and tables [n, width] of one shape")
    if sidx.device != x.device or w.device != x.device:
        raise ValueError("x and the tables must lie on one device")
    rows, F = x.shape
    if rows != n or sidx.shape[0] != n or n % block or block + 2 * wp > n or wp < 0:
        raise ValueError(
            f"bad geometry: x has {rows} rows, n={n}, block={block}, wp={wp}")
    x, sidx, w = x.contiguous(), sidx.contiguous(), w.contiguous()
    out = torch.empty_like(x)
    vec, blocks = gather_shape(n, F, vec4=(x.data_ptr() | out.data_ptr()) % 16 == 0)
    with torch.cuda.device(x.device):
        err = _gather_kernel()(
            x.data_ptr(), sidx.data_ptr(), w.data_ptr(), out.data_ptr(),
            n, F, sidx.shape[1], wp, sub_block_rows(block), vec, blocks,
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"block_ell_gather_launch failed: CUDA error {err}")
    return out


def _ell_sum_exact(x: torch.Tensor, sidx: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    # the table's row gathers summed in slot order (the JAX fallback's order)
    idx = sidx.long()
    out = w[:, 0:1] * x[idx[:, 0]]
    for j in range(1, idx.shape[1]):
        out = out + w[:, j : j + 1] * x[idx[:, j]]
    return out


def _add_outliers(y, x, out_s, out_r, out_w):
    # int32 indices as they are: a cast would be two more launches a call
    return y.index_add_(0, out_r, out_w[:, None] * x[out_s])


def block_ell_spmm_plain(
    x: torch.Tensor, sidx: torch.Tensor, w: torch.Tensor, out_s: torch.Tensor,
    out_r: torch.Tensor, out_w: torch.Tensor, n: int, block: int, wp: int,
) -> torch.Tensor:
    """Table gather-sum plus the outlier scatter, in PyTorch ops."""
    del n, block, wp
    return _add_outliers(_ell_sum_exact(x, sidx, w), x, out_s, out_r, out_w)


def _raw(x: torch.Tensor, op: BlockEllOperand, n: int) -> torch.Tensor:
    if x.device.type == "cpu":
        return block_ell_spmm_plain(x, *op[:5], n, op.block, op.wp)
    y = _launch(x, op.sidx, op.w, n, op.block, op.wp)
    launches.LAUNCHES["block_ell_spmm"] += 1
    return _add_outliers(y, x, op.out_s, op.out_r, op.out_w)


class _BlockEll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, op, op_t, n):
        ctx.op, ctx.op_t, ctx.n = op, op_t, n
        return _raw(x, op, n)

    @staticmethod
    def backward(ctx, dy):
        return _raw(dy.contiguous(), ctx.op_t or ctx.op, ctx.n), None, None, None


def block_ell_spmm(
    x: torch.Tensor, sidx: torch.Tensor, w: torch.Tensor, out_s: torch.Tensor,
    out_r: torch.Tensor, out_w: torch.Tensor, n: int, block: int, wp: int,
    mode: str = "split", transpose: BlockEllOperand | None = None,
) -> torch.Tensor:
    """y[i] = Σ_j w[i, j]·x[sidx[i, j]] + outliers, x float32 [n, F].

    Replaces ``pallas_block_ell.block_ell_spmm``.  Differentiable in x; the
    tables get no gradient.  ``transpose``: the plan of Aᵀ for a graph that
    is not symmetric (None: the backward reuses the forward).
    """
    if mode not in ("split", "fast"):
        raise ValueError(f"mode must be 'split' or 'fast', got {mode!r}")
    op = BlockEllOperand(sidx, w, out_s, out_r, out_w, int(block), int(wp))
    return _BlockEll.apply(x, op, transpose, int(n))
