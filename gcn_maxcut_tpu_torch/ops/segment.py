"""Sparse message passing: SpMM over ELL tables or COO, SDDMM, segment sums.

Port of ``gcn_maxcut_tpu/ops/segment.py``.  ``spmm`` dispatches in the
JAX package's order: the block-ELL kernel (``ops/block_ell.py``) when the
graph carries a plan, else the ELL gather-sum when the graph carries ELL
tables, else the COO path (``index_add_`` by receiver); the two table paths
only for a stored weighting.  The ELL and block-ELL backwards reuse the
forward (Aᵀ·dy = A·dy) only for graphs marked symmetric; any other graph
scatters its ELL transpose or runs the kernel on its transposed plan.

``sddmm`` (per-edge scores, the cut loss's building block) routes by the
operands' device: on the CPU ``sddmm_plain``, two advanced-index gathers
and a row sum, whose backward PyTorch runs as ``index_put_(accumulate=
True)`` (a stable sort of the indices, then a walk over each run of equal
ones); on a card ``csrc/sddmm.cu``, one launch forward and one backward,
or it raises.  The kernel's backward gives each (node, class) pair one
thread, which sums that node's real edges in ascending edge id: its
in-edges from ``row_ptr`` (up to ``n_edges``), its out-edges from the
sender-order table (``sender_order``, ``sender_ptr``, built by
``core/graph._build_padded_coo``).  That is the order of the plain
backward's stable sort, and the forward sums each row in ``torch.sum``'s
order on the card, so on a card the two give the same bits (zeros up to
their sign).  When x and y are one tensor, as in every cut loss, one
launch writes its gradient dx + dy.  Both launches read ``n_edges`` on the
device and allocate through PyTorch's caching allocator, so the op
captures into a CUDA graph (``train/chunks.py``).  ``ops/launches.py``
counts them under ``sddmm`` and ``sddmm_backward``.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.autograd.function import once_differentiable

from gcn_maxcut_tpu_torch import build
from gcn_maxcut_tpu_torch.core.graph import Graph
from gcn_maxcut_tpu_torch.ops import launches
from gcn_maxcut_tpu_torch.ops.block_ell import BlockEllOperand, block_ell_spmm


def spmm_coo(
    g: Graph, x: torch.Tensor, edge_weights: torch.Tensor | None = None
) -> torch.Tensor:
    """y[r] = Σ_{(s -> r) ∈ E} w_e · x[s]; unweighted over real edges when
    ``edge_weights`` is None."""
    w = g.edge_mask if edge_weights is None else edge_weights
    msgs = x[g.senders.long()] * w[:, None]
    out = torch.zeros((g.n_pad, x.shape[-1]), dtype=msgs.dtype, device=x.device)
    return out.index_add(0, g.receivers.long(), msgs)


def _ell_sum(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    # d row gathers, summed in column order (the JAX package's order); bf16
    # rows are widened to float32 before the multiply, the sum is float32
    out = w[:, 0:1] * x[nbr[:, 0]].float()
    for j in range(1, nbr.shape[1]):
        out = out + w[:, j : j + 1] * x[nbr[:, j]].float()
    return out


def _ell_sum_transpose(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    # Aᵀ·x for a general ELL operator: scatter each row's weighted value
    out = torch.zeros_like(x)
    for j in range(nbr.shape[1]):
        out.index_add_(0, nbr[:, j], w[:, j : j + 1] * x)
    return out


class _EllGatherSum(torch.autograd.Function):
    """y[i] = Σ_j w[i, j] · x[nbr[i, j]], differentiable in x.  A bfloat16
    x gives a float32 y; its backward gathers the cotangent in bfloat16 and
    returns a bfloat16 gradient, as the JAX package does."""

    @staticmethod
    def forward(ctx, x, nbr, w, symmetric):
        ctx.save_for_backward(nbr, w)
        ctx.symmetric = symmetric
        ctx.bf16 = x.dtype == torch.bfloat16
        return _ell_sum(x, nbr, w)

    @staticmethod
    def backward(ctx, dy):
        nbr, w = ctx.saved_tensors
        if ctx.bf16:
            dy = dy.to(torch.bfloat16)
        if ctx.symmetric:
            dx = _ell_sum(dy, nbr, w)
        else:
            dx = _ell_sum_transpose(dy.float(), nbr, w)
        if ctx.bf16:
            dx = dx.to(torch.bfloat16)
        return dx, None, None, None


def spmm_ell(g: Graph, x: torch.Tensor, edge_weights_mode: str = "mask") -> torch.Tensor:
    """ELL SpMM: ``'mask'`` aggregates unweighted over real edges (the
    GraphConv case), ``'weights'`` uses the edge weights."""
    w = g.ell_mask if edge_weights_mode == "mask" else g.ell_weights
    return _EllGatherSum.apply(x, g.ell_senders.long(), w, g.symmetric)


def _spmm_block_ell(g: Graph, x: torch.Tensor, mode: str) -> torch.Tensor:
    """The block-ELL kernel path; the backward runs on the transposed plan
    for a graph that is not symmetric."""
    def operand(p: str) -> BlockEllOperand:
        return BlockEllOperand(
            getattr(g, f"{p}senders"),
            getattr(g, f"{p}mask" if mode == "mask" else f"{p}weights"),
            getattr(g, f"{p}out_senders"), getattr(g, f"{p}out_receivers"),
            getattr(g, f"{p}out_mask" if mode == "mask" else f"{p}out_weights"),
            getattr(g, f"{p}block"), getattr(g, f"{p}wp"),
        )

    op = operand("bell_")
    op_t = None
    if not g.symmetric:
        if g.bell_t_block is None:
            raise ValueError("a graph that is not symmetric needs the plan of its transpose")
        op_t = operand("bell_t_")
    return block_ell_spmm(x, *op[:5], g.n_pad, op.block, op.wp, transpose=op_t)


def spmm(
    g: Graph,
    x: torch.Tensor,
    edge_weights: torch.Tensor | None = None,
    feature_dtype: torch.dtype | str | None = None,
) -> torch.Tensor:
    """Dispatching SpMM: the block-ELL kernel when the graph carries a plan,
    else ELL when it carries ELL tables, each when ``edge_weights`` is None
    (unweighted) or ``g.weights``; else COO.

    ``feature_dtype="bfloat16"`` (or a bfloat16 x) sends the ELL gather
    half-width rows with float32 sums.  A plan wins over any dtype request:
    its kernel takes float32, so x is cast back to float32 there.
    """
    if g.bell_block is not None and (edge_weights is None or edge_weights is g.weights):
        mode = "mask" if edge_weights is None else "weights"
        return _spmm_block_ell(g, x.float(), mode)
    if feature_dtype is not None:
        x = x.to(getattr(torch, feature_dtype) if isinstance(feature_dtype, str) else feature_dtype)
    if g.ell_senders is not None:
        if edge_weights is None:
            return spmm_ell(g, x, "mask")
        if edge_weights is g.weights:
            return spmm_ell(g, x, "weights")
    return spmm_coo(g, x.float(), edge_weights)


# the graph fields the kernels read: dtype and length (e: e_pad, n: n_pad + 1)
_SDDMM_FIELDS = {"senders": (torch.int32, "e"), "receivers": (torch.int32, "e"),
                 "edge_mask": (torch.float32, "e"), "row_ptr": (torch.int32, "n"),
                 "sender_order": (torch.int32, "e"), "sender_ptr": (torch.int32, "n")}


def sddmm_plain(g: Graph, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-edge scores e = <x[sender], y[receiver]>, zero on padded edges,
    in plain PyTorch on any device."""
    scores = torch.sum(x[g.senders.long()] * y[g.receivers.long()], dim=-1)
    return scores * g.edge_mask


@functools.cache
def _sddmm_kernels():
    lib = build.load("sddmm")
    forward, backward = lib.sddmm_forward_launch, lib.sddmm_backward_launch
    forward.argtypes = [*[ctypes.c_void_p] * 6, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    backward.argtypes = [*[ctypes.c_void_p] * 12, *[ctypes.c_int] * 3, ctypes.c_void_p]
    forward.restype = backward.restype = ctypes.c_int
    return forward, backward


def _sddmm_check(g: Graph, x: torch.Tensor, y: torch.Tensor) -> None:
    """The kernels' operand rules, the graph's first and the devices last;
    raises on what they do not take."""
    if g.sender_order is None or g.sender_ptr is None:
        raise ValueError("the graph carries no sender-order table (sender_order, sender_ptr: "
                         "core/graph._build_padded_coo builds it)")
    sizes = {"e": g.e_pad, "n": g.n_pad + 1}
    for name, (dtype, size) in _SDDMM_FIELDS.items():
        t = getattr(g, name)
        if t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"graph field {name} must be contiguous {dtype}, got {t.dtype}")
        if t.shape != (sizes[size],):
            raise ValueError("the kernel takes one graph, not a batch: graph field "
                             f"{name} is {tuple(t.shape)}")
    if g.n_edges.dtype != torch.int32 or g.n_edges.numel() != 1:
        raise ValueError("graph field n_edges must be one int32")
    for name, t in (("x", x), ("y", y)):
        if t.dtype != torch.float32:
            raise ValueError(f"sddmm on the card takes float32 x and y, got {name} {t.dtype}")
        if t.dim() != 2 or t.shape != x.shape or t.shape[0] != g.n_pad or not t.shape[1]:
            raise ValueError(f"x and y must both be [n_pad = {g.n_pad}, k >= 1], got "
                             f"{tuple(x.shape)} and {tuple(y.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    dev = x.device
    if dev.type != "cuda" or y.device != dev:
        raise ValueError(f"sddmm on the card takes x and y on one card, got {x.device} "
                         f"and {y.device}")
    for name in (*_SDDMM_FIELDS, "n_edges"):
        if getattr(g, name).device != dev:
            raise ValueError(f"graph field {name} is on {getattr(g, name).device}, x on {dev}")


class _SddmmKernel(torch.autograd.Function):
    """``csrc/sddmm.cu`` as an autograd op; ``y`` None stands for x."""

    @staticmethod
    def forward(ctx, g: Graph, x: torch.Tensor, y: torch.Tensor | None) -> torch.Tensor:
        other = x if y is None else y
        out = torch.empty(g.e_pad, dtype=torch.float32, device=x.device)
        with torch.cuda.device(x.device):
            err = _sddmm_kernels()[0](
                x.data_ptr(), other.data_ptr(), g.senders.data_ptr(), g.receivers.data_ptr(),
                g.edge_mask.data_ptr(), out.data_ptr(), g.e_pad, x.shape[1],
                torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"sddmm_forward_launch failed: CUDA error {err}")
        launches.LAUNCHES["sddmm"] += 1
        ctx.g, ctx.same = g, y is None
        ctx.save_for_backward(x, other)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, de: torch.Tensor):
        x, y = ctx.saved_tensors
        g = ctx.g
        want_x = ctx.needs_input_grad[1]
        want_y = ctx.needs_input_grad[2] and not ctx.same
        if not (want_x or want_y):
            return None, None, None
        de = de.contiguous()
        if de.dtype != torch.float32 or de.shape != (g.e_pad,):
            raise ValueError(f"sddmm's cotangent must be float32 [{g.e_pad}], got "
                             f"{de.dtype} {tuple(de.shape)}")
        dx = torch.empty_like(x) if want_x else None
        dy = torch.empty_like(y) if want_y else None
        with torch.cuda.device(x.device):
            err = _sddmm_kernels()[1](
                de.data_ptr(), g.edge_mask.data_ptr(), x.data_ptr(), y.data_ptr(),
                g.senders.data_ptr(), g.receivers.data_ptr(), g.row_ptr.data_ptr(),
                g.sender_order.data_ptr(), g.sender_ptr.data_ptr(), g.n_edges.data_ptr(),
                None if dx is None else dx.data_ptr(), None if dy is None else dy.data_ptr(),
                g.n_pad, x.shape[1], int(ctx.same),
                torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"sddmm_backward_launch failed: CUDA error {err}")
        launches.LAUNCHES["sddmm_backward"] += 1
        return None, dx, dy


def sddmm(g: Graph, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-edge scores e = <x[sender], y[receiver]> [e_pad], zero on padded
    edges, for x, y [n_pad, k].  On the CPU ``sddmm_plain``; on a card the
    kernels (operands made contiguous; float32 only, else it raises)."""
    if x.device.type != "cuda" and y.device.type != "cuda":
        return sddmm_plain(g, x, y)
    same = x is y
    x = x.contiguous()
    y = x if same else y.contiguous()
    _sddmm_check(g, x, y)
    return _SddmmKernel.apply(g, x, None if same else y)


def segment_sum_edges(g: Graph, edge_values: torch.Tensor) -> torch.Tensor:
    """Sum per-edge values into their receiver nodes: [e_pad] -> [n_pad]."""
    out = torch.zeros(g.n_pad, dtype=edge_values.dtype, device=edge_values.device)
    return out.index_add(0, g.receivers.long(), edge_values * g.edge_mask)
