"""Sparse message passing: SpMM over ELL tables or COO, SDDMM, segment sums.

Port of ``gcn_maxcut_tpu/ops/segment.py``.  ``spmm`` dispatches in the
JAX package's order: the block-ELL kernel (``ops/block_ell.py``) when the
graph carries a plan, else the ELL gather-sum when the graph carries ELL
tables, else the COO path (``index_add_`` by receiver); the two table paths
only for a stored weighting.  The ELL and block-ELL backwards reuse the
forward (Aᵀ·dy = A·dy) only for graphs marked symmetric; any other graph
scatters its ELL transpose or runs the kernel on its transposed plan.
"""

from __future__ import annotations

import torch

from gcn_maxcut_tpu_torch.core.graph import Graph
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


def sddmm(g: Graph, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Per-edge scores e = <x[sender], y[receiver]>, zero on padded edges."""
    scores = torch.sum(x[g.senders.long()] * y[g.receivers.long()], dim=-1)
    return scores * g.edge_mask


def segment_sum_edges(g: Graph, edge_values: torch.Tensor) -> torch.Tensor:
    """Sum per-edge values into their receiver nodes: [e_pad] -> [n_pad]."""
    out = torch.zeros(g.n_pad, dtype=edge_values.dtype, device=edge_values.device)
    return out.index_add(0, g.receivers.long(), edge_values * g.edge_mask)
