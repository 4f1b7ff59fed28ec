"""Sparse message passing: SpMM over ELL tables or COO, SDDMM, segment sums.

Port of ``gcn_maxcut_tpu/ops/segment.py``.  ``spmm`` takes the ELL
gather-sum when the graph carries ELL tables and the requested weighting is
stored, else the COO path (``index_add_`` by receiver).  The ELL backward
reuses the forward (Aᵀ·dy = A·dy) only for graphs marked symmetric; any
other graph scatters its transpose.  The block-ELL kernel route of the JAX
dispatcher is not in this port yet.
"""

from __future__ import annotations

import torch

from gcn_maxcut_tpu_torch.core.graph import Graph


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
    # d row gathers, summed in column order (the JAX package's order)
    out = w[:, 0:1] * x[nbr[:, 0]]
    for j in range(1, nbr.shape[1]):
        out = out + w[:, j : j + 1] * x[nbr[:, j]]
    return out


def _ell_sum_transpose(x: torch.Tensor, nbr: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    # Aᵀ·x for a general ELL operator: scatter each row's weighted value
    out = torch.zeros_like(x)
    for j in range(nbr.shape[1]):
        out.index_add_(0, nbr[:, j], w[:, j : j + 1] * x)
    return out


class _EllGatherSum(torch.autograd.Function):
    """y[i] = Σ_j w[i, j] · x[nbr[i, j]], differentiable in x."""

    @staticmethod
    def forward(ctx, x, nbr, w, symmetric):
        ctx.save_for_backward(nbr, w)
        ctx.symmetric = symmetric
        return _ell_sum(x, nbr, w)

    @staticmethod
    def backward(ctx, dy):
        nbr, w = ctx.saved_tensors
        if ctx.symmetric:
            dx = _ell_sum(dy, nbr, w)
        else:
            dx = _ell_sum_transpose(dy, nbr, w)
        return dx, None, None, None


def spmm_ell(g: Graph, x: torch.Tensor, edge_weights_mode: str = "mask") -> torch.Tensor:
    """ELL SpMM: ``'mask'`` aggregates unweighted over real edges (the
    GraphConv case), ``'weights'`` uses the edge weights."""
    w = g.ell_mask if edge_weights_mode == "mask" else g.ell_weights
    return _EllGatherSum.apply(x, g.ell_senders.long(), w, g.symmetric)


def spmm(
    g: Graph, x: torch.Tensor, edge_weights: torch.Tensor | None = None
) -> torch.Tensor:
    """Dispatching SpMM: ELL when the graph carries ELL tables and
    ``edge_weights`` is None (unweighted) or ``g.weights``; else COO."""
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
