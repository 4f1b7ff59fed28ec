"""GraphConv (DGL ``norm='both'``) and the GCNSoftmax model.

Port of ``gcn_maxcut_tpu/models/gcn.py``:

    h' = D̃^{-1/2} · A · (D̃^{-1/2} · X) · W + b

with no self-loops, degrees clamped to at least 1, edge weights ignored by
the aggregation, and the projection applied first when in > out (the same
product in the other order).  Weights are Glorot-uniform ``[in, out]`` (the
JAX layout, kept as is), biases zero.  ``gcn_conv_apply`` and
``gcn_softmax_apply`` are plain functions over a parameter dict
``{"conv1": {"w", "b"}, "conv2": {"w", "b"}}``; ``GCNSoftmax`` is the
``nn.Module`` that owns those parameters.  Both take a batch as well: a
stacked graph (``pad_graph_batch``) with ``x`` [G, n_pad, in] and
``a_dense`` [G, n_pad, n_pad] runs every aggregation as one batched GEMM.
``gcn_dev_*`` is the legacy 2-way QUBO model, conv → ReLU → conv →
sigmoid, on the same layer and its order rule.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from gcn_maxcut_tpu_torch.core.graph import Graph
from gcn_maxcut_tpu_torch.ops.segment import spmm


def _glorot_uniform(
    shape: tuple[int, int], generator: torch.Generator, device=None
) -> torch.Tensor:
    fan_in, fan_out = shape
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(shape, generator=generator, dtype=torch.float32, device=device)
    return u * (2 * limit) - limit


def gcn_conv_init(
    in_feats: int, out_feats: int, generator: torch.Generator, device=None
) -> Dict[str, torch.Tensor]:
    return {
        "w": _glorot_uniform((in_feats, out_feats), generator, device),
        "b": torch.zeros(out_feats, dtype=torch.float32, device=device),
    }


def gcn_conv_apply(
    params: Dict[str, torch.Tensor],
    g: Graph,
    x: torch.Tensor,
    *,
    a_dense: torch.Tensor | None = None,
) -> torch.Tensor:
    """Symmetric-normalised graph convolution.  ``a_dense`` is an optional
    [n_pad, n_pad] unweighted adjacency (``dense_adjacency(g, values=
    "mask")``): aggregation is then one dense matmul instead of the sparse
    path; with a leading batch dimension on ``g``, ``x`` and ``a_dense`` it
    is a batched matmul."""
    norm = torch.rsqrt(torch.clamp(g.degrees, min=1.0))[..., None]
    if a_dense is not None:
        aggregate = lambda h: a_dense @ h  # noqa: E731
    else:
        aggregate = lambda h: spmm(g, h)  # noqa: E731
    in_feats, out_feats = params["w"].shape
    h = x * norm
    if in_feats > out_feats:
        h = aggregate(h @ params["w"])
    else:
        h = aggregate(h) @ params["w"]
    return h * norm + params["b"]


def gcn_softmax_apply(
    params: Dict[str, Dict[str, torch.Tensor]],
    g: Graph,
    x: torch.Tensor,
    *,
    dropout: float = 0.0,
    train: bool = False,
    generator: torch.Generator | None = None,
    a_dense: torch.Tensor | None = None,
) -> torch.Tensor:
    """conv1 -> ReLU -> dropout -> conv2 -> softmax; returns [n_pad, k]."""
    h = torch.relu(gcn_conv_apply(params["conv1"], g, x, a_dense=a_dense))
    if train and dropout > 0.0:
        if generator is None:
            raise ValueError("generator required when train=True and dropout>0")
        keep = torch.rand(h.shape, generator=generator, device=h.device) < 1.0 - dropout
        h = torch.where(keep, h / (1.0 - dropout), torch.zeros_like(h))
    h = gcn_conv_apply(params["conv2"], g, h, a_dense=a_dense)
    return torch.softmax(h, dim=-1)


class GCNConv(nn.Module):
    """One GraphConv layer's parameters, ``w`` [in, out] and ``b`` [out]."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)

    def params(self) -> Dict[str, torch.Tensor]:
        return {"w": self.w, "b": self.b}


class GCNSoftmax(nn.Module):
    """conv1 -> ReLU -> dropout -> conv2 -> softmax (reference
    ``GCNSoftmax``, 1000 -> 500 -> 3 in the recipe)."""

    def __init__(self, params: Dict[str, Dict[str, torch.Tensor]], dropout: float = 0.0):
        super().__init__()
        self.conv1 = GCNConv(params["conv1"]["w"], params["conv1"]["b"])
        self.conv2 = GCNConv(params["conv2"]["w"], params["conv2"]["b"])
        self.dropout = dropout

    @classmethod
    def init(
        cls, in_feats: int, hidden: int, num_classes: int,
        generator: torch.Generator, device=None, dropout: float = 0.0,
    ) -> "GCNSoftmax":
        return cls({
            "conv1": gcn_conv_init(in_feats, hidden, generator, device),
            "conv2": gcn_conv_init(hidden, num_classes, generator, device),
        }, dropout)

    def params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {"conv1": self.conv1.params(), "conv2": self.conv2.params()}

    def forward(
        self,
        g: Graph,
        x: torch.Tensor,
        *,
        a_dense: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
    ) -> torch.Tensor:
        return gcn_softmax_apply(
            self.params(), g, x, dropout=self.dropout, train=self.training,
            generator=generator, a_dense=a_dense,
        )


def gcn_dev_init(
    in_feats: int, hidden: int, out: int = 1, *,
    generator: torch.Generator, device=None,
) -> Dict[str, Dict[str, torch.Tensor]]:
    """Parameters of the legacy QUBO model, ``{"conv1", "conv2"}``."""
    return {
        "conv1": gcn_conv_init(in_feats, hidden, generator, device),
        "conv2": gcn_conv_init(hidden, out, generator, device),
    }


def gcn_dev_apply(
    params: Dict[str, Dict[str, torch.Tensor]], g: Graph, x: torch.Tensor
) -> torch.Tensor:
    """conv → ReLU → conv → sigmoid; each layer projects first when
    in > out, as ``gcn_conv_apply`` does."""
    h = torch.relu(gcn_conv_apply(params["conv1"], g, x))
    return torch.sigmoid(gcn_conv_apply(params["conv2"], g, h))


def count_params(params) -> int:
    """Number of scalars in a nested dict of tensors."""
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return int(params.numel())


def embedding_init(
    n_nodes: int, dim: int, generator: torch.Generator, device=None
) -> torch.Tensor:
    """Node-embedding table, N(0, 1) like ``torch.nn.Embedding``."""
    return torch.randn(
        (n_nodes, dim), generator=generator, dtype=torch.float32, device=device
    )
