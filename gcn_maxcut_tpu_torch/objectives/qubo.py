"""The max-cut QUBO of the legacy 2-way (PI-GNN) formulation, in edge form.

Port of ``gcn_maxcut_tpu/objectives/qubo.py``.  Q_uv = w_uv off the
diagonal and Q_uu = −deg_w(u), so

    xᵀ Q x = Σ_{(u,v) ∈ E} w_uv · (2 x_u x_v − x_u − x_v) = −cut(x)

for binary x, summed over the padded directed edge list without building Q.
"""

from __future__ import annotations

import torch

from gcn_maxcut_tpu_torch.core.graph import Graph


def maxcut_qubo_edges(g: Graph, x: torch.Tensor) -> torch.Tensor:
    """Each directed edge's share ``w·(2 x_u x_v − x_u − x_v) / 2``."""
    xu = x[g.senders.long()]
    xv = x[g.receivers.long()]
    return g.weights * g.edge_mask * (2.0 * xu * xv - xu - xv) / 2.0


def qubo_loss(g: Graph, x: torch.Tensor) -> torch.Tensor:
    """xᵀ Q x for ``x`` [n_pad] in [0, 1]; −cut(x) on binary x."""
    return torch.sum(maxcut_qubo_edges(g, x))
