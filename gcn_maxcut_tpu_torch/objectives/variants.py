"""The loss-variant zoo for ablations, in edge form.

Port of ``gcn_maxcut_tpu/objectives/variants.py``: the reference's legacy
loss variants, each O(E·k) over the padded directed edge list (through
``ops.segment.sddmm`` or per-edge gathers), never an n×n matrix.

  * ``ha_one_hot_penalty``: Σ over real nodes of (1 − ||s_i||²);
  * ``intra_partition_weight``: Σ_E w·⟨s_u, s_v⟩ (halved);
  * ``min_cut_intra_inter``: β·inter − α·intra;
  * ``min_cut_loss_pairwise``: Σ over class pairs of the relaxed weight
    between them;
  * ``per_partition_cut``: each class's relaxed boundary weight;
  * ``weighted_cut_loss``: C·(−HC) + A·HA.
"""

from __future__ import annotations

import torch

from gcn_maxcut_tpu_torch.core.graph import Graph
from gcn_maxcut_tpu_torch.objectives.cut_loss import relaxed_cut_value
from gcn_maxcut_tpu_torch.ops.segment import sddmm


def ha_one_hot_penalty(g: Graph, s: torch.Tensor) -> torch.Tensor:
    """HA: Σ over real nodes of (1 − ||s_i||²); zero iff every row is one-hot."""
    sq = torch.sum(s * s, dim=-1)
    return torch.sum(g.node_mask * (1.0 - sq))


def intra_partition_weight(g: Graph, s: torch.Tensor) -> torch.Tensor:
    """Relaxed weight of the edges inside partitions: Σ_E w·⟨s_u, s_v⟩."""
    return torch.sum(g.weights * sddmm(g, s, s)) / 2.0


def min_cut_intra_inter(
    g: Graph, s: torch.Tensor, alpha: float = 1.0, beta: float = 1.0
) -> torch.Tensor:
    """β·inter − α·intra (lower means denser partitions)."""
    return beta * relaxed_cut_value(g, s) - alpha * intra_partition_weight(g, s)


def min_cut_loss_pairwise(g: Graph, s: torch.Tensor) -> torch.Tensor:
    """Σ_{a<b} relaxed weight between classes a and b; equal to the relaxed
    cut for rows that sum to one."""
    k = s.shape[-1]
    total = torch.zeros((), dtype=s.dtype, device=s.device)
    for a in range(k):
        for b in range(a + 1, k):
            cross = sddmm(g, s[:, a : a + 1], s[:, b : b + 1]) + sddmm(
                g, s[:, b : b + 1], s[:, a : a + 1]
            )
            total = total + torch.sum(g.weights * cross) / 2.0
    return total


def per_partition_cut(g: Graph, s: torch.Tensor) -> torch.Tensor:
    """[k]: each class's relaxed boundary weight Σ_E w·s_u,c·(1 − s_v,c)."""
    su = s[g.senders.long()]
    sv = s[g.receivers.long()]
    contrib = su * (1.0 - sv) * (g.weights * g.edge_mask)[:, None]
    return torch.sum(contrib, dim=0) / 2.0


def weighted_cut_loss(
    g: Graph, s: torch.Tensor, A: float = 0.0, C: float = 1.0
) -> torch.Tensor:
    """The legacy two-term objective C·(−HC) + A·HA."""
    loss = C * (-relaxed_cut_value(g, s))
    if A:
        loss = loss + A * ha_one_hot_penalty(g, s)
    return loss
