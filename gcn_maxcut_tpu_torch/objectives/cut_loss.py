"""Differentiable k-way cut objectives in edge form.

Port of ``gcn_maxcut_tpu/objectives/cut_loss.py``:

    HC(S) = ½ Σ_{(u,v) ∈ E_directed} w_uv · (1 − ⟨s_u, s_v⟩)

over the padded directed edge list (the ½ undoes storing both directions),
never materialising n×n.  The training loss is −C·HC; the quantile loss
(``quantile_cut_loss``) trains on the closed-form mean and spread of the
sampled decode's cut instead.
"""

from __future__ import annotations

import torch

from gcn_maxcut_tpu_torch.core.graph import Graph
from gcn_maxcut_tpu_torch.ops.segment import sddmm


def relaxed_cut_value(g: Graph, s: torch.Tensor) -> torch.Tensor:
    """Total (relaxed) weight of edges whose endpoints differ; ``s`` is
    [n_pad, k] (probabilities or one-hots — then it is the exact cut)."""
    same_prob = sddmm(g, s, s)
    per_edge = g.weights * (g.edge_mask - same_prob * g.edge_mask)
    return torch.sum(per_edge) / 2.0


def sampled_cut_stats(g: Graph, s: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, variance) of the cut when every node draws its class from its
    row of ``s`` independently (the sampled decode): per undirected edge the
    crossing is Bernoulli(p_e), p_e = 1 − ⟨s_u, s_v⟩, so

        mean = Σ_e w_e p_e          variance ≈ Σ_e w_e² p_e (1 − p_e)

    with the covariance of edges that share a node dropped; both over the
    directed edge list with the ½ factor."""
    same = sddmm(g, s, s)
    pe = (1.0 - same) * g.edge_mask
    mean = torch.sum(g.weights * pe) / 2.0
    var = torch.sum(g.weights ** 2 * pe * same) / 2.0
    return mean, var


def quantile_cut_loss(
    g: Graph, s: torch.Tensor, c: float = 2.6, C: float = 1.0
) -> torch.Tensor:
    """loss = −C · (mean + c·std) of the sampled decode's cut: the expected
    best of N draws is about mean + c·std (c ≈ 2.6 for N = 200)."""
    mean, var = sampled_cut_stats(g, s)
    return -C * (mean + c * torch.sqrt(var + 1e-9))


def cut_loss(g: Graph, s: torch.Tensor, C: float = 1.0) -> torch.Tensor:
    """loss = C · (−HC)."""
    return C * (-relaxed_cut_value(g, s))


def terminal_independence_penalty(
    s: torch.Tensor, num_terminals: int = 3
) -> torch.Tensor:
    """Σ_{i<j} <s_ti, s_tj> over terminal rows 0..t-1."""
    t = s[:num_terminals]
    gram = t @ t.T
    return (torch.sum(gram) - torch.trace(gram)) / 2.0


def compute_loss(
    g: Graph,
    s: torch.Tensor,
    A: float = 0.0,
    C: float = 1.0,
    penalty: float = 0.0,
    num_terminals: int = 3,
) -> torch.Tensor:
    """Training loss: −C·HC, plus ``penalty`` times the terminal
    independence term when ``penalty`` is nonzero.  ``A`` is accepted for
    config parity and unused, as in the reference."""
    del A
    loss = cut_loss(g, s, C)
    if penalty:
        loss = loss + penalty * terminal_independence_penalty(s, num_terminals)
    return loss


def hard_cut_value(g: Graph, assignment: torch.Tensor) -> torch.Tensor:
    """Exact cut value of integer assignments ``[..., n_pad]``; leading
    dimensions are a batch of assignments."""
    s = g.senders.long()
    r = g.receivers.long()
    differs = (assignment[..., s] != assignment[..., r]).to(torch.float32)
    return torch.sum(g.weights * g.edge_mask * differs, dim=-1) / 2.0


def balance_penalty(g: Graph, s: torch.Tensor) -> torch.Tensor:
    """Squared deviation of the (masked) partition sizes from n / k, the
    target in ``s``'s dtype."""
    sizes = torch.sum(s * g.node_mask[:, None], dim=0)
    target = g.n_nodes.to(s.dtype) / s.shape[-1]
    return torch.sum((sizes - target) ** 2)


def find_ac_parameters(g: Graph) -> tuple[torch.Tensor, torch.Tensor]:
    """(A, C) = (maxdeg + 1, maxdeg / 2) over the real nodes."""
    max_degree = torch.max(g.degrees * g.node_mask)
    return max_degree + 1.0, max_degree / 2.0
