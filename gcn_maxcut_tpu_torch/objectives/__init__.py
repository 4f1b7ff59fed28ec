"""objectives: see the counterpart in gcn_maxcut_tpu/objectives/."""

from gcn_maxcut_tpu_torch.objectives.cut_loss import (
    balance_penalty,
    compute_loss,
    cut_loss,
    find_ac_parameters,
    hard_cut_value,
    quantile_cut_loss,
    relaxed_cut_value,
    sampled_cut_stats,
    terminal_independence_penalty,
)
from gcn_maxcut_tpu_torch.objectives.qubo import maxcut_qubo_edges, qubo_loss

__all__ = [
    "relaxed_cut_value",
    "cut_loss",
    "compute_loss",
    "sampled_cut_stats",
    "quantile_cut_loss",
    "terminal_independence_penalty",
    "balance_penalty",
    "find_ac_parameters",
    "hard_cut_value",
    "qubo_loss",
    "maxcut_qubo_edges",
]
