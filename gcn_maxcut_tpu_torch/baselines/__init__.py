"""baselines: see the counterpart in gcn_maxcut_tpu/baselines/.

The randomized baseline and its harnesses, the local searches (greedy
flips, simulated annealing, BLS, the recursive split), the native sweep,
and the exact and anytime solvers (brute force, the flow min-cut, the
batched SA chains, the balanced repair), with the JAX package's fourteen
exports.
"""

from gcn_maxcut_tpu_torch.baselines.exact import (
    anytime_solver,
    brute_force_maxcut,
    recursive_flow_min_cut,
    solver_balanced,
)
from gcn_maxcut_tpu_torch.baselines.local_search import (
    breakout_local_search,
    greedy_flip_local_search,
    multi_max_cut_recursive,
    simulated_annealing,
)
from gcn_maxcut_tpu_torch.baselines.randomized import (
    benchmark_algorithm,
    evaluate_algorithm_on_graphs,
    quick_demo,
    randomized_k_way_maxcut,
    test_fixed_terminals,
)
from gcn_maxcut_tpu_torch.baselines.sweep import greedy_sweep_maxcut

__all__ = [
    "randomized_k_way_maxcut",
    "evaluate_algorithm_on_graphs",
    "benchmark_algorithm",
    "test_fixed_terminals",
    "quick_demo",
    "greedy_flip_local_search",
    "greedy_sweep_maxcut",
    "simulated_annealing",
    "breakout_local_search",
    "multi_max_cut_recursive",
    "brute_force_maxcut",
    "recursive_flow_min_cut",
    "anytime_solver",
    "solver_balanced",
]
