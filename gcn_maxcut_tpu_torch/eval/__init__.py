"""eval: see the counterpart in gcn_maxcut_tpu/eval/.

The harness functions keep the JAX names ``test_single_graph`` and
``test_multiple_graphs``: a test file imports the module, not these names,
or pytest collects them as tests.
"""

from gcn_maxcut_tpu_torch.eval.decode import (
    post_process,
    sample_partitions,
    simple_assignment,
    terminal_permutation_search,
)
from gcn_maxcut_tpu_torch.eval.harness import (
    analyze_results,
    generate_summary_report,
    load_results,
    print_analysis_report,
    save_results,
    test_multiple_graphs,
    test_single_graph,
)

__all__ = [
    "simple_assignment",
    "sample_partitions",
    "post_process",
    "terminal_permutation_search",
    "test_single_graph",
    "test_multiple_graphs",
    "analyze_results",
    "print_analysis_report",
    "generate_summary_report",
    "save_results",
    "load_results",
]
