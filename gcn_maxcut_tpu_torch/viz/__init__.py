"""viz: see the counterpart in gcn_maxcut_tpu/viz/."""

from gcn_maxcut_tpu_torch.viz.charts import (
    bar_plot_3,
    bar_plot_3_dot,
    bar_plot_2,
    bar_plot_speedup,
    bar_plot_generic_dot,
    bar_plot_speedup_dot,
    bar_plot_2_speedup,
    generate_sample_baseline_data,
    create_line_graph,
    create_test_visualizations,
    plot_loss_history,
    HAS_MATPLOTLIB,
)

__all__ = [
    "bar_plot_3",
    "bar_plot_3_dot",
    "bar_plot_2",
    "bar_plot_speedup",
    "bar_plot_generic_dot",
    "bar_plot_speedup_dot",
    "bar_plot_2_speedup",
    "generate_sample_baseline_data",
    "create_line_graph",
    "create_test_visualizations",
    "plot_loss_history",
    "HAS_MATPLOTLIB",
]
