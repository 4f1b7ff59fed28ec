"""Port parity: the chart library (``viz/charts.py``) against the JAX
package's.  Each chart function gets the same inputs in both packages; the
figures must hold the same artist data (bar heights and positions, line
data, texts, titles, labels and scales), and the port's writes its file.
"""

import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch

import gcn_maxcut_tpu.viz as jviz
import gcn_maxcut_tpu_torch.viz as tviz

BY_SIZE = {
    50: {"simple": {"cut_values": [10, 12], "times": [0.1, 0.2]},
         "post_processed": {"cut_values": [11, 13], "times": [0.3, 0.4]}},
    100: {"simple": {"cut_values": [30, 32, 29], "times": [0.2, 0.2, 0.3]},
          "post_processed": {"cut_values": [33, 32, 31], "times": [0.5, 0.6, 0.4]}},
}
CATS = ["n=50", "n=100"]

CASES = {
    "bar_plot_3": lambda v: v.bar_plot_3(
        CATS, {"Solver": [100, 200], "Randomized": [80, 150], "GCN": [95, 190]},
        annotate_percent_of="Solver"),
    "bar_plot_3_dot": lambda v: v.bar_plot_3_dot(
        CATS, {"a": [1, 2], "b": [2, 1], "c": [3, 3], "d": [0.5, 4]}, title="t"),
    "bar_plot_2": lambda v: v.bar_plot_2(CATS, [1, 2], [3, 4], labels=("x", "y")),
    "bar_plot_speedup": lambda v: v.bar_plot_speedup(CATS, {"Solver": [3.0, 9.0],
                                                            "GCN": [0.4, 0.05]}),
    "bar_plot_generic_dot": lambda v: v.bar_plot_generic_dot(
        CATS, {"GCN": [90, 180], "post": [95, 190]},
        std_percent={"GCN": [5, 3]}, dot_overlay={"post": [90, 180]},
        annotate_percent_of="post", y_lim=250),
    "bar_plot_speedup_dot": lambda v: v.bar_plot_speedup_dot(
        CATS, {"GCN": [0.1, 0.2], "post": [0.3, 0.5]}, std_percent={"post": [10, 20]},
        dot_overlay={"GCN": [0.05, 0.1]}, y_lim=1.0),
    "bar_plot_2_speedup": lambda v: v.bar_plot_2_speedup(CATS, [0.1, 0.2], [0.3, 0.4],
                                                         std_percent=[4, 6]),
    "create_line_graph": lambda v: v.create_line_graph(
        [50, 100], {"GCN": [90, 180], "post": [95, 185]}, optimum=[100, 200]),
    "create_test_visualizations": lambda v: v.create_test_visualizations(
        [{"improvement_percent": 5.0}, {"improvement_percent": -1.0},
         {"improvement_percent": 2.5}], BY_SIZE, [50, 100]),
    "plot_loss_history": lambda v: v.plot_loss_history([-10.0, -50.0, -100.0, -120.5]),
}


def _artists(fig):
    out = []
    for ax in fig.axes:
        out.append({
            "bars": [(p.get_x(), p.get_width(), p.get_height()) for p in ax.patches],
            "lines": [line.get_xydata().tolist() for line in ax.lines],
            "texts": [(t.get_text(), tuple(np.round(t.xy, 9)) if hasattr(t, "xy") else None)
                      for t in ax.texts],
            "labels": (ax.get_title(), ax.get_xlabel(), ax.get_ylabel(), ax.get_yscale(),
                       [t.get_text() for t in ax.get_xticklabels()]),
            "legend": ([t.get_text() for t in ax.get_legend().get_texts()]
                       if ax.get_legend() else None),
            "ylim": ax.get_ylim(),
        })
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_chart_matches_jax(name, tmp_path):
    assert tviz.HAS_MATPLOTLIB and jviz.HAS_MATPLOTLIB
    fig_j, fig_t = CASES[name](jviz), CASES[name](tviz)
    assert _artists(fig_t) == _artists(fig_j)
    plt.close(fig_j)
    plt.close(fig_t)


def test_charts_write_their_files(tmp_path):
    path = tmp_path / "b3.png"
    tviz.bar_plot_3(CATS, {"a": [1, 2], "b": [2, 3]}, save_path=str(path))
    assert path.stat().st_size > 0
    path = tmp_path / "panel.png"
    tviz.create_test_visualizations([{"improvement_percent": 1.0}], BY_SIZE, [50, 100],
                                    save_path=str(path))
    assert path.stat().st_size > 0
    plt.close("all")


def test_loss_history_takes_tensors(tmp_path):
    floats = [-10.0, -50.0, -100.0]
    ref = _artists(tviz.plot_loss_history(floats))
    assert _artists(tviz.plot_loss_history(torch.tensor(floats))) == ref
    path = tmp_path / "loss.png"
    fig = tviz.plot_loss_history([torch.tensor(x) for x in floats], save_path=str(path))
    assert _artists(fig) == ref and path.stat().st_size > 0
    plt.close("all")


def test_exports_match_jax():
    assert tviz.__all__ == jviz.__all__
