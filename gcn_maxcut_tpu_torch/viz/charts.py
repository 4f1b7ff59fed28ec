"""Publication charts (matplotlib, gated) + loss/scaling plots.

Port of ``gcn_maxcut_tpu/viz/charts.py``, the port's own copy of the same
host code (the same functions, arguments and figures);
``plot_loss_history`` also takes a list of 0-d tensors or a tensor, as the
port's trainers return.

Capability parity with the reference's chart library
(``Visualization/NeuralTesting.py``): grouped solver-comparison bars with
%-of-best annotations (``barPlot_3`` :23-136, ``barPlot_3_dot`` :388-563),
runtime/speedup bars (``barPlot_3_speedup`` :140-254), two-series bars
(``barPlot_2`` :911-1010), accuracy-vs-size scalability lines
(``create_line_graph`` :1012-1064), and the 2×2 test-results panel
(``TestingNeuralNetwork.py:430-537``).  All functions take plain data and
return the figure; ``save_path`` writes a 300-dpi PNG like the reference.

matplotlib is optional: importing this module without it keeps the rest of
the framework working; chart calls then raise a clear error.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

try:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    HAS_MATPLOTLIB = True
except ImportError:  # pragma: no cover
    HAS_MATPLOTLIB = False
    plt = None


def _require_mpl():
    if not HAS_MATPLOTLIB:
        raise RuntimeError(
            "matplotlib is not installed; viz module charts are unavailable"
        )


def _finish(fig, save_path: Optional[str]):
    fig.tight_layout()
    if save_path:
        fig.savefig(save_path, dpi=300, bbox_inches="tight")
    return fig


def bar_plot_3(
    categories: Sequence[str],
    series: Dict[str, Sequence[float]],
    title: str = "Algorithm comparison",
    ylabel: str = "Cut value",
    annotate_percent_of: Optional[str] = None,
    save_path: Optional[str] = None,
):
    """Grouped bars for 2–4 algorithms with optional %-of-reference labels.

    Generalizes reference ``barPlot_3``/``barPlot_3_dot``/``barPlot_generic_dot``.
    ``annotate_percent_of``: series name used as 100% (e.g. the solver).
    """
    _require_mpl()
    names = list(series)
    x = np.arange(len(categories))
    width = 0.8 / len(names)
    fig, ax = plt.subplots(figsize=(max(8, len(categories) * 1.5), 5))
    ref_vals = np.asarray(series[annotate_percent_of]) if annotate_percent_of else None
    for i, name in enumerate(names):
        vals = np.asarray(series[name], dtype=float)
        bars = ax.bar(x + (i - (len(names) - 1) / 2) * width, vals, width, label=name)
        if ref_vals is not None and name != annotate_percent_of:
            for b, v, r in zip(bars, vals, ref_vals):
                if r > 0:
                    ax.annotate(
                        f"{100 * v / r:.0f}%",
                        (b.get_x() + b.get_width() / 2, b.get_height()),
                        ha="center", va="bottom", fontsize=8,
                    )
    ax.set_xticks(x)
    ax.set_xticklabels(categories)
    ax.set_ylabel(ylabel)
    ax.set_title(title)
    ax.legend()
    return _finish(fig, save_path)


# Reference-compatible aliases with its arities
def bar_plot_3_dot(categories, series, **kwargs):
    """4-series variant (solver / randomized / GCN / GCN+post), ref :388-563."""
    return bar_plot_3(categories, series, **kwargs)


def bar_plot_2(categories, series_a, series_b, labels=("A", "B"), **kwargs):
    """Two-series bars (reference ``barPlot_2`` :911-1010)."""
    return bar_plot_3(
        categories, {labels[0]: series_a, labels[1]: series_b}, **kwargs
    )


def bar_plot_speedup(
    categories: Sequence[str],
    times: Dict[str, Sequence[float]],
    title: str = "Runtime comparison",
    save_path: Optional[str] = None,
):
    """Runtime bars with 'Ns' labels (reference ``barPlot_3_speedup`` :140-254)."""
    _require_mpl()
    names = list(times)
    x = np.arange(len(categories))
    width = 0.8 / len(names)
    fig, ax = plt.subplots(figsize=(max(8, len(categories) * 1.5), 5))
    for i, name in enumerate(names):
        vals = np.asarray(times[name], dtype=float)
        bars = ax.bar(x + (i - (len(names) - 1) / 2) * width, vals, width, label=name)
        for b, v in zip(bars, vals):
            ax.annotate(
                f"{v:.2g}s",
                (b.get_x() + b.get_width() / 2, b.get_height()),
                ha="center", va="bottom", fontsize=8,
            )
    ax.set_xticks(x)
    ax.set_xticklabels(categories)
    ax.set_ylabel("Time (s)")
    ax.set_yscale("log")
    ax.set_title(title)
    ax.legend()
    return _finish(fig, save_path)


def bar_plot_generic_dot(
    categories: Sequence[str],
    series: Dict[str, Sequence[float]],
    std_percent: Optional[Dict[str, Sequence[float]]] = None,
    dot_overlay: Optional[Dict[str, Sequence[float]]] = None,
    title: str = "Algorithm comparison",
    ylabel: str = "Cut value",
    annotate_percent_of: Optional[str] = None,
    y_lim: Optional[float] = None,
    save_path: Optional[str] = None,
):
    """Grouped bars with parameterized labels, percent-std error bars, and
    an optional dot-pattern overlay bar per series.

    Capability parity with the reference's parameterized-label variant
    (``Visualization/NeuralTesting.py:565-741`` ``barPlot_generic_dot``):
    any number of named series (the reference's ``barLabels``), per-series
    std expressed in PERCENT of the bar value (its ``nn_std_percent*``
    family), and a hatched "dot pattern" overlay drawn on top of a series
    from a second value list (its ``neural_cut2_dots``) — used to show the
    pre-post-processing value inside the post-processed bar.

    ``dot_overlay``: {series_name: values} overlay bars (dotted hatch,
    transparent face) drawn at the same x offset as that series.
    """
    _require_mpl()
    names = list(series)
    x = np.arange(len(categories))
    width = 0.8 / len(names)
    fig, ax = plt.subplots(figsize=(max(8, len(categories) * 1.8), 5))
    ref_vals = (
        np.asarray(series[annotate_percent_of], dtype=float)
        if annotate_percent_of
        else None
    )
    for i, name in enumerate(names):
        vals = np.asarray(series[name], dtype=float)
        offs = x + (i - (len(names) - 1) / 2) * width
        yerr = None
        if std_percent and name in std_percent:
            yerr = np.asarray(std_percent[name], dtype=float) / 100.0 * vals
        bars = ax.bar(
            offs, vals, width, label=name,
            yerr=yerr, capsize=4 if yerr is not None else 0,
            ecolor="black",
        )
        if dot_overlay and name in dot_overlay:
            ax.bar(
                offs,
                np.asarray(dot_overlay[name], dtype=float),
                width,
                facecolor="none",
                edgecolor="black",
                hatch="..",
                linewidth=0.5,
            )
        if ref_vals is not None and name != annotate_percent_of:
            for b, v, r in zip(bars, vals, ref_vals):
                if r > 0:
                    ax.annotate(
                        f"{100 * v / r:.0f}%",
                        (b.get_x() + b.get_width() / 2, b.get_height()),
                        ha="center", va="bottom", fontsize=8,
                    )
    ax.set_xticks(x)
    ax.set_xticklabels(categories)
    ax.set_xlabel("Graph size (nodes)")
    ax.set_ylabel(ylabel)
    if y_lim is not None:
        ax.set_ylim(top=y_lim)
    ax.set_title(title)
    ax.legend()
    return _finish(fig, save_path)


def bar_plot_speedup_dot(
    categories: Sequence[str],
    times: Dict[str, Sequence[float]],
    std_percent: Optional[Dict[str, Sequence[float]]] = None,
    dot_overlay: Optional[Dict[str, Sequence[float]]] = None,
    title: str = "Runtime comparison",
    y_lim: Optional[float] = None,
    save_path: Optional[str] = None,
):
    """Runtime bars with 'Ns' labels + error bars + dot-pattern overlay
    (reference ``barPlot_3_speedup_dot``, ``NeuralTesting.py:744-909``)."""
    _require_mpl()
    names = list(times)
    x = np.arange(len(categories))
    width = 0.8 / len(names)
    fig, ax = plt.subplots(figsize=(max(8, len(categories) * 1.8), 5))
    for i, name in enumerate(names):
        vals = np.asarray(times[name], dtype=float)
        offs = x + (i - (len(names) - 1) / 2) * width
        yerr = None
        if std_percent and name in std_percent:
            yerr = np.asarray(std_percent[name], dtype=float) / 100.0 * vals
        bars = ax.bar(
            offs, vals, width, label=name,
            yerr=yerr, capsize=4 if yerr is not None else 0,
            ecolor="black",
        )
        if dot_overlay and name in dot_overlay:
            ax.bar(
                offs,
                np.asarray(dot_overlay[name], dtype=float),
                width,
                facecolor="none",
                edgecolor="black",
                hatch="..",
                linewidth=0.5,
            )
        for b, v in zip(bars, vals):
            ax.annotate(
                f"{v:.2g}s",
                (b.get_x() + b.get_width() / 2, b.get_height()),
                ha="center", va="bottom", fontsize=8,
            )
    ax.set_xticks(x)
    ax.set_xticklabels(categories)
    ax.set_xlabel("Graph size (nodes)")
    ax.set_ylabel("Time (s)")
    ax.set_yscale("log")
    if y_lim is not None:
        ax.set_ylim(top=y_lim)
    ax.set_title(title)
    ax.legend()
    return _finish(fig, save_path)


def bar_plot_2_speedup(
    categories: Sequence[str],
    times_a: Sequence[float],
    times_b: Sequence[float],
    labels: Sequence[str] = ("GCN", "GCN with post-processing"),
    std_percent: Optional[Sequence[float]] = None,
    title: str = "Balanced 3-way max-cut",
    y_lim: Optional[float] = None,
    save_path: Optional[str] = None,
):
    """Two-series runtime bars with percent-std error bars and 'Ns' value
    labels above each bar (reference ``barPlot_2_speedUp``,
    ``NeuralTesting.py:256-381``: GCN vs GCN+post times per size)."""
    _require_mpl()
    std = (
        {labels[0]: std_percent, labels[1]: std_percent}
        if std_percent is not None
        else None
    )
    return bar_plot_speedup_dot(
        categories,
        {labels[0]: times_a, labels[1]: times_b},
        std_percent=std,
        title=title,
        y_lim=y_lim,
        save_path=save_path,
    )


def generate_sample_baseline_data(
    results_by_size: Dict,
    noise_factor: float = 0.1,
    seed: int = 0,
) -> Dict:
    """Synthetic solver/randomized demo series for visualization examples.

    Library form of the reference's notebook helper
    (``neural_network_visualization.ipynb`` cell 8
    ``generate_sample_baseline_data``): from a ``results_by_size`` mapping
    (the eval harness's per-size buckets with ``simple``/``post_processed``
    cut/time lists), fabricate plausible solver (better, slower) and
    randomized (worse, faster) series plus per-series std-percent lists so
    every chart shape can be demonstrated without a solver run.  Explicitly
    synthetic — for demo figures only; real comparisons come from
    ``baselines/``.
    """
    rng = np.random.default_rng(seed)
    out: Dict = {}
    for size, data in results_by_size.items():
        simple = data.get("simple", {})
        post = data.get("post_processed", {})
        gcn_cuts = list(post.get("cut_values", []))
        if not gcn_cuts:
            continue
        gcn_times = list(post.get("times", [0.1] * len(gcn_cuts)))
        solver_cuts = [
            max(c, c * (1.1 + rng.normal(0, noise_factor))) for c in gcn_cuts
        ]
        random_cuts = [c * (0.9 + rng.normal(0, noise_factor)) for c in gcn_cuts]
        out[size] = {
            "solver": {
                "cut_values": solver_cuts,
                "times": [t * (10 + rng.exponential(5)) for t in gcn_times],
                "std_percent": list(rng.uniform(2, 5, len(gcn_cuts))),
            },
            "randomized": {
                "cut_values": random_cuts,
                "times": [t * max(0.01, 0.1 + rng.normal(0, 0.05)) for t in gcn_times],
                "std_percent": list(rng.uniform(8, 15, len(gcn_cuts))),
            },
            "gcn_simple": {
                "cut_values": list(simple.get("cut_values", gcn_cuts)),
                "times": list(simple.get("times", gcn_times)),
                "std_percent": list(rng.uniform(3, 8, len(gcn_cuts))),
            },
            "gcn_post": {
                "cut_values": gcn_cuts,
                "times": gcn_times,
                "std_percent": list(rng.uniform(3, 8, len(gcn_cuts))),
            },
        }
    return out


def create_line_graph(
    sizes: Sequence[int],
    series: Dict[str, Sequence[float]],
    optimum: Optional[Sequence[float]] = None,
    title: str = "Scalability: accuracy vs graph size",
    save_path: Optional[str] = None,
):
    """Accuracy-vs-size lines, y as % of optimum when given (ref :1012-1064)."""
    _require_mpl()
    fig, ax = plt.subplots(figsize=(8, 5))
    for name, vals in series.items():
        y = np.asarray(vals, dtype=float)
        if optimum is not None:
            y = 100 * y / np.asarray(optimum, dtype=float)
        ax.plot(sizes, y, marker="o", label=name)
    ax.set_xlabel("Graph size (nodes)")
    ax.set_ylabel("% of optimum" if optimum is not None else "Cut value")
    ax.set_title(title)
    ax.grid(True, alpha=0.3)
    ax.legend()
    return _finish(fig, save_path)


def create_test_visualizations(
    test_results: List[Dict],
    results_by_size: Dict,
    graph_sizes: Sequence[int],
    save_path: Optional[str] = None,
):
    """2×2 panel: cut by size, improvement histogram, runtime by size,
    improvement% by size (reference ``create_visualizations``
    ``TestingNeuralNetwork.py:430-537``)."""
    _require_mpl()
    fig, axes = plt.subplots(2, 2, figsize=(14, 10))

    sizes = [s for s in sorted(graph_sizes) if results_by_size.get(s, {}).get("simple", {}).get("cut_values")]
    simple_avg = [np.mean(results_by_size[s]["simple"]["cut_values"]) for s in sizes]
    post_avg = [np.mean(results_by_size[s]["post_processed"]["cut_values"]) for s in sizes]
    x = np.arange(len(sizes))

    ax = axes[0][0]
    ax.bar(x - 0.2, simple_avg, 0.4, label="Simple GCN")
    ax.bar(x + 0.2, post_avg, 0.4, label="Post-processed")
    ax.set_xticks(x)
    ax.set_xticklabels(sizes)
    ax.set_title("Average cut value by graph size")
    ax.set_xlabel("Graph size")
    ax.set_ylabel("Cut value")
    ax.legend()

    ax = axes[0][1]
    improvements = [r["improvement_percent"] for r in test_results]
    ax.hist(improvements, bins=20, edgecolor="black", alpha=0.7)
    ax.axvline(np.mean(improvements), color="red", linestyle="--",
               label=f"mean {np.mean(improvements):+.1f}%")
    ax.set_title("Improvement distribution")
    ax.set_xlabel("Improvement (%)")
    ax.set_ylabel("Count")
    ax.legend()

    ax = axes[1][0]
    simple_t = [np.mean(results_by_size[s]["simple"]["times"]) for s in sizes]
    post_t = [np.mean(results_by_size[s]["post_processed"]["times"]) for s in sizes]
    ax.plot(sizes, simple_t, marker="o", label="Simple GCN")
    ax.plot(sizes, post_t, marker="s", label="Post-processed")
    ax.set_yscale("log")
    ax.set_title("Runtime by graph size")
    ax.set_xlabel("Graph size")
    ax.set_ylabel("Time (s)")
    ax.grid(True, alpha=0.3)
    ax.legend()

    ax = axes[1][1]
    imp_pct = [
        100 * (p - s_) / s_ if s_ > 0 else 0
        for p, s_ in zip(post_avg, simple_avg)
    ]
    ax.bar(x, imp_pct, color="seagreen", alpha=0.8)
    ax.set_xticks(x)
    ax.set_xticklabels(sizes)
    ax.set_title("Post-processing improvement by size")
    ax.set_xlabel("Graph size")
    ax.set_ylabel("Improvement (%)")

    return _finish(fig, save_path)


def plot_loss_history(
    loss_history: Sequence[float],
    title: str = "Training loss",
    save_path: Optional[str] = None,
):
    """Loss curve with the reference notebook's abs-log workaround
    (``complete_training_pipeline.ipynb`` cell 17: losses are large negative
    numbers, so plot |loss| on a log axis)."""
    _require_mpl()
    if isinstance(loss_history, torch.Tensor):
        loss_history = loss_history.detach().cpu().tolist()
    loss_history = [float(x) for x in loss_history]
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 4))
    ax1.plot(loss_history)
    ax1.set_title(title)
    ax1.set_xlabel("Epoch")
    ax1.set_ylabel("Cumulative loss")
    ax1.grid(True, alpha=0.3)
    ax2.plot(np.abs(np.asarray(loss_history, dtype=float)))
    ax2.set_yscale("log")
    ax2.set_title(f"|{title}| (log scale)")
    ax2.set_xlabel("Epoch")
    ax2.grid(True, alpha=0.3)
    return _finish(fig, save_path)
