"""Baseline benchmark analysis and plots (host code).

Port of ``gcn_maxcut_tpu/baselines/analysis.py`` (the reference's
``RandomAlgorithm/RandomizedMaxCut.py`` ``analyze_results``, :214-280):
runtime, cut and normalized cut (cut / edges, edges = n·d/2) against n for
each k of ``benchmark_algorithm``'s (n, k) sweep, and optionally the
3-panel figure (matplotlib's Agg backend).
"""

from __future__ import annotations

import logging
from typing import Dict, Optional, Tuple

logger = logging.getLogger(__name__)


def analyze_benchmark_results(
    results: Dict[Tuple[int, int], Dict[str, float]],
    degree: int = 8,
    save_path: Optional[str] = None,
) -> Dict[str, Dict]:
    """Aggregate the (n, k) sweep; with ``save_path`` also write the
    figure there."""
    ns = sorted({n for n, _ in results})
    ks = sorted({k for _, k in results})
    by_k = {
        k: {
            "n": ns,
            "cut": [results[(n, k)]["cut"] for n in ns],
            "time": [results[(n, k)]["time"] for n in ns],
            "normalized_cut": [results[(n, k)]["cut"] / (n * degree / 2) for n in ns],
        }
        for k in ks
    }
    summary = {
        "node_sizes": ns,
        "k_values": ks,
        "by_k": by_k,
        "max_normalized_cut": max(v for k in ks for v in by_k[k]["normalized_cut"]),
    }

    if save_path:
        from gcn_maxcut_tpu_torch.viz.charts import HAS_MATPLOTLIB

        if HAS_MATPLOTLIB:
            import matplotlib.pyplot as plt

            fig, axes = plt.subplots(1, 3, figsize=(16, 4.5))
            for k in ks:
                axes[0].plot(ns, by_k[k]["time"], marker="o", label=f"k={k}")
                axes[1].plot(ns, by_k[k]["cut"], marker="o", label=f"k={k}")
                axes[2].plot(ns, by_k[k]["normalized_cut"], marker="o", label=f"k={k}")
            for ax, title, ylab in zip(axes, ("Runtime", "Cut value", "Normalized cut"),
                                       ("seconds", "cut", "cut / |E|")):
                ax.set_title(title)
                ax.set_xlabel("n")
                ax.set_ylabel(ylab)
                ax.grid(True, alpha=0.3)
                ax.legend()
            fig.tight_layout()
            fig.savefig(save_path, dpi=300, bbox_inches="tight")
            plt.close(fig)
        else:  # pragma: no cover
            logger.warning("matplotlib unavailable; skipping benchmark plots")
    return summary
