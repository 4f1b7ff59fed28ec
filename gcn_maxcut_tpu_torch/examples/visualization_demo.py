"""Publication figures from saved results (port of
``examples/visualization_demo.py``, the reference's
``neural_network_visualization.ipynb``): load a results package
(``eval.harness.save_results``, e.g. from ``neural_network_testing``) and
render the comparison, runtime, scalability and test-panel charts.  Host
code only: it takes no device.

    python -m gcn_maxcut_tpu_torch.examples.visualization_demo results.json [outdir]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def main(results_path: str, outdir: str = "viz_out") -> int:
    from gcn_maxcut_tpu_torch.eval.harness import load_results
    from gcn_maxcut_tpu_torch.viz import (
        HAS_MATPLOTLIB,
        bar_plot_3,
        bar_plot_speedup,
        create_line_graph,
        create_test_visualizations,
    )

    if not HAS_MATPLOTLIB:
        print("matplotlib unavailable; nothing to render")
        return 1
    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    pkg = load_results(results_path)
    by_size = {int(k): v for k, v in pkg["results_by_size"].items()}
    sizes = sorted(s for s in by_size if by_size[s]["simple"]["cut_values"])
    cats = [f"n={s}" for s in sizes]
    simple = [float(np.mean(by_size[s]["simple"]["cut_values"])) for s in sizes]
    post = [float(np.mean(by_size[s]["post_processed"]["cut_values"])) for s in sizes]

    bar_plot_3(cats, {"GCN": simple, "GCN + post-processing": post},
               title="Cut value by method", annotate_percent_of="GCN + post-processing",
               save_path=str(out / "comparison.png"))
    bar_plot_speedup(
        cats,
        {"GCN": [float(np.mean(by_size[s]["simple"]["times"])) for s in sizes],
         "GCN + post": [float(np.mean(by_size[s]["post_processed"]["times"])) for s in sizes]},
        save_path=str(out / "runtime.png"),
    )
    create_line_graph(sizes, {"GCN": simple, "GCN + post": post}, title="Scalability",
                      save_path=str(out / "scalability.png"))
    create_test_visualizations(pkg["individual_results"], by_size, sizes,
                               save_path=str(out / "panel.png"))
    print(f"figures written to {out}/")
    return 0


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("results_path")
    p.add_argument("outdir", nargs="?", default="viz_out")
    a = p.parse_args()
    raise SystemExit(main(a.results_path, a.outdir))
