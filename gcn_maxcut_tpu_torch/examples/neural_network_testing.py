"""The reference's ``neural_network_testing.ipynb`` recipe (port of
``examples/neural_network_testing.py``): load a trained checkpoint,
generate 10 test graphs a size in {50, 100, 200, 300, 500} (d in [6, 8],
seeds size·1000 + i), run the 200-rollout post-processing comparison,
print the analysis report, and save the results and the test panel.

    python -m gcn_maxcut_tpu_torch.examples.neural_network_testing final_m.npz [outdir] [--device cpu]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import torch

GRAPH_SIZES = [50, 100, 200, 300, 500]
GRAPHS_PER_SIZE = 10
POST_ITERATIONS = 200
PAD = 1000


def main(checkpoint: str, outdir: str = "testing_out",
         device: str | torch.device | None = None) -> int:
    from gcn_maxcut_tpu_torch.data.generate import generate_graph_dataset
    from gcn_maxcut_tpu_torch.data.process import DataConfig, process_graphs
    from gcn_maxcut_tpu_torch.eval import harness
    from gcn_maxcut_tpu_torch.train.checkpoint import load_checkpoint
    from gcn_maxcut_tpu_torch.train.config import TrainingConfig
    from gcn_maxcut_tpu_torch.train.loop import setup_train_state
    from gcn_maxcut_tpu_torch.viz import HAS_MATPLOTLIB, create_test_visualizations

    out = Path(outdir)
    out.mkdir(parents=True, exist_ok=True)
    state = setup_train_state(TrainingConfig(n_nodes=PAD), device=device)
    params, _, _, meta = load_checkpoint(checkpoint, state.params())
    print(f"loaded checkpoint (epoch {meta['epoch']})")

    all_results, merged_by_size = [], {}
    for size in GRAPH_SIZES:
        graphs, _ = generate_graph_dataset(GRAPHS_PER_SIZE, size, size, 6, 8,
                                           base_seed=size * 1000)
        ds = process_graphs(graphs, DataConfig(max_nodes=PAD))
        results, by_size = harness.test_multiple_graphs(
            params, ds, [size], post_processing_iterations=POST_ITERATIONS)
        all_results.extend(results)
        merged_by_size.update(by_size)

    analysis = harness.analyze_results(all_results, merged_by_size, GRAPH_SIZES)
    harness.print_analysis_report(analysis, GRAPH_SIZES)
    summary = harness.generate_summary_report(
        analysis,
        {"graph_sizes": GRAPH_SIZES, "graphs_per_size": GRAPHS_PER_SIZE,
         "post_processing_iterations": POST_ITERATIONS},
        model_config={"checkpoint": checkpoint},
    )
    (out / "SUMMARY.md").write_text(summary)
    harness.save_results(out / "results.json", all_results, merged_by_size, analysis,
                         {"sizes": GRAPH_SIZES})
    if HAS_MATPLOTLIB:
        create_test_visualizations(all_results, merged_by_size, GRAPH_SIZES,
                                   save_path=str(out / "test_panel.png"))
    print(f"artifacts in {out}/")
    return 0


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("checkpoint")
    p.add_argument("outdir", nargs="?", default="testing_out")
    p.add_argument("--device", default=None, help="default: the CUDA device")
    a = p.parse_args()
    raise SystemExit(main(a.checkpoint, a.outdir, a.device))
