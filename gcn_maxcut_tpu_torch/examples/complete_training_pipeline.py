"""The reference's ``complete_training_pipeline.ipynb`` through the port's
library API, stage by stage (port of
``examples/complete_training_pipeline.py``):

  1. generate d-regular graphs with 3 terminals   (data.generate.generate_graph)
  2. tensorize, normalize terminals, pad          (data.process.process_graphs)
  3. train GCNSoftmax on the cut loss             (train.loop.train_model)
  4. checkpoint the trained model                 (train.checkpoint.save_checkpoint)
  5. evaluate held-out graphs: argmax, 200-rollout post-processing and the
     greedy-flip refine                           (eval.harness.test_multiple_graphs)
  6. the randomized baseline on the same graphs   (baselines.randomized)
  7. analysis report and summary                  (eval.harness.analyze_results)
  8. loss curve and comparison charts             (viz, when matplotlib is there)

    python -m gcn_maxcut_tpu_torch.examples.complete_training_pipeline [workdir] [--quick] [--device cpu]

``--quick`` is a toy run (n = 60, 6 graphs, 120 epochs).  The one-command
equivalent is ``python -m gcn_maxcut_tpu_torch pipeline``.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch


def main(workdir: str = "pipeline_out", quick: bool = False,
         device: str | torch.device | None = None) -> int:
    from gcn_maxcut_tpu_torch.baselines.randomized import randomized_k_way_maxcut
    from gcn_maxcut_tpu_torch.core.graph import pad_graph_batch
    from gcn_maxcut_tpu_torch.data.generate import generate_graph
    from gcn_maxcut_tpu_torch.data.process import DataConfig, process_graphs
    from gcn_maxcut_tpu_torch.device import resolve_device
    from gcn_maxcut_tpu_torch.eval import harness
    from gcn_maxcut_tpu_torch.train.checkpoint import save_checkpoint
    from gcn_maxcut_tpu_torch.train.config import TrainingConfig
    from gcn_maxcut_tpu_torch.train.loop import train_model
    from gcn_maxcut_tpu_torch.viz import HAS_MATPLOTLIB

    dev = resolve_device(device)
    os.makedirs(workdir, exist_ok=True)

    # 1. generation: the reference's seeds 1000 + i, d in [6, 8]
    n, pad, num_train, epochs = (60, 64, 6, 120) if quick else (500, 1000, 20, 1000)
    rng = np.random.default_rng(1000)
    train_specs = []
    while len(train_specs) < num_train:
        d = int(rng.integers(6, 9))
        if (n * d) % 2:           # a d-regular graph needs n·d even
            continue
        train_specs.append(generate_graph(n=n, d=d, graph_type="reg",
                                          seed=1000 + len(train_specs)))
    print(f"generated {len(train_specs)} training graphs (n={n})")

    # 2. processing: terminals to ids 0..2, adjacency features, one batch
    ds = process_graphs(train_specs, DataConfig(max_nodes=pad))
    batch = pad_graph_batch([ds.graphs[k] for k in sorted(ds.graphs)])
    print(f"processed to n_pad={batch.n_pad}, batch of {len(ds.graphs)}")

    # 3-4. training (lr 1e-3, tolerance 1e-4, patience 20: the reference
    # recipe) and the checkpoint
    cfg = TrainingConfig(n_nodes=pad, learning_rate=1e-3, number_epochs=epochs,
                         tolerance=1e-4, patience=20, epochs_per_call=10)
    params, best_loss, final_epoch, _, history = train_model(batch, cfg, device=dev)
    print(f"trained to best loss {best_loss:.0f} at epoch {final_epoch} "
          f"({len(history)} epochs recorded)")
    ckpt = save_checkpoint(os.path.join(workdir, "final_maxcut3way"), params=params,
                           config=cfg, epoch=final_epoch, loss_history=history)
    print(f"checkpoint -> {ckpt}")

    # 5. held-out evaluation: argmax, 200 rollouts, the refine
    test_specs = [generate_graph(n=n, d=6, graph_type="reg", seed=9000 + i)
                  for i in range(3 if quick else 6)]
    test_ds = process_graphs(test_specs, DataConfig(max_nodes=pad))
    results, results_by_size = harness.test_multiple_graphs(
        params, test_ds, graph_sizes=[n], post_processing_iterations=200,
        refine=True, seed=42,
    )
    # 6. the randomized baseline on the same graphs (10k draws)
    for idx, res in zip(sorted(test_ds.graphs), results):
        _, rand_cut, _ = randomized_k_way_maxcut(
            test_ds.graphs[idx].to(dev), k=3,
            max_iterations=1000 if quick else 10_000,
            patience=1000 if quick else 10_000, seed=7000 + idx,
        )
        res["randomized_cut"] = float(rand_cut)
        print(f"graph {idx}: simple {res['simple_cut']:.0f} | post {res['post_cut']:.0f} | "
              f"refined {res.get('refined_cut', float('nan')):.0f} | randomized {rand_cut:.0f}")

    # 7. analysis and reports
    analysis = harness.analyze_results(results, results_by_size, [n])
    harness.print_analysis_report(analysis, [n])
    testing_config = {"graph_sizes": [n], "num_test_graphs": len(results),
                      "post_processing_iterations": 200}
    summary = harness.generate_summary_report(analysis, testing_config,
                                              model_config={"n_nodes": pad})
    with open(os.path.join(workdir, "SUMMARY.md"), "w") as f:
        f.write(summary)
    harness.save_results(os.path.join(workdir, "results.json"), results, results_by_size,
                         analysis, testing_config)
    print(f"reports -> {workdir}/SUMMARY.md, {workdir}/results.json")

    # 8. charts
    if HAS_MATPLOTLIB:
        from gcn_maxcut_tpu_torch.viz import bar_plot_3, plot_loss_history

        plot_loss_history(history, save_path=os.path.join(workdir, "loss_curve.png"))
        bar_plot_3(
            [f"g{idx}" for idx in sorted(test_ds.graphs)],
            {"GCN argmax": [r["simple_cut"] for r in results],
             "GCN + post": [r["post_cut"] for r in results],
             "randomized": [r["randomized_cut"] for r in results]},
            save_path=os.path.join(workdir, "comparison.png"),
        )
        print(f"charts -> {workdir}/loss_curve.png, {workdir}/comparison.png")
    else:
        print("matplotlib not available; charts skipped")

    post_mean = float(np.mean([r["post_cut"] for r in results]))
    rand_mean = float(np.mean([r["randomized_cut"] for r in results]))
    print(f"\nGCN+post mean {post_mean:.0f} vs randomized {rand_mean:.0f} "
          f"({'beats' if post_mean >= rand_mean else 'trails'} the baseline)")
    return 0


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("workdir", nargs="?", default="pipeline_out")
    p.add_argument("--quick", action="store_true")
    p.add_argument("--device", default=None, help="default: the CUDA device")
    a = p.parse_args()
    raise SystemExit(main(a.workdir, a.quick, a.device))
