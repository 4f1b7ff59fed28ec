"""Command-line entry point of the port: ``pipeline`` and ``bench``.

Port of the subcommands of ``gcn_maxcut_tpu/cli.py`` that the port covers
so far, with the same flags plus ``--device`` (default: the CUDA device;
``--device cpu`` runs on the CPU):

  python -m gcn_maxcut_tpu_torch pipeline --workdir out/
      generate -> process -> train -> evaluate -> randomized baseline ->
      SUMMARY.md (no dataset npz or checkpoint yet)
  python -m gcn_maxcut_tpu_torch bench --what giant
      the single-device giant banded trainer (packed layout by default)
  python -m gcn_maxcut_tpu_torch bench --what spmm [--n 100000 --d 8]
      SpMM edges/s: banded-random graph on the block-ELL kernel, expander
      on the ELL gather path
  python -m gcn_maxcut_tpu_torch bench --what banded
      banded SpMM edges/s: the unit and weighted kernels
  python -m gcn_maxcut_tpu_torch bench --what locality [--n 100000]
      the locality trainer (bench/locality.py): RCM, plan, train, decode
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict

import numpy as np
import torch


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_pipeline(
    workdir: str | Path,
    num_graphs: int = 20,
    nodes: int = 500,
    min_degree: int = 6,
    max_degree: int = 8,
    pad_to: int = 1000,
    classes: int = 3,
    epochs: int = 300,
    learning_rate: float = 1e-3,
    seed: int = 1000,
    device: str | torch.device | None = None,
) -> Dict[str, Any]:
    """The complete training recipe end to end; writes
    ``<workdir>/<name>_SUMMARY.md`` and returns its numbers."""
    from gcn_maxcut_tpu_torch.baselines.randomized import randomized_k_way_maxcut
    from gcn_maxcut_tpu_torch.core.graph import dense_adjacency
    from gcn_maxcut_tpu_torch.data.generate import generate_graph_dataset
    from gcn_maxcut_tpu_torch.data.process import DataConfig, process_graphs
    from gcn_maxcut_tpu_torch.device import resolve_device
    from gcn_maxcut_tpu_torch.eval.decode import post_process, simple_assignment
    from gcn_maxcut_tpu_torch.models.gcn import gcn_softmax_apply
    from gcn_maxcut_tpu_torch.objectives.cut_loss import hard_cut_value
    from gcn_maxcut_tpu_torch.train.loop import (
        _resolve_dense_aggregation,
        train_dataset,
    )

    dev = resolve_device(device)
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    phases: Dict[str, float] = {}
    name = f"maxcut_{classes}way_n{nodes}_d{min_degree}_{max_degree}"

    t0 = time.perf_counter()
    graphs, _ = generate_graph_dataset(
        num_graphs, nodes, nodes, min_degree, max_degree, base_seed=seed,
    )
    phases["generation"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ds = process_graphs(graphs, DataConfig(max_nodes=pad_to))
    phases["processing"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    params, best_loss, final_epoch, _, history = train_dataset(
        ds, device=dev, number_epochs=epochs, learning_rate=learning_rate,
        save_frequency=max(1, epochs // 5), seed=seed,
    )
    _sync(dev)
    phases["training"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    test_graphs, _ = generate_graph_dataset(
        max(2, num_graphs // 4), nodes, nodes, min_degree, max_degree,
        base_seed=seed + 5000,
    )
    tds = process_graphs(test_graphs, DataConfig(max_nodes=pad_to))
    gen = torch.Generator(device=dev).manual_seed(0)
    simple, post, simple_s, post_s = [], [], [], []
    for k in sorted(tds.graphs):
        g = tds.graphs[k].to(dev)
        with torch.no_grad():
            a = (dense_adjacency(g, values="mask")
                 if _resolve_dense_aggregation("auto", g.n_pad) else None)
            probs = gcn_softmax_apply(
                params, g, dense_adjacency(g, width=params["conv1"]["w"].shape[0]),
                a_dense=a,
            )
            _sync(dev)
            t1 = time.perf_counter()
            simple.append(float(hard_cut_value(g, simple_assignment(probs))))
            t2 = time.perf_counter()
            post.append(float(post_process(g, probs, gen, iterations=200)[1]))
            t3 = time.perf_counter()
        simple_s.append(t2 - t1)
        post_s.append(t3 - t2)
    rand = [
        randomized_k_way_maxcut(tds.graphs[k].to(dev), classes, 1000, seed=k)[1]
        for k in sorted(tds.graphs)
    ]
    phases["evaluation"] = time.perf_counter() - t0

    avg_simple, avg_post = float(np.mean(simple)), float(np.mean(post))
    improvement_pct = float(np.mean(
        [(p - s) / s * 100 if s > 0 else 0.0 for s, p in zip(simple, post)]
    ))
    overhead = float(np.mean(post_s) / np.mean(simple_s))
    avg_deg = float(np.mean([2 * s.n_edges / s.n_nodes for s in ds.specs.values()]))
    epochs_run = final_epoch + 1
    summary = "\n".join([
        f"# {name} — pipeline summary",
        "",
        f"Generated: {time.strftime('%Y-%m-%d %H:%M:%S')} on {dev}",
        "",
        "## Dataset",
        f"- Graphs: {len(ds)} (n={nodes}, d∈[{min_degree},{max_degree}], actual avg degree {avg_deg:.2f})",
        f"- Padding: {pad_to}-wide features",
        "",
        "## Timing",
        *(f"- {k}: {v:.2f} s" for k, v in phases.items()),
        "",
        "## Training",
        f"- Epochs: {epochs_run}/{epochs}",
        f"- Best loss: {best_loss:.1f}  (≈ cut {-best_loss:.0f} summed over graphs)",
        "",
        "## Evaluation (held-out graphs)",
        f"- GCN argmax avg cut: {avg_simple:.1f}",
        f"- GCN + post-processing avg cut: {avg_post:.1f} ({improvement_pct:+.1f}%)",
        f"- Randomized baseline avg cut: {float(np.mean(rand)):.1f}",
        f"- Post-processing overhead: {overhead:.1f}x",
    ])
    (workdir / f"{name}_SUMMARY.md").write_text(summary)
    return {
        "summary": summary,
        "epochs_run": epochs_run,
        "training_s": phases["training"],
        "epoch_ms": phases["training"] / epochs_run * 1e3,
        "best_loss": best_loss,
        "history": history,
        "avg_simple_cut": avg_simple,
        "avg_post_cut": avg_post,
        "avg_randomized_cut": float(np.mean(rand)),
    }


def _cmd_pipeline(args) -> int:
    res = run_pipeline(
        args.workdir, args.num_graphs, args.nodes, args.min_degree,
        args.max_degree, args.pad_to, args.classes, args.epochs,
        args.learning_rate, args.seed, device=args.device,
    )
    print(res["summary"])
    return 0


def _cmd_bench(args) -> int:
    from gcn_maxcut_tpu_torch.bench.giant_demo import (
        train_banded_giant,
        train_banded_giant_packed,
    )

    if args.what == "spmm":
        from gcn_maxcut_tpu_torch.bench.microbench import bench_spmm

        print(json.dumps({"spmm": bench_spmm(n=args.n, d=args.d, device=args.device)},
                         default=float))
        return 0
    if args.what == "banded":
        from gcn_maxcut_tpu_torch.bench.microbench import bench_spmm_banded

        print(json.dumps({"banded": bench_spmm_banded(device=args.device)}, default=float))
        return 0
    if args.what == "locality":
        from gcn_maxcut_tpu_torch.bench.locality import train_locality

        res = train_locality(n=args.n, d=args.d, epochs=args.epochs, device=args.device)
        res.pop("assignment")
        print(json.dumps({"locality": res}, default=float))
        return 0
    if args.giant_layout == "packed":
        res = train_banded_giant_packed(
            n=args.giant_nodes, d=args.d, epochs=args.giant_epochs,
            act_dtype=None if args.act_dtype == "float32" else args.act_dtype,
            device=args.device,
        )
    else:
        res = train_banded_giant(
            n=args.giant_nodes, d=args.d, epochs=args.giant_epochs,
            device=args.device,
        )
    res.pop("history")
    print(json.dumps({"giant": res}, default=float))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gcn_maxcut_tpu_torch")
    sub = p.add_subparsers(dest="command", required=True)

    b = sub.add_parser("bench", help="microbenchmarks and the single-device trainers")
    b.add_argument("--what", choices=["giant", "spmm", "banded", "locality"], default="giant")
    b.add_argument("--n", type=int, default=100_000, help="nodes (spmm, locality)")
    b.add_argument("--d", type=int, default=8)
    b.add_argument("--epochs", type=int, default=200, help="locality trainer epochs")
    b.add_argument("--giant-nodes", type=int, default=10_002_432)
    b.add_argument("--giant-epochs", type=int, default=40)
    b.add_argument(
        "--giant-layout", choices=["packed", "plain"], default="packed",
        help="packed = interleaved node order, every aggregation 16 wide",
    )
    b.add_argument(
        "--act-dtype", choices=["float32", "bfloat16"], default="float32",
        help="packed giant activation dtype",
    )
    b.add_argument("--device", default=None, help="default: the CUDA device")
    b.set_defaults(fn=_cmd_bench)

    pl = sub.add_parser("pipeline", help="full generate->train->eval recipe")
    pl.add_argument("--workdir", default="pipeline_out")
    pl.add_argument("--num-graphs", type=int, default=20)
    pl.add_argument("--nodes", type=int, default=500)
    pl.add_argument("--min-degree", type=int, default=6)
    pl.add_argument("--max-degree", type=int, default=8)
    pl.add_argument("--pad-to", type=int, default=1000)
    pl.add_argument("--classes", type=int, default=3)
    pl.add_argument("--epochs", type=int, default=300)
    pl.add_argument("--learning-rate", type=float, default=1e-3)
    pl.add_argument("--seed", type=int, default=1000)
    pl.add_argument("--device", default=None, help="default: the CUDA device")
    pl.set_defaults(fn=_cmd_pipeline)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
