"""Command-line entry point of the port.

Port of every subcommand of ``gcn_maxcut_tpu/cli.py``, with the same flags
plus ``--device`` on every command that runs on a device (default: the
CUDA device; ``--device cpu`` runs on the CPU).  ``solve`` prints the JAX
keys plus ``restarts``:

  python -m gcn_maxcut_tpu_torch generate --num-graphs 20 --output ds.npz
      generate and process a dataset, saved as the JAX package's npz
  python -m gcn_maxcut_tpu_torch train --dataset ds.npz --model-name m
      train GCNSoftmax; checkpoints epoch_*_m.npz and final_m.npz
      (``--resume`` warm-starts from a checkpoint, ``--metrics`` writes
      per-epoch JSONL)
  python -m gcn_maxcut_tpu_torch test --dataset ds.npz --checkpoint final_m.npz
      the evaluation harness; the multi-start refine is on by default
  python -m gcn_maxcut_tpu_torch pipeline --workdir out/
      generate -> process (dataset npz) -> train (checkpoints) -> evaluate
      held-out graphs (argmax, post-processing, refine) -> randomized
      baseline -> SUMMARY.md
  python -m gcn_maxcut_tpu_torch solve --n 100 --d 8 --time-limit 60
      a classical solver on a random regular graph: the anytime solver
      (exact below 19 free nodes, else batched SA chains on the device) or
      --method sweep, the native sweep for 100k..10M-node graphs (host)
  python -m gcn_maxcut_tpu_torch convert final_m.pth migrated.npz
      migrate a checkpoint: the reference's .pth/.pt to the npz layout,
      or an npz to .pth (host; unpickling a .pth runs code: trusted files
      only)
  python -m gcn_maxcut_tpu_torch bench [--what all]
      spmm, banded, train and post in that order (the default)
  python -m gcn_maxcut_tpu_torch bench --what quality [--recipe mixed]
      the cut-quality suite (bench/quality.py)
  python -m gcn_maxcut_tpu_torch bench --what train|post
      the recipe's epoch time; post-processing time
  python -m gcn_maxcut_tpu_torch bench --what giant
      the single-device giant banded trainer (packed layout by default)
  python -m gcn_maxcut_tpu_torch bench --what spmm [--n 100000 --d 8]
      SpMM edges/s: banded-random graph on the block-ELL kernel, expander
      on the ELL gather path
  python -m gcn_maxcut_tpu_torch bench --what banded
      banded SpMM edges/s: the unit and weighted kernels
  python -m gcn_maxcut_tpu_torch bench --what locality [--n 100000]
      the locality trainer (bench/locality.py): RCM, plan, train, decode
  python -m gcn_maxcut_tpu_torch bench --what kway [--n 100000 --d 8]
      the k-way sweep k = 3..8 on the node-sharded trainer
      (bench/kway_sweep.py; --giant-epochs, --partition, --block-ell)
  python -m gcn_maxcut_tpu_torch bench --what scaling [--n 100000 --d 8]
      one sharded conv's edges/s at 1, 2, 4, ... CUDA devices
      (bench/scaling.py)
  python -m gcn_maxcut_tpu_torch bench --what hybrid [--n 100000 --d 8]
      the hybrid data x graph trainer (parallel/hybrid.py): one regular
      graph of max(256, n / 100) nodes a data row, on 2 x ndev/2 CUDA
      devices when ndev is even and above 1, else 1 x ndev (--device cpu:
      one CPU device, 1 x 1); --giant-epochs epochs
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

from gcn_maxcut_tpu_torch.utils.logging import get_logger


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _cmd_generate(args) -> int:
    from gcn_maxcut_tpu_torch.data.generate import generate_graph_dataset
    from gcn_maxcut_tpu_torch.data.io import save_dataset
    from gcn_maxcut_tpu_torch.data.process import DataConfig, process_graphs

    graphs, _ = generate_graph_dataset(
        num_graphs=args.num_graphs,
        min_nodes=args.min_nodes,
        max_nodes=args.max_nodes,
        min_degree=args.min_degree,
        max_degree=args.max_degree,
        graph_type=args.graph_type,
        base_seed=args.seed,
    )
    ds = process_graphs(graphs, DataConfig(max_nodes=args.pad_to))
    save_dataset(ds, args.output)
    print(f"wrote {len(ds)} graphs to {args.output}")
    return 0


def _cmd_train(args) -> int:
    from gcn_maxcut_tpu_torch.data.io import load_dataset
    from gcn_maxcut_tpu_torch.train.loop import train_dataset

    ds = load_dataset(args.dataset)
    callback = None
    if args.metrics:
        from gcn_maxcut_tpu_torch.utils.profiling import MetricsLogger

        ml = MetricsLogger(args.metrics)
        callback = lambda epoch, loss: ml.log(epoch, loss=loss)  # noqa: E731
    _, best_loss, epochs, _, history = train_dataset(
        ds,
        model_name=args.model_name,
        callback=callback,
        device=args.device,
        resume_from=args.resume,
        number_epochs=args.epochs,
        learning_rate=args.learning_rate,
        dropout=args.dropout,
        patience=args.patience,
        save_frequency=args.save_frequency,
        seed=args.seed,
        loss_mode=args.loss_mode,
        quantile_c=args.quantile_c,
        entropy_weight=args.entropy_weight,
        lr_schedule=args.lr_schedule,
    )
    print(json.dumps({"best_loss": best_loss, "epochs": epochs + 1, "final_loss": history[-1]}))
    return 0


def _cmd_test(args) -> int:
    from gcn_maxcut_tpu_torch.data.io import load_dataset
    from gcn_maxcut_tpu_torch.eval import harness
    from gcn_maxcut_tpu_torch.train.checkpoint import load_checkpoint
    from gcn_maxcut_tpu_torch.train.config import TrainingConfig
    from gcn_maxcut_tpu_torch.train.loop import setup_train_state

    ds = load_dataset(args.dataset)
    sizes = (
        [int(s) for s in args.sizes.split(",")]
        if args.sizes
        else sorted({s.n_nodes for s in ds.specs.values()})
    )
    state = setup_train_state(TrainingConfig(n_nodes=ds.config.max_nodes), device=args.device)
    params = load_checkpoint(args.checkpoint, state.params())[0]
    results, by_size = harness.test_multiple_graphs(
        params, ds, sizes,
        post_processing_iterations=args.iterations,
        refine=args.refine,
        refine_starts=args.refine_starts,
    )
    analysis = harness.analyze_results(results, by_size, sizes)
    harness.print_analysis_report(analysis, sizes)
    if args.output:
        harness.save_results(args.output, results, by_size, analysis, vars(args))
        print(f"results saved to {args.output}")
    return 0


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
    """The complete training recipe end to end.  Writes
    ``<workdir>/<name>_dataset.npz``, the checkpoints
    ``<workdir>/epoch_*_<name>_model.npz`` and ``final_<name>_model.npz``,
    and ``<workdir>/<name>_SUMMARY.md``; returns its numbers.  The held-out
    graphs are decoded by the harness with the argmax, the post-processing
    and the default decode, the multi-start refine."""
    from gcn_maxcut_tpu_torch.baselines.randomized import randomized_k_way_maxcut
    from gcn_maxcut_tpu_torch.data.generate import generate_graph_dataset
    from gcn_maxcut_tpu_torch.data.io import save_dataset
    from gcn_maxcut_tpu_torch.data.process import DataConfig, process_graphs
    from gcn_maxcut_tpu_torch.device import resolve_device
    from gcn_maxcut_tpu_torch.eval import harness
    from gcn_maxcut_tpu_torch.train.checkpoint import checkpoint_name
    from gcn_maxcut_tpu_torch.train.loop import train_dataset

    dev = resolve_device(device)
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    phases: Dict[str, float] = {}
    name = f"maxcut_{classes}way_n{nodes}_d{min_degree}_{max_degree}"
    model_name = str(workdir / f"{name}_model")

    t0 = time.perf_counter()
    graphs, _ = generate_graph_dataset(
        num_graphs, nodes, nodes, min_degree, max_degree, base_seed=seed,
    )
    phases["generation"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    ds = process_graphs(graphs, DataConfig(max_nodes=pad_to))
    dataset_path = workdir / f"{name}_dataset.npz"
    save_dataset(ds, dataset_path)
    phases["processing"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    params, best_loss, final_epoch, _, history = train_dataset(
        ds, model_name=model_name, device=dev, number_epochs=epochs,
        learning_rate=learning_rate, save_frequency=max(1, epochs // 5), seed=seed,
    )
    _sync(dev)
    phases["training"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    test_graphs, _ = generate_graph_dataset(
        max(2, num_graphs // 4), nodes, nodes, min_degree, max_degree,
        base_seed=seed + 5000,
    )
    tds = process_graphs(test_graphs, DataConfig(max_nodes=pad_to))
    results, by_size = harness.test_multiple_graphs(
        params, tds, [nodes], post_processing_iterations=200, verbose=False, refine=True,
    )
    analysis = harness.analyze_results(results, by_size, [nodes])
    rand = [
        randomized_k_way_maxcut(tds.graphs[k].to(dev), classes, 1000, seed=k)[1]
        for k in sorted(tds.graphs)
    ]
    phases["evaluation"] = time.perf_counter() - t0

    avg_refined = float(np.mean([r["refined_cut"] for r in results]))
    avg_refine_s = float(np.mean([r["refined_time"] for r in results]))
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
        f"- GCN argmax avg cut: {analysis['avg_simple_cut']:.1f}",
        f"- GCN + post-processing avg cut: {analysis['avg_post_cut']:.1f} ({analysis['avg_improvement_pct']:+.1f}%)",
        f"- GCN + multi-start refine avg cut: {avg_refined:.1f} ({avg_refine_s:.4f} s a graph)",
        f"- Randomized baseline avg cut: {float(np.mean(rand)):.1f}",
        f"- Post-processing overhead: {analysis['avg_overhead']:.1f}x",
    ])
    (workdir / f"{name}_SUMMARY.md").write_text(summary)
    return {
        "summary": summary,
        "epochs_run": epochs_run,
        "training_s": phases["training"],
        "epoch_ms": phases["training"] / epochs_run * 1e3,
        "best_loss": best_loss,
        "history": history,
        "avg_simple_cut": analysis["avg_simple_cut"],
        "avg_post_cut": analysis["avg_post_cut"],
        "avg_refined_cut": avg_refined,
        "avg_refine_s": avg_refine_s,
        "avg_randomized_cut": float(np.mean(rand)),
        "dataset": str(dataset_path),
        "final_checkpoint": checkpoint_name(model_name) + ".npz",
    }


def _cmd_pipeline(args) -> int:
    res = run_pipeline(
        args.workdir, args.num_graphs, args.nodes, args.min_degree,
        args.max_degree, args.pad_to, args.classes, args.epochs,
        args.learning_rate, args.seed, device=args.device,
    )
    print(res["summary"])
    return 0


def _cmd_solve(args) -> int:
    from gcn_maxcut_tpu_torch.device import resolve_device

    dev = resolve_device(args.device)
    if args.method == "sweep":
        # the scalable classical search: O(E) a sweep, native host code
        from gcn_maxcut_tpu_torch.baselines.sweep import greedy_sweep_maxcut
        from gcn_maxcut_tpu_torch.data.generate import random_regular_edges

        edges = random_regular_edges(args.n, args.d, seed=args.seed)
        rng = np.random.default_rng(args.seed)
        init = rng.integers(0, args.k, args.n)
        init[: args.k] = np.arange(args.k)
        t0 = time.perf_counter()
        _, cut, sweeps = greedy_sweep_maxcut(edges, args.n, init, k=args.k)
        print(json.dumps({
            "n": args.n, "d": args.d, "k": args.k, "method": "greedy_sweep",
            "cut_value": cut, "cut_fraction": cut / edges.shape[0],
            "sweeps": sweeps,
            "solve_time_s": round(time.perf_counter() - t0, 3),
        }))
        return 0

    from gcn_maxcut_tpu_torch.baselines.exact import anytime_solver
    from gcn_maxcut_tpu_torch.baselines.randomized import randomized_k_way_maxcut
    from gcn_maxcut_tpu_torch.data.generate import generate_graph
    from gcn_maxcut_tpu_torch.data.process import DataConfig, process_graphs

    spec = generate_graph(n=args.n, d=args.d, graph_type="reg", seed=args.seed)
    g = process_graphs([spec], DataConfig(max_nodes=args.n)).graphs[0].to(dev)
    res = anytime_solver(g, k=args.k, time_limit=args.time_limit, seed=args.seed)
    _, rand_cut, _ = randomized_k_way_maxcut(g, args.k, 1000, seed=args.seed)
    print(json.dumps({
        "n": args.n,
        "d": args.d,
        "k": args.k,
        "method": res["method"],
        "cut_value": res["cut_value"],
        "solve_time_s": round(res["solve_time"], 3),
        "randomized_cut": rand_cut,
        "restarts": res["restarts"],
    }))
    return 0


def _cmd_convert(args) -> int:
    """Migrate checkpoints: the reference's ``.pth`` <-> the npz layout.
    Host code: the state is built on the CPU."""
    from gcn_maxcut_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from gcn_maxcut_tpu_torch.train.config import TrainingConfig
    from gcn_maxcut_tpu_torch.train.loop import setup_train_state
    from gcn_maxcut_tpu_torch.train.torch_compat import (
        adam_state_from_torch,
        load_torch_checkpoint,
        save_torch_checkpoint,
    )

    src, dst = args.input, args.output
    if src.endswith((".pth", ".pt")):
        params, _, meta = load_torch_checkpoint(src)
        cfg = meta.get("config") or TrainingConfig()
        state = setup_train_state(cfg, device="cpu")
        if "embed" not in params:           # keep the template's embedding
            params["embed"] = state.params()["embed"]
        opt_state = (adam_state_from_torch(state, state.params(), meta["torch_optimizer"])
                     if meta.get("torch_optimizer") else state.opt_state())
        out = save_checkpoint(dst, params=params, opt_state=opt_state,
                              epoch=meta.get("epoch", 0),
                              loss_history=meta.get("loss_history"), config=cfg)
        direction = "torch->npz"
    else:
        with np.load(src if src.endswith(".npz") else src + ".npz") as d:
            meta_raw = json.loads(bytes(d["_meta"]).decode())
        cfg = (TrainingConfig.from_json(meta_raw["config"])
               if meta_raw.get("config") else TrainingConfig())
        state = setup_train_state(cfg, device="cpu")
        params, opt_state, _, meta = load_checkpoint(src, state.params(), state.opt_state())
        out = save_torch_checkpoint(dst, params, epoch=meta.get("epoch", 0),
                                    loss_history=meta.get("loss_history"), config=cfg,
                                    opt_state=opt_state)
        direction = "npz->torch"
    print(json.dumps({"converted": str(out), "direction": direction,
                      "epoch": meta.get("epoch", 0)}))
    return 0


def _cmd_bench(args) -> int:
    from gcn_maxcut_tpu_torch.bench.giant_demo import (
        train_banded_giant,
        train_banded_giant_packed,
    )

    if args.what == "all":
        from gcn_maxcut_tpu_torch.bench import microbench

        for what, bench in (
            ("spmm", lambda: microbench.bench_spmm(n=args.n, d=args.d, device=args.device)),
            ("banded", lambda: microbench.bench_spmm_banded(device=args.device)),
            ("train", lambda: microbench.bench_train_epoch(device=args.device)),
            ("post", lambda: microbench.bench_post_processing(device=args.device)),
        ):
            print(json.dumps({what: bench()}, default=float), flush=True)
        return 0
    if args.what == "quality":
        from gcn_maxcut_tpu_torch.bench.quality import run_quality_suite

        res = run_quality_suite(recipe=args.recipe, device=args.device)
        print(json.dumps({"quality": res}, default=float))
        return 0
    if args.what in ("train", "post"):
        from gcn_maxcut_tpu_torch.bench import microbench

        if args.what == "train":
            res = microbench.bench_train_epoch(device=args.device)
        else:
            res = microbench.bench_post_processing(device=args.device)
        print(json.dumps({args.what: res}, default=float))
        return 0
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
    if args.what == "kway":
        from gcn_maxcut_tpu_torch.bench.kway_sweep import kway_sweep

        res = kway_sweep(n=args.n, d=args.d, epochs=args.giant_epochs,
                         partition=args.partition, block_ell=args.block_ell,
                         device=args.device)
        print(json.dumps({"kway": res}, default=float))
        return 0
    if args.what == "scaling":
        from gcn_maxcut_tpu_torch.bench.scaling import scaling_sweep

        print(json.dumps({"scaling": scaling_sweep(n=args.n, d=args.d, device=args.device)},
                         default=float))
        return 0
    if args.what == "hybrid":
        from gcn_maxcut_tpu_torch.data.generate import random_regular_edges
        from gcn_maxcut_tpu_torch.device import resolve_device
        from gcn_maxcut_tpu_torch.parallel.giant import GiantConfig
        from gcn_maxcut_tpu_torch.parallel.hybrid import train_hybrid
        from gcn_maxcut_tpu_torch.parallel.mesh import make_mesh

        dev = resolve_device(args.device)
        devs = ([torch.device("cuda", i) for i in range(torch.cuda.device_count())]
                if dev.type == "cuda" and dev.index is None else [dev])
        r_ax = 2 if len(devs) % 2 == 0 and len(devs) > 1 else 1
        n = max(256, args.n // 100)
        lists = []
        for s in range(r_ax):
            e = random_regular_edges(n, args.d, seed=s)
            lists.append((np.concatenate([e[:, 0], e[:, 1]]),
                          np.concatenate([e[:, 1], e[:, 0]])))
        res = train_hybrid(
            lists, n,
            GiantConfig(dim_embedding=32, hidden_dim=16, number_epochs=args.giant_epochs,
                        epochs_per_call=10),
            mesh=make_mesh(("data", "graph"), shape=(r_ax, len(devs) // r_ax), devices=devs),
        )
        print(json.dumps({"hybrid": res}, default=float))
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

    g = sub.add_parser("generate", help="generate + process a graph dataset")
    g.add_argument("--num-graphs", type=int, default=20)
    g.add_argument("--min-nodes", type=int, default=500)
    g.add_argument("--max-nodes", type=int, default=500)
    g.add_argument("--min-degree", type=int, default=6)
    g.add_argument("--max-degree", type=int, default=8)
    g.add_argument("--graph-type", default="reg")
    g.add_argument("--pad-to", type=int, default=1000)
    g.add_argument("--seed", type=int, default=1000)
    g.add_argument("--output", default="dataset.npz")
    g.set_defaults(fn=_cmd_generate)

    t = sub.add_parser("train", help="train GCNSoftmax on a dataset")
    t.add_argument("--dataset", required=True)
    t.add_argument("--model-name", default="maxcut_model")
    t.add_argument("--epochs", type=int, default=1000)
    t.add_argument("--learning-rate", type=float, default=1e-3)
    t.add_argument("--dropout", type=float, default=0.0)
    t.add_argument("--patience", type=int, default=20)
    t.add_argument("--save-frequency", type=int, default=100)
    t.add_argument("--seed", type=int, default=0)
    t.add_argument("--loss-mode", default="ste", choices=("ste", "quantile"),
                   help="ste = the reference's STE argmax loss; quantile = train on "
                        "mean + c*std of the sampled decode (best-of-N objective)")
    t.add_argument("--quantile-c", type=float, default=2.6)
    t.add_argument("--entropy-weight", type=float, default=0.0,
                   help="reward per-node entropy (sampled-decode diversity lever)")
    t.add_argument("--lr-schedule", default="constant", choices=("constant", "cosine"),
                   help="cosine: decay the learning rate to lr_final_fraction of it "
                        "over the run's steps")
    t.add_argument("--metrics", default=None,
                   help="write per-epoch JSONL metrics (loss, step time) to this path")
    t.add_argument("--resume", default=None,
                   help="warm-start from a checkpoint (.npz) incl. optimizer state")
    t.add_argument("--device", default=None, help="default: the CUDA device")
    t.set_defaults(fn=_cmd_train)

    e = sub.add_parser("test", help="evaluate a checkpoint on a dataset")
    e.add_argument("--dataset", required=True)
    e.add_argument("--checkpoint", required=True)
    e.add_argument("--sizes", default=None, help="comma-separated size buckets")
    e.add_argument("--iterations", type=int, default=200)
    e.add_argument("--refine", action=argparse.BooleanOptionalAction, default=True,
                   help="greedy-flip refinement after post-processing (default: on; "
                        "--no-refine gives the reference's two decoders)")
    e.add_argument("--refine-starts", type=int, default=4,
                   help="refine starts: the top N-1 sampled assignments + the argmax, "
                        "climbed in one batched pass (1 = one climb from the post best)")
    e.add_argument("--output", default=None)
    e.add_argument("--device", default=None, help="default: the CUDA device")
    e.set_defaults(fn=_cmd_test)

    s = sub.add_parser("solve", help="run a classical solver on a random graph")
    s.add_argument("--n", type=int, default=100)
    s.add_argument("--d", type=int, default=8)
    s.add_argument("--k", type=int, default=3)
    s.add_argument("--time-limit", type=float, default=60.0)
    s.add_argument("--seed", type=int, default=0)
    s.add_argument("--method", choices=["anytime", "sweep"], default="anytime",
                   help="anytime = exact or batched SA + greedy chains (the CPLEX "
                        "stand-in, n <= ~1k); sweep = the native O(E)-a-sweep search "
                        "for 100k..10M-node graphs")
    s.add_argument("--device", default=None, help="default: the CUDA device")
    s.set_defaults(fn=_cmd_solve)

    c = sub.add_parser("convert", help="migrate checkpoints between the reference's "
                                       ".pth and the npz layout (trusted files only)")
    c.add_argument("input", help="source checkpoint (.pth/.pt or .npz)")
    c.add_argument("output", help="destination checkpoint path")
    c.set_defaults(fn=_cmd_convert)

    b = sub.add_parser("bench", help="microbenchmarks, the quality suite and the "
                                     "single-device trainers")
    b.add_argument("--what", choices=["giant", "spmm", "banded", "locality", "quality",
                                      "train", "post", "kway", "scaling", "hybrid", "all"],
                   default="all",
                   help="all = spmm, banded, train, post, in that order")
    b.add_argument("--recipe", choices=["n500", "mixed", "per_size"], default="mixed",
                   help="quality-suite training recipe (see bench/quality.py)")
    b.add_argument("--n", type=int, default=100_000,
                   help="nodes (spmm, locality, kway, scaling; hybrid: n / 100)")
    b.add_argument("--d", type=int, default=8)
    b.add_argument("--epochs", type=int, default=200, help="locality trainer epochs")
    b.add_argument("--giant-nodes", type=int, default=10_002_432)
    b.add_argument("--giant-epochs", type=int, default=40,
                   help="epochs of the giant trainer, of each k of the kway sweep and of "
                        "the hybrid trainer")
    b.add_argument(
        "--giant-layout", choices=["packed", "plain"], default="packed",
        help="packed = interleaved node order, every aggregation 16 wide",
    )
    b.add_argument(
        "--act-dtype", choices=["float32", "bfloat16"], default="float32",
        help="packed giant activation dtype",
    )
    b.add_argument(
        "--partition", choices=["contiguous", "bfs", "metis"], default="contiguous",
        help="node -> shard partitioner of the kway sweep's sharded trainer",
    )
    b.add_argument(
        "--block-ell", action="store_true",
        help="kway: hop-0 aggregation on the block-ELL kernel where every shard bands "
             "after a per-shard RCM (expanders keep the gather tables)",
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
    get_logger()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
