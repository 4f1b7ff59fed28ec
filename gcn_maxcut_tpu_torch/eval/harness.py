"""Evaluation harness: per-graph tests, size-bucketed sweeps, analysis, reports.

Port of ``gcn_maxcut_tpu/eval/harness.py``, with the same result keys,
defaults and report text (the reference's ``Testing/TestingNeuralNetwork.py``
contract).  Each graph runs the forward pass, the argmax decode, the
sampled post-processing and, with ``refine``, the multi-start greedy-flip
refine on the device that holds the parameters.  The post-processing and
the refine share one draw of uniforms, as the JAX package's share one key,
so the refine climbs from the post-processed best sample among its starts.

Stage times are CUDA events around the stage on the card (one warm-up,
then the best of a few calls; the refine's host reads included), the host
clock on the CPU.  They draw from their own generator, so the results do
not depend on whether times are measured.
"""

from __future__ import annotations

import json
import logging
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from gcn_maxcut_tpu_torch.bench.microbench import time_stats
from gcn_maxcut_tpu_torch.core.graph import Graph, dense_adjacency
from gcn_maxcut_tpu_torch.data.process import ProcessedDataset
from gcn_maxcut_tpu_torch.eval.decode import (
    best_of_samples,
    post_process,
    refine_multi_start,
    refine_multi_start_from_uniforms,
    refine_with_local_search,
    rollout_uniforms,
    sample_partitions_from_uniforms,
    simple_assignment,
)
from gcn_maxcut_tpu_torch.models.gcn import gcn_softmax_apply
from gcn_maxcut_tpu_torch.objectives.cut_loss import hard_cut_value
from gcn_maxcut_tpu_torch.train.loop import _resolve_dense_aggregation
from gcn_maxcut_tpu_torch.utils.profiling import span

logger = logging.getLogger(__name__)

STAGE_REPEATS = 3      # timed calls of a stage after its warm-up; the best is kept


@torch.no_grad()
def _forward(params: Dict[str, Any], g: Graph, aggregation: str = "auto") -> torch.Tensor:
    """GCNSoftmax probabilities with the training loop's dense rule."""
    x = dense_adjacency(g, width=params["conv1"]["w"].shape[0])
    a = (dense_adjacency(g, values="mask")
         if _resolve_dense_aggregation(aggregation, g.n_pad) else None)
    return gcn_softmax_apply(
        {"conv1": params["conv1"], "conv2": params["conv2"]}, g, x, a_dense=a
    )


def _decode_simple(g: Graph, probs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    asn = simple_assignment(probs)
    return asn, hard_cut_value(g, asn)


def _stage_time(fn: Callable[[], object], dev: torch.device) -> float:
    """Seconds of one call of a decode stage: the best of ``STAGE_REPEATS``
    after one warm-up."""
    return time_stats(fn, dev, STAGE_REPEATS, warmup=1)["best_s"]


@torch.no_grad()
def test_single_graph(
    params: Any,
    g: Graph,
    generator: torch.Generator,
    post_processing_iterations: int = 200,
    terminals: Optional[List[int]] = None,
    refine: bool = False,
    measure_times: bool = True,
    refine_starts: int = 4,
) -> Dict[str, Any]:
    """Simple (argmax) and post-processed decode with timings; ``refine``
    adds ``refined_cut``, ``refined_time`` and ``refined_assignment``: the
    multi-start greedy flip from the top ``refine_starts − 1`` samples plus
    the argmax decode (``refine_starts=1``: one climb from the
    post-processed best).  ``measure_times=False`` reports 0.0 times.

    ``g`` is moved to the parameters' device.  Errors are caught per graph
    and returned as ``{"success": False, "error": ...}``.  Under a profiler
    session the call is the span ``decode.graph``, its stages
    ``decode.to_device``, ``decode.forward``, ``decode.rollouts`` (argmax
    decode, uniforms, samples, best of samples), ``decode.climb`` and
    ``decode.readback`` (the closing host reads), ``utils/profiling.py``.
    """
    with span("decode.graph"):
        try:
            dev = params["conv1"]["w"].device
            with span("decode.to_device"):
                g = g.to(dev)
            with span("decode.forward"):
                probs = _forward(params, g)
            with span("decode.rollouts"):
                simple_asn, simple_cut = _decode_simple(g, probs)
                u = rollout_uniforms(probs, generator, post_processing_iterations)
                post_asn, post_cut = best_of_samples(g, sample_partitions_from_uniforms(probs, u))
            if refine:
                with span("decode.climb"):
                    if refine_starts > 1:
                        ref_asn, ref_cut = refine_multi_start_from_uniforms(
                            g, probs, u, refine_starts)
                    else:
                        ref_asn, ref_cut = refine_with_local_search(g, post_asn)

            simple_time = post_time = refined_time = 0.0
            if measure_times:
                timing_gen = torch.Generator(device=dev).manual_seed(0)
                simple_time = _stage_time(lambda: _decode_simple(g, probs), dev)
                post_time = _stage_time(
                    lambda: post_process(g, probs, timing_gen, post_processing_iterations), dev)
                if refine and refine_starts > 1:
                    refined_time = _stage_time(lambda: refine_multi_start(
                        g, probs, timing_gen, post_processing_iterations, refine_starts), dev)
                elif refine:
                    refined_time = _stage_time(lambda: refine_with_local_search(g, post_asn), dev)

            with span("decode.readback"):
                n = int(g.n_nodes)
                refined: Dict[str, Any] = {}
                if refine:
                    refined = {
                        "refined_cut": float(ref_cut),
                        "refined_time": refined_time,
                        "refined_assignment": ref_asn[:n].cpu().numpy(),
                    }
                simple_cut, post_cut = float(simple_cut), float(post_cut)
                simple_assignment = simple_asn[:n].cpu().numpy()
                post_assignment = post_asn[:n].cpu().numpy()
                node_probabilities = probs[:n].cpu().numpy()
                edges = int(g.n_edges) // 2
            improvement = post_cut - simple_cut
            return refined | {
                "success": True,
                "nodes": n,
                "edges": edges,
                "simple_cut": simple_cut,
                "simple_time": simple_time,
                "simple_assignment": simple_assignment,
                "post_cut": post_cut,
                "post_time": post_time,
                "post_assignment": post_assignment,
                "improvement": improvement,
                "improvement_percent": (
                    improvement / simple_cut * 100 if simple_cut > 0 else 0.0
                ),
                "terminals": terminals if terminals is not None else [0, 1, 2],
                "node_probabilities": node_probabilities,
            }
        except Exception as e:  # per-graph error capture, reference :180-186
            logger.exception("graph test failed")
            return {
                "success": False,
                "error": str(e),
                "nodes": int(g.n_nodes),
                "edges": int(g.n_edges) // 2,
            }


def test_multiple_graphs(
    params: Any,
    dataset: ProcessedDataset,
    graph_sizes: List[int],
    post_processing_iterations: int = 200,
    verbose: bool = True,
    seed: int = 0,
    size_tolerance: int = 5,
    refine: bool = False,
    measure_times: bool = True,
    refine_starts: int = 4,
) -> Tuple[List[Dict], Dict]:
    """Sweep the dataset, bucketing each graph by the nearest configured
    size within ± ``size_tolerance`` and skipping graphs that match none.

    Each tested graph draws from its own generator, seeded in dataset order
    from a numpy generator seeded with ``seed``.
    """
    results_by_size: Dict[int, Dict] = {
        size: {
            "simple": {"cut_values": [], "times": []},
            "post_processed": {"cut_values": [], "times": []},
        }
        for size in graph_sizes
    }
    test_results: List[Dict] = []
    seeds = np.random.default_rng(seed)
    dev = params["conv1"]["w"].device

    items = sorted(dataset.graphs.items())
    for count, (key_idx, g) in enumerate(items, 1):
        n = int(g.n_nodes)
        closest = min(graph_sizes, key=lambda s: abs(s - n))
        graph_size = closest if abs(closest - n) <= size_tolerance else n
        if graph_size not in graph_sizes:
            if verbose:
                logger.info("skipping graph %s: size %d not configured", key_idx, n)
            continue

        gen = torch.Generator(device=dev).manual_seed(int(seeds.integers(2**62)))
        result = test_single_graph(
            params,
            g,
            gen,
            post_processing_iterations,
            terminals=dataset.specs[key_idx].terminals,
            refine=refine,
            measure_times=measure_times,
            refine_starts=refine_starts,
        )
        if result["success"]:
            result.update({"graph_name": f"graph_{key_idx}", "graph_size": graph_size})
            test_results.append(result)
            bucket = results_by_size[graph_size]
            bucket["simple"]["cut_values"].append(result["simple_cut"])
            bucket["simple"]["times"].append(result["simple_time"])
            bucket["post_processed"]["cut_values"].append(result["post_cut"])
            bucket["post_processed"]["times"].append(result["post_time"])
            if verbose:
                logger.info(
                    "graph %d/%d n=%d: simple=%.0f (%.4fs) post=%.0f (%.4fs) %+.1f%%",
                    count,
                    len(items),
                    n,
                    result["simple_cut"],
                    result["simple_time"],
                    result["post_cut"],
                    result["post_time"],
                    result["improvement_percent"],
                )
        elif verbose:
            logger.warning("graph %s failed: %s", key_idx, result["error"])

    return test_results, results_by_size


def analyze_results(
    test_results: List[Dict], results_by_size: Dict, graph_sizes: List[int]
) -> Dict[str, Any]:
    """Statistics with the reference's output fields (:297-382)."""
    if not test_results:
        return {"error": "No test results available"}

    simple_cuts = [r["simple_cut"] for r in test_results]
    post_cuts = [r["post_cut"] for r in test_results]
    improvements = [r["improvement"] for r in test_results]
    improvement_pcts = [r["improvement_percent"] for r in test_results]
    simple_times = [r["simple_time"] for r in test_results]
    post_times = [r["post_time"] for r in test_results]

    better = sum(1 for i in improvements if i > 0)
    same = sum(1 for i in improvements if i == 0)
    worse = sum(1 for i in improvements if i < 0)
    avg_simple_time = float(np.mean(simple_times))
    avg_post_time = float(np.mean(post_times))

    size_analysis = {}
    for size in sorted(graph_sizes):
        bucket = results_by_size.get(size)
        if not bucket or not bucket["simple"]["cut_values"]:
            continue
        s_vals = bucket["simple"]["cut_values"]
        p_vals = bucket["post_processed"]["cut_values"]
        s_t = bucket["simple"]["times"]
        p_t = bucket["post_processed"]["times"]
        s_avg, p_avg = float(np.mean(s_vals)), float(np.mean(p_vals))
        s_t_avg, p_t_avg = float(np.mean(s_t)), float(np.mean(p_t))
        size_analysis[size] = {
            "count": len(s_vals),
            "simple_avg": s_avg,
            "post_avg": p_avg,
            "improvement_avg": p_avg - s_avg,
            "improvement_pct": (p_avg - s_avg) / s_avg * 100 if s_avg > 0 else 0.0,
            "simple_time_avg": s_t_avg,
            "post_time_avg": p_t_avg,
            "time_ratio": p_t_avg / s_t_avg if s_t_avg > 0 else 0.0,
        }

    total = len(test_results)
    return {
        "total_tests": total,
        "avg_simple_cut": float(np.mean(simple_cuts)),
        "avg_post_cut": float(np.mean(post_cuts)),
        "avg_improvement": float(np.mean(improvements)),
        "avg_improvement_pct": float(np.mean(improvement_pcts)),
        "std_improvement": float(np.std(improvements)),
        "better_count": better,
        "same_count": same,
        "worse_count": worse,
        "avg_simple_time": avg_simple_time,
        "avg_post_time": avg_post_time,
        "avg_overhead": avg_post_time / avg_simple_time if avg_simple_time > 0 else 0.0,
        "size_analysis": size_analysis,
        "improvement_rate": better / total,
    }


def print_analysis_report(analysis: Dict[str, Any], graph_sizes: List[int]) -> str:
    """Text report in the reference's layout (:384-428); returns (and
    prints) it."""
    if "error" in analysis:
        text = f"Analysis Error: {analysis['error']}"
        print(text)
        return text

    t = analysis["total_tests"]
    lines = [
        "Performance Analysis",
        "=" * 60,
        f"Overall Results ({t} graphs):",
        "",
        "Cut Value Performance:",
        f"  Simple GCN Average:     {analysis['avg_simple_cut']:.2f}",
        f"  Post-processed Average: {analysis['avg_post_cut']:.2f}",
        f"  Average Improvement:    {analysis['avg_improvement']:+.2f} "
        f"({analysis['avg_improvement_pct']:+.1f}%)",
        f"  Std Dev Improvement:    {analysis['std_improvement']:.2f}",
        "",
        "Improvement Distribution:",
        f"  Post-processing better: {analysis['better_count']}/{t} "
        f"({analysis['improvement_rate'] * 100:.1f}%)",
        f"  Same performance:       {analysis['same_count']}/{t} "
        f"({analysis['same_count'] / t * 100:.1f}%)",
        f"  Post-processing worse:  {analysis['worse_count']}/{t} "
        f"({analysis['worse_count'] / t * 100:.1f}%)",
        "",
        "Runtime Performance:",
        f"  Simple GCN Average:     {analysis['avg_simple_time']:.4f}s",
        f"  Post-processed Average: {analysis['avg_post_time']:.4f}s",
        f"  Runtime Overhead:       {analysis['avg_overhead']:.1f}x",
        "",
        "=" * 60,
        "Results by Graph Size:",
        f"{'Size':<6} {'Count':<6} {'Simple':<8} {'Post':<8} "
        f"{'Improvement':<12} {'Runtime':<10}",
        f"{'-' * 6} {'-' * 6} {'-' * 8} {'-' * 8} {'-' * 12} {'-' * 10}",
    ]
    for size in sorted(graph_sizes):
        sa = analysis["size_analysis"].get(size)
        if sa:
            lines.append(
                f"{size:<6} {sa['count']:<6} {sa['simple_avg']:<8.1f} "
                f"{sa['post_avg']:<8.1f} {sa['improvement_pct']:<+7.1f}%     "
                f"{sa['time_ratio']:<6.1f}x"
            )
    text = "\n".join(lines)
    print(text)
    return text


def generate_summary_report(
    analysis: Dict[str, Any],
    testing_config: Dict[str, Any],
    model_config: Optional[Dict[str, Any]] = None,
) -> str:
    """Markdown summary with the reference's recommendation thresholds
    (:566-639): ≥ 70% improvement rate and ≤ 2× overhead."""
    rate = analysis.get("improvement_rate", 0.0)
    overhead = analysis.get("avg_overhead", 0.0)
    if rate >= 0.7 and overhead <= 2.0:
        rec = "RECOMMENDED: post-processing improves most graphs at low cost."
    elif rate >= 0.7:
        rec = (
            "CONDITIONAL: post-processing improves most graphs but costs "
            f"{overhead:.1f}x runtime; use when quality matters more than latency."
        )
    else:
        rec = "NOT RECOMMENDED: post-processing rarely improves results."
    lines = [
        "# Neural Network Testing Summary",
        "",
        f"Generated: {time.strftime('%Y-%m-%d %H:%M:%S')}",
        "",
        "## Testing Configuration",
        "```json",
        json.dumps(testing_config, indent=2, default=str),
        "```",
        "",
        "## Results",
        f"- Graphs tested: {analysis.get('total_tests', 0)}",
        f"- Avg simple cut: {analysis.get('avg_simple_cut', 0):.2f}",
        f"- Avg post-processed cut: {analysis.get('avg_post_cut', 0):.2f}",
        f"- Avg improvement: {analysis.get('avg_improvement_pct', 0):+.1f}%",
        f"- Improvement rate: {rate * 100:.1f}%",
        f"- Runtime overhead: {overhead:.1f}x",
        "",
        "## Recommendation",
        rec,
    ]
    if model_config:
        lines += ["", "## Model Configuration", "```json",
                  json.dumps(model_config, indent=2, default=str), "```"]
    return "\n".join(lines)


def save_results(
    path: str | Path,
    test_results: List[Dict],
    results_by_size: Dict,
    analysis: Dict,
    testing_config: Dict,
    model_config: Optional[Dict] = None,
) -> Path:
    """The results package as JSON (reference :539-564 contract), without
    the per-node probabilities."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)

    def clean(obj):
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        if isinstance(obj, (np.floating, np.integer)):
            return obj.item()
        if isinstance(obj, dict):
            return {str(k): clean(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return [clean(v) for v in obj]
        return obj

    package = {
        "individual_results": clean(
            [
                {k: v for k, v in r.items() if k != "node_probabilities"}
                for r in test_results
            ]
        ),
        "results_by_size": clean(results_by_size),
        "analysis": clean(analysis),
        "testing_config": clean(testing_config),
        "model_config": clean(model_config or {}),
        "timestamp": time.strftime("%Y-%m-%d %H:%M:%S"),
    }
    path.write_text(json.dumps(package, indent=2, default=str))
    return path


def load_results(path: str | Path) -> Dict[str, Any]:
    return json.loads(Path(path).read_text())
