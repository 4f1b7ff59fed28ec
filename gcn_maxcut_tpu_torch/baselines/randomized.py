"""Randomized k-way max-cut baseline and its harnesses.

Port of ``gcn_maxcut_tpu/baselines/randomized.py`` (the reference's
``RandomAlgorithm/RandomizedMaxCut.py``): ``randomized_k_way_maxcut``
samples a chunk of uniform assignments (terminals pinned) and scores them
in one batched pass, and replays the reference's sequential
threshold/patience early stop over the cuts on the host;
``evaluate_algorithm_on_graphs``, ``benchmark_algorithm``,
``test_fixed_terminals`` and ``quick_demo`` are its harnesses, with the
JAX result keys.  Draws come from a ``torch.Generator`` seeded with
``seed`` on the graph's device (JAX: ``jax.random`` keys), so cuts are
not JAX's draw for draw.  ``benchmark_algorithm`` and ``quick_demo`` build
their graphs on the host and run on ``device`` (default: the CUDA
device).

A test module must import ``test_fixed_terminals`` under another name, or
pytest collects it as a test.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from gcn_maxcut_tpu_torch.core.graph import Graph
from gcn_maxcut_tpu_torch.objectives.cut_loss import hard_cut_value

logger = logging.getLogger(__name__)


def randomized_k_way_maxcut(
    g: Graph,
    k: int = 3,
    max_iterations: int = 1000,
    threshold: float = 0.0,
    patience: int = 100,
    fixed_terminals: bool = True,
    num_terminals: int = 3,
    seed: int = 0,
    chunk_size: int = 512,
) -> Tuple[np.ndarray, float, int]:
    """Best of random assignments on the graph's device; returns
    ``(assignment[:n], best_cut, iterations_used)``.  Stops after
    ``patience`` consecutive draws that do not beat the running best by
    more than ``threshold``."""
    gen = torch.Generator(device=g.device).manual_seed(seed)
    num_fixed = num_terminals if fixed_terminals else 0
    n = int(g.n_nodes)
    ids = torch.arange(g.n_pad, device=g.device)[None, :]

    best_cut, best_asn = -np.inf, None
    used = 0
    remaining = max_iterations
    stall = 0
    while remaining > 0:
        chunk = min(chunk_size, remaining)
        asn = torch.randint(0, k, (chunk, g.n_pad), generator=gen, device=g.device)
        asn = torch.where(ids < num_fixed, ids, asn)
        cuts = hard_cut_value(g, asn).cpu().numpy()
        stopped = False
        for i, c in enumerate(cuts):
            used += 1
            if c - best_cut > threshold:
                best_cut = float(c)
                best_asn = asn[i, :n].cpu().numpy()
                stall = 0
            else:
                stall += 1
                if stall >= patience:
                    stopped = True
                    break
        if stopped:
            break
        remaining -= chunk
    return best_asn, best_cut, used


def _sync(g: Graph) -> None:
    if g.device.type == "cuda":
        torch.cuda.synchronize(g.device)


def evaluate_algorithm_on_graphs(
    graphs: List[Graph],
    k: int = 3,
    max_iterations: int = 1000,
    seed: int = 0,
    **kwargs,
) -> Dict[str, float]:
    """Mean cut and wall time over a graph list (reference :125-160);
    graph i runs with seed ``seed + i``."""
    cuts, times = [], []
    for i, g in enumerate(graphs):
        t0 = time.perf_counter()
        _, cut, _ = randomized_k_way_maxcut(g, k, max_iterations, seed=seed + i, **kwargs)
        _sync(g)
        times.append(time.perf_counter() - t0)
        cuts.append(cut)
    return {
        "avg_cut": float(np.mean(cuts)),
        "std_cut": float(np.std(cuts)),
        "avg_time": float(np.mean(times)),
        "total_time": float(np.sum(times)),
        "cuts": cuts,
        "times": times,
    }


def _regular_graph(n: int, d: int, seed: int, device) -> Graph:
    from gcn_maxcut_tpu_torch.data.generate import generate_graph
    from gcn_maxcut_tpu_torch.data.process import DataConfig, process_graphs
    from gcn_maxcut_tpu_torch.device import resolve_device

    spec = generate_graph(n=n, d=d, graph_type="reg", seed=seed)
    return process_graphs([spec], DataConfig(max_nodes=n)).graphs[0].to(resolve_device(device))


def benchmark_algorithm(
    node_sizes: List[int] = (1000, 2000, 3000, 4000, 5000),
    k_values: List[int] = (3, 4, 5, 10),
    degree: int = 8,
    iterations: int = 10_000,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> Dict[Tuple[int, int], Dict[str, float]]:
    """Sweep n × k (reference ``benchmark_algorithm`` :163-211): one
    ``degree``-regular graph a size (seed ``seed + n``), the best of
    ``iterations`` draws for each k."""
    results = {}
    for n in node_sizes:
        g = _regular_graph(n, degree, seed + n, device)
        for k in k_values:
            t0 = time.perf_counter()
            _, cut, used = randomized_k_way_maxcut(g, k, iterations, seed=seed)
            _sync(g)
            dt = time.perf_counter() - t0
            results[(n, k)] = {
                "cut": cut,
                "time": dt,
                "iterations_used": used,
                "normalized_cut": cut / (n * degree / 2),
            }
            logger.info("benchmark n=%d k=%d: cut=%.0f (%.3fs, %d iters)", n, k, cut, dt, used)
    return results


def test_fixed_terminals(
    g: Graph, k: int = 3, iterations: int = 1000, seed: int = 0
) -> Dict[str, Dict]:
    """Terminals pinned against free (reference :283-342)."""
    out = {}
    for fixed in (True, False):
        t0 = time.perf_counter()
        asn, cut, used = randomized_k_way_maxcut(g, k, iterations, fixed_terminals=fixed,
                                                 seed=seed)
        _sync(g)
        out["fixed" if fixed else "free"] = {
            "cut": cut,
            "time": time.perf_counter() - t0,
            "iterations_used": used,
            "terminals_ok": bool(np.all(asn[:3] == np.arange(3))) if fixed else None,
        }
    return out


def quick_demo(
    n: int = 500, d: int = 8, k: int = 3, seed: int = 0,
    device: str | torch.device | None = None,
) -> Dict:
    """The n = 500, d = 8, k = 3 demo (reference :345-371)."""
    g = _regular_graph(n, d, seed, device)
    _, cut, used = randomized_k_way_maxcut(g, k, 1000, seed=seed)
    total_w = n * d / 2
    logger.info("quick demo n=%d d=%d k=%d: cut %.0f / %d edges (%.1f%%), %d iters",
                n, d, k, cut, int(total_w), 100 * cut / total_w, used)
    return {"cut": cut, "edges": total_w, "iterations_used": used}
