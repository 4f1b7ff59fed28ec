"""Enhanced dataset processing: baseline statistics stamped per graph.

Port of ``gcn_maxcut_tpu/data/enhanced.py`` (the reference's
``EnhancedDataProcessor``, ``DataGenerator/prepareData.ipynb`` cells 5–7):
the randomized baseline, the flow-based k-way cut and the anytime solver
for each graph, stored on the dataset as ``baseline_stats`` so that
evaluation can report quality ratios without solving again.  Each graph
runs on ``device`` (default: the CUDA device); the flow cut is host code.
"""

from __future__ import annotations

import logging
import time
from typing import Dict

import torch

from gcn_maxcut_tpu_torch.baselines.exact import anytime_solver, recursive_flow_min_cut
from gcn_maxcut_tpu_torch.baselines.randomized import randomized_k_way_maxcut
from gcn_maxcut_tpu_torch.data.process import ProcessedDataset
from gcn_maxcut_tpu_torch.device import resolve_device

logger = logging.getLogger(__name__)


def compute_baseline_stats(
    dataset: ProcessedDataset,
    *,
    randomized_iterations: int = 1000,
    solver_time_limit: float = 10.0,
    include_flow: bool = True,
    include_solver: bool = True,
    seed: int = 0,
    device: str | torch.device | None = None,
) -> Dict[int, Dict[str, float]]:
    """Per-graph stats: randomized, flow min-cut and anytime solver, with
    their seconds.  Returns ``{graph_index: {...}}`` and also sets it as
    ``dataset.baseline_stats`` (the reference's ``_baseline_stats``)."""
    dev = resolve_device(device)
    stats: Dict[int, Dict[str, float]] = {}
    for i in sorted(dataset.graphs):
        g = dataset.graphs[i].to(dev)
        rec: Dict[str, float] = {
            "n_nodes": int(g.n_nodes),
            "n_edges": int(g.n_edges) // 2,
        }
        t0 = time.perf_counter()
        _, rand_cut, used = randomized_k_way_maxcut(g, 3, randomized_iterations, seed=seed + i)
        rec["randomized_cut"] = float(rand_cut)
        rec["randomized_time_s"] = time.perf_counter() - t0
        rec["randomized_iterations"] = used

        if include_flow:
            t0 = time.perf_counter()
            _, flow_val = recursive_flow_min_cut(g)
            rec["flow_min_cut_value"] = float(flow_val)
            rec["flow_time_s"] = time.perf_counter() - t0

        if include_solver:
            t0 = time.perf_counter()
            res = anytime_solver(g, 3, time_limit=solver_time_limit, seed=seed + i)
            rec["solver_cut"] = float(res["cut_value"])
            rec["solver_method"] = res["method"]
            rec["solver_time_s"] = time.perf_counter() - t0

        stats[i] = rec
        logger.info("baseline stats graph %d (n=%d): randomized %.0f%s", i, rec["n_nodes"],
                    rec["randomized_cut"],
                    f", solver {rec['solver_cut']:.0f}" if include_solver else "")
    dataset.baseline_stats = stats
    return stats
