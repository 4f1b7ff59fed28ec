"""BASELINE config 4: one large regular graph, a k-way sweep with terminals.

Port of ``gcn_maxcut_tpu/bench/kway_sweep.py``.  "Large single graph
n=100k d=8, k-way sweep k=3..8 with terminal constraints — single-host
sharded SpMM": for each k, train the sharded 2-layer GCN
(``parallel/giant.py``, terminals pinned on shard 0) on one n-node
d-regular graph (the native sampler's, the JAX package's graph for the
same seed) and report the decoded cut as a fraction of the edges, beside
the uniform-random floor (k − 1)/k, with the training edges/s.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Sequence

import numpy as np
import torch

from gcn_maxcut_tpu_torch.data.generate import random_regular_edges
from gcn_maxcut_tpu_torch.parallel.giant import GiantConfig, train_giant_graph
from gcn_maxcut_tpu_torch.parallel.mesh import Mesh, make_mesh

logger = logging.getLogger(__name__)


def kway_sweep(
    n: int = 100_000,
    d: int = 8,
    ks: Sequence[int] = (3, 4, 5, 6, 7, 8),
    epochs: int = 60,
    epochs_per_call: int = 10,
    dim_embedding: int = 128,
    hidden_dim: int = 64,
    learning_rate: float = 1e-3,
    seed: int = 0,
    mesh: Mesh | None = None,
    partition: str = "contiguous",
    block_ell: bool = False,
    device: str | torch.device | None = None,
) -> List[Dict[str, float]]:
    """Train one n-node d-regular graph at each k; per-k results.

    Each entry: ``k``, ``final_cut``, ``cut_fraction`` (of the edges),
    ``random_fraction`` ((k − 1)/k), ``edges_per_s`` and the amortized
    timing keys (``train_giant_graph(measure_throughput=True)``; epochs in
    chunks of ``epochs_per_call``, rounded up to whole chunks),
    ``train_time_s``, the partition and assembly seconds.  ``mesh``:
    default every CUDA device (raises without CUDA), or one shard on
    ``device`` when one is named.  ``block_ell`` implies the per-shard RCM relabel; the
    sweep's graph is an expander whose shards do not band, so it keeps
    the gather tables there.
    """
    if mesh is None:
        mesh = make_mesh() if device is None else make_mesh(devices=[device])
    edges = random_regular_edges(n, d, seed=seed)
    src = np.concatenate([edges[:, 0], edges[:, 1]]).astype(np.int32)
    dst = np.concatenate([edges[:, 1], edges[:, 0]]).astype(np.int32)
    total_edges = edges.shape[0]

    results = []
    for k in ks:
        cfg = GiantConfig(
            num_classes=int(k),
            dim_embedding=dim_embedding,
            hidden_dim=hidden_dim,
            learning_rate=learning_rate,
            number_epochs=epochs,
            epochs_per_call=epochs_per_call,
            seed=seed,
            log_every=max(1, epochs // 4),
            partition=partition,
            block_ell=block_ell,
            local_reorder="rcm" if block_ell else "off",
        )
        t0 = time.perf_counter()
        out = train_giant_graph(src, dst, n, cfg, mesh=mesh, measure_throughput=True)
        res = {
            "k": int(k),
            "n": n,
            "d": d,
            "final_cut": out["final_cut"],
            "cut_fraction": out["final_cut"] / total_edges,
            "random_fraction": (k - 1) / k,
            "edges_per_s": out["edges_per_s"],
            "edges_per_s_amortized": out.get("edges_per_s_amortized"),
            "epoch_time_s_amortized": out.get("epoch_time_s_amortized"),
            "timing_reliable": out.get("timing_reliable"),
            "timing_spread_s": out.get("timing_spread_s"),
            "train_time_s": time.perf_counter() - t0,
            "num_shards": out["num_shards"],
            "partition_s": out["partition_s"],
            "assembly_s": out["assembly_s"],
            "block_ell": out["block_ell"],
        }
        logger.info(
            "k=%d: cut %.0f/%d (%.1f%%; random floor %.1f%%), %.2e edges/s (amortized %.2e)",
            k, res["final_cut"], total_edges, 100 * res["cut_fraction"],
            100 * res["random_fraction"], res["edges_per_s"],
            res["edges_per_s_amortized"] or 0.0,
        )
        results.append(res)
    return results
