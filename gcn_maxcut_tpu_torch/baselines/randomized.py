"""Randomized k-way max-cut baseline.

Port of ``gcn_maxcut_tpu/baselines/randomized.py::randomized_k_way_maxcut``:
a chunk of uniform assignments (terminals pinned) is sampled and scored in
one batched pass, and the reference's sequential threshold/patience early
stop is replayed over the returned cuts on the host.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from gcn_maxcut_tpu_torch.core.graph import Graph
from gcn_maxcut_tpu_torch.objectives.cut_loss import hard_cut_value


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
