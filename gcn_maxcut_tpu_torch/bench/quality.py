"""Cut-quality suite: the reference's headline experiment, end to end.

Port of ``gcn_maxcut_tpu/bench/quality.py``: train a GCNSoftmax on
d-regular graphs, then evaluate fresh suites at sizes {50, 100, 200, 300,
500} with the simple (argmax), post-processed (200 rollouts) and refined
(multi-start greedy flip) decoders, against the 10k-iteration randomized
baseline and the same refine from the baseline's starts.  Graphs, recipes,
defaults, result keys and gates are the JAX package's; the training draws
and the decodes' uniforms come from torch generators seeded as the JAX
package seeds its keys.

Training recipes (``recipe=``): ``"n500"`` (the reference's: 20 graphs
n = 500, d ∈ [6, 8]), ``"mixed"`` (the same budget spread over the
evaluation sizes, 4 graphs a size; the default) and ``"per_size"`` (one
model per evaluation size).

Run: ``python -m gcn_maxcut_tpu_torch bench --what quality`` or call
:func:`run_quality_suite`.
"""

from __future__ import annotations

import logging
import math
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from gcn_maxcut_tpu_torch.baselines.local_search import greedy_flip_local_search
from gcn_maxcut_tpu_torch.baselines.randomized import randomized_k_way_maxcut
from gcn_maxcut_tpu_torch.core.graph import pad_graph_batch
from gcn_maxcut_tpu_torch.data.generate import generate_graph
from gcn_maxcut_tpu_torch.data.process import DataConfig, process_graphs
from gcn_maxcut_tpu_torch.device import resolve_device
from gcn_maxcut_tpu_torch.eval.harness import STAGE_REPEATS, test_single_graph
from gcn_maxcut_tpu_torch.train.config import TrainingConfig
from gcn_maxcut_tpu_torch.train.loop import train_model

logger = logging.getLogger(__name__)

SIZES = (50, 100, 200, 300, 500)
REFERENCE_SIMPLE_MEAN = 547.1      # the reference's simple-decode mean (BASELINE.md §3)


def _suite_specs(size: int, count: int, d_range=(6, 8), seed_base: int = 1000):
    """Fresh test graphs per size (reference seeds ``size*1000+i``,
    ``neural_network_testing.ipynb`` cell 8)."""
    rng = np.random.default_rng(size * seed_base)
    specs = []
    i = 0
    while len(specs) < count:
        d = int(rng.integers(d_range[0], d_range[1] + 1))
        if (size * d) % 2:
            i += 1
            continue
        specs.append(generate_graph(n=size, d=d, graph_type="reg", seed=size * 1000 + i))
        i += 1
    return specs


def _train_specs(
    recipe: str, sizes=SIZES, d_range=(6, 8), seed: int = 1000,
    graphs_per_size: int = 4,
):
    """Training graphs by model name: ``{"all": [...]}``, or one list a
    size for ``per_size``."""
    rng = np.random.default_rng(seed)
    out: Dict[str, List] = {}
    if recipe == "n500":
        specs = []
        while len(specs) < 20:
            d = int(rng.integers(d_range[0], d_range[1] + 1))
            if (500 * d) % 2:
                continue
            specs.append(generate_graph(n=500, d=d, graph_type="reg", seed=seed + len(specs)))
        out["all"] = specs
    elif recipe in ("mixed", "per_size"):
        count = graphs_per_size if recipe == "mixed" else 10
        for s in sizes:
            specs = []
            for j in range(count):
                d = int(rng.integers(d_range[0], d_range[1] + 1))
                if (s * d) % 2:
                    d += 1
                specs.append(generate_graph(n=s, d=d, graph_type="reg", seed=seed + 37 * s + j))
            if recipe == "mixed":
                out.setdefault("all", []).extend(specs)
            else:
                out[str(s)] = specs
    else:
        raise ValueError(f"unknown recipe {recipe!r}")
    return out


def _train(specs, max_nodes: int, restarts: int = 1, device=None, **cfg_kwargs) -> Any:
    """Train; with ``restarts > 1``, that many models seeded ``seed + r``,
    keeping the one with the lowest finite best training loss (the last
    restart's if none is finite)."""
    ds = process_graphs(specs, DataConfig(max_nodes=max_nodes))
    batch = pad_graph_batch([ds.graphs[k] for k in sorted(ds.graphs)])
    base_seed = cfg_kwargs.pop("seed", 0)
    t0 = time.perf_counter()
    best_params, best_loss, last_params = None, float("inf"), None
    for r in range(max(1, restarts)):
        cfg = TrainingConfig(n_nodes=max_nodes, seed=base_seed + r, **cfg_kwargs)
        params, best, epoch, _, _ = train_model(batch, cfg, device=device)
        logger.info(
            "restart %d: trained %d graphs, best %.0f at epoch %d (%.1fs cum)",
            r, len(specs), best, epoch, time.perf_counter() - t0,
        )
        last_params = params
        # NaN < inf is False: guard on finiteness, or an all-NaN sweep
        # would return None far from the cause
        if math.isfinite(best) and best < best_loss:
            best_params, best_loss = params, best
    if best_params is None:
        logger.warning(
            "_train: no restart reached a finite best loss (%d restarts); "
            "falling back to the last restart's params", max(1, restarts),
        )
        best_params = last_params
    return best_params


def _refined_random(g, ra: np.ndarray, s: int, idx: int) -> float:
    """The attribution arm: the same multi-start greedy flip from the
    randomized baseline's best assignment and 3 uniform starts drawn from
    ``default_rng(8000 + s + idx)`` (the JAX package's starts), climbed in
    one batched call; the best cut."""
    ra_pad = np.zeros(g.n_pad, np.int64)
    ra_pad[: ra.shape[0]] = ra
    rng_np = np.random.default_rng(8000 + s + idx)
    starts = [ra_pad]
    for _ in range(3):
        u = rng_np.integers(0, 3, g.n_pad).astype(np.int64)
        u[:3] = [0, 1, 2]
        starts.append(u)
    _, cuts = greedy_flip_local_search(g, torch.as_tensor(np.stack(starts), device=g.device))
    return float(cuts.max())


def run_quality_suite(
    recipe: str = "mixed",
    sizes=SIZES,
    graphs_per_size: int = 6,
    post_iterations: int = 200,
    randomized_iterations: int = 10_000,
    refine: bool = True,
    max_nodes: int = 1000,
    train_kwargs: Optional[Dict[str, Any]] = None,
    seed: int = 1000,
    measure_times: bool = True,
    train_graphs_per_size: int = 4,
    device: str | torch.device | None = None,
) -> Dict[str, Any]:
    """Train (per ``recipe``) and evaluate the per-size suites.

    Returns per-size means of the simple, post-processed and refined
    decodes, the randomized baseline and the refined-random arm, plus the
    two quality gates: the default decode (refined, else post) ≥ randomized
    at every size, and the simple-decode mean ≥ the reference's 547.1.
    """
    dev = resolve_device(device)
    tk = {
        "learning_rate": 1e-3,
        "number_epochs": 1000,
        "tolerance": 1e-4,
        "patience": 20,
        "epochs_per_call": 10,
        **(train_kwargs or {}),
    }
    restarts = int(tk.pop("restarts", 1))
    models: Dict[str, Any] = {}
    for name, specs in _train_specs(
        recipe, sizes, seed=seed, graphs_per_size=train_graphs_per_size
    ).items():
        models[name] = _train(specs, max_nodes, restarts=restarts, device=dev, **tk)

    per_size: Dict[int, Dict[str, float]] = {}
    for s in sizes:
        specs = _suite_specs(s, graphs_per_size)
        ds = process_graphs(specs, DataConfig(max_nodes=max_nodes))
        params = models.get(str(s), models.get("all"))
        simple, post, refined, rand, post_t, refine_t = [], [], [], [], [], []
        refined_rand = []
        for idx in sorted(ds.graphs):
            g = ds.graphs[idx].to(dev)
            res = test_single_graph(
                params, g, torch.Generator(device=dev).manual_seed(9000 + s + idx),
                post_processing_iterations=post_iterations,
                refine=refine,
                measure_times=measure_times,
            )
            if not res["success"]:
                logger.info("graph %d/%d failed: %s", s, idx, res["error"])
                continue
            simple.append(res["simple_cut"])
            post.append(res["post_cut"])
            post_t.append(res["post_time"])
            if refine:
                refined.append(res["refined_cut"])
                refine_t.append(res["refined_time"])
            ra, rc, _ = randomized_k_way_maxcut(
                g, k=3, max_iterations=randomized_iterations,
                patience=randomized_iterations, seed=7000 + idx,
            )
            rand.append(rc)
            if refine:
                refined_rand.append(_refined_random(g, ra, s, idx))
        per_size[s] = {
            "simple": float(np.mean(simple)),
            "post": float(np.mean(post)),
            "refined": float(np.mean(refined)) if refined else None,
            "randomized": float(np.mean(rand)),
            "refined_random": float(np.mean(refined_rand)) if refined_rand else None,
            "post_time_s": float(np.mean(post_t)),
            "refine_time_s": float(np.mean(refine_t)) if refine_t else None,
            "graphs": len(simple),
        }
        logger.info(
            "size %d: simple %.0f | post %.0f | refined %s | randomized %.0f"
            " | refined-random %s",
            s, per_size[s]["simple"], per_size[s]["post"],
            f"{per_size[s]['refined']:.0f}" if refine else "-",
            per_size[s]["randomized"],
            f"{per_size[s]['refined_random']:.0f}" if refined_rand else "-",
        )

    simple_mean = float(np.mean([v["simple"] for v in per_size.values()]))
    post_beats = all(
        (v["refined"] if refine and v["refined"] is not None else v["post"])
        >= v["randomized"]
        for v in per_size.values()
    )
    post_beats_sizes = sum(1 for v in per_size.values() if v["post"] >= v["randomized"])
    refined_vs_refined_random = (
        all(
            v["refined"] >= v["refined_random"]
            for v in per_size.values()
            if v["refined"] is not None and v["refined_random"] is not None
        )
        if refine else None
    )
    if not measure_times:
        timing = "skipped"
    else:
        clock = (f"CUDA events on {torch.cuda.get_device_name(dev)}" if dev.type == "cuda"
                 else "host clock on the CPU (no device metric)")
        timing = f"{clock}, best of {STAGE_REPEATS} calls after one warm-up"
    result = {
        "recipe": recipe,
        "per_size": per_size,
        "simple_mean": simple_mean,
        "reference_simple_mean": REFERENCE_SIMPLE_MEAN,
        "default_decode_beats_randomized_all_sizes": bool(post_beats),
        "gcn_post_beats_randomized_sizes": post_beats_sizes,
        # attribution: the same flip budget from random starts vs the GCN's
        "refined_gcn_beats_refined_random_all_sizes": refined_vs_refined_random,
        "refine_default": refine,
        "timing_method": timing,
    }
    logger.info(
        "suite done: simple mean %.1f (ref %.1f), default decode beats "
        "randomized at all sizes: %s; GCN+post beats randomized at %d/%d "
        "sizes; refined-GCN >= refined-random at all sizes: %s",
        simple_mean, REFERENCE_SIMPLE_MEAN, post_beats, post_beats_sizes,
        len(per_size), refined_vs_refined_random,
    )
    return result
