"""SpMM microbenchmarks: edges/s of the sparse aggregation paths, with
roofline fractions.

Port of ``bench_spmm``, ``bench_spmm_banded``, ``bench_train_epoch`` and
``bench_post_processing`` of ``gcn_maxcut_tpu/bench/microbench.py``; the
results carry the JAX package's keys, plus ``device``.  Times are CUDA
events around each call on the card (best of ``iters`` after warm-up;
``{best_s, mean_s, spread_s, spread_frac, n, n_valid}``), the host clock on
the CPU, where the numbers are no device metric; ``bench_train_epoch``
differences chunks of captured epochs on a synchronised host clock, as the
JAX package times its epoch.  The roofline is ``bench/roofline.py``'s
least-bytes bound on an H100.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

import numpy as np
import torch

from gcn_maxcut_tpu_torch.bench.roofline import RooflineModel, chip_specs
from gcn_maxcut_tpu_torch.core.graph import Graph, graph_from_edges, round_up
from gcn_maxcut_tpu_torch.data.generate import regular_graph_on_device
from gcn_maxcut_tpu_torch.device import resolve_device
from gcn_maxcut_tpu_torch.ops.banded import banded_spmm, banded_spmm_unit
from gcn_maxcut_tpu_torch.ops.segment import spmm


def time_stats(fn: Callable[[], object], dev: torch.device, iters: int,
               warmup: int = 2) -> Dict[str, float]:
    """Per-call seconds of ``fn``: CUDA events around each call on the
    card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if dev.type == "cuda":
        pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                 for _ in range(iters)]
        for start, end in pairs:
            start.record()
            fn()
            end.record()
        torch.cuda.synchronize(dev)
        samples = [s.elapsed_time(e) / 1e3 for s, e in pairs]
    else:
        samples = []
        for _ in range(iters):
            t0 = time.perf_counter()
            fn()
            samples.append(time.perf_counter() - t0)
    best = min(samples)
    return {
        "best_s": best,
        "mean_s": sum(samples) / len(samples),
        "spread_s": max(samples) - best,
        "spread_frac": (max(samples) - best) / best,
        "n": len(samples),
        "n_valid": len(samples),
    }


def _grad_fn(op: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor, scale: float):
    """dL/dx of L = Σ op(x)², times ``scale`` (the JAX bench's fwd+bwd)."""
    xr = x.detach().requires_grad_(True)

    def run():
        (g,) = torch.autograd.grad(torch.sum(op(xr) ** 2), xr)
        return g * scale

    return run


def _device_graph(n: int, d: int, device: torch.device, seed: int = 0) -> Graph:
    """Exactly d-regular circulant graph assembled on ``device``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    senders, receivers = regular_graph_on_device(n, d, gen, device)
    order = torch.argsort(receivers, stable=True)
    senders, receivers = senders[order], receivers[order]
    e = senders.shape[0]
    ones = torch.ones(e, dtype=torch.float32, device=device)
    return Graph(
        senders=senders,
        receivers=receivers,
        weights=ones,
        edge_mask=ones.clone(),
        row_ptr=torch.arange(0, (n + 1) * d, d, dtype=torch.int32, device=device),
        degrees=torch.full((n,), float(d), device=device),
        node_mask=torch.ones(n, device=device),
        n_nodes=torch.tensor(n, dtype=torch.int32, device=device),
        n_edges=torch.tensor(e, dtype=torch.int32, device=device),
        # receivers sorted with uniform degree d: row i owns slots [i·d, (i+1)·d)
        ell_senders=senders.reshape(n, d),
        ell_weights=torch.ones((n, d), device=device),
        ell_mask=torch.ones((n, d), device=device),
        symmetric=True,
    )


def banded_random_edges(n: int, d: int, w: int, seed: int = 0) -> np.ndarray:
    """Undirected edges [n·d/2, 2] of an exact d-regular random graph whose
    neighbour offsets lie within ±w: d/2 distinct circulant shifts relabeled
    by a random permutation inside blocks of max(8, w/4) ids, so the rows
    hold arbitrary gather indices and nothing circulant survives."""
    rng = np.random.default_rng(seed)
    half = rng.choice(np.arange(1, max(2, w // 2)), size=d // 2, replace=False)
    perm = np.arange(n)
    r = max(8, w // 4)
    for s in range(0, n, r):
        rng.shuffle(perm[s:s + r])
    u = np.tile(perm, d // 2)
    v = np.concatenate([perm[(np.arange(n) + o) % n] for o in half])
    return np.stack([u, v], axis=1)


def _banded_regular_graph(
    n: int, d: int, w: int, n_pad: int | None = None, seed: int = 0
) -> Graph:
    """``banded_random_edges`` as a planned `Graph` (the post-RCM shape of
    any bandable graph)."""
    return graph_from_edges(banded_random_edges(n, d, w, seed), n, n_pad=n_pad, block_ell=True)


def bench_spmm(
    n: int = 100_000,
    d: int = 8,
    feature_dim: int = 128,
    chip: str = "h100",
    iters: int = 10,
    locality: int = 255,
    device: str | torch.device | None = None,
) -> Dict[str, float]:
    """General-graph SpMM fwd and fwd+bwd edges/s with roofline fractions,
    on two instances:

      * the banded-random graph (offsets within ±``locality``) on the
        block-ELL kernel (K1), the headline;
      * the circulant expander, which no ordering bands, on the ELL gather
        path (PyTorch gathers), in float32 and with bfloat16 rows.
    """
    dev = resolve_device(device)
    e = n * d
    model = RooflineModel(chip_specs(chip), feature_dim, n, e)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((n, feature_dim), generator=gen, device=dev)
    scale = 1.0 / d
    res = {
        "n": n,
        "d": d,
        "feature_dim": feature_dim,
        "edges_directed": e,
        "roofline_fwd_edges_per_s": model.edges_per_s(fwd_bwd=False),
        "roofline_fwdbwd_edges_per_s": model.edges_per_s(fwd_bwd=True),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }

    n_pad = round_up(n, 2048)
    gb = _banded_regular_graph(n, d, locality, n_pad=n_pad).to(dev)
    if gb.bell_block is None:
        raise RuntimeError("the banded instance did not plan")
    xb = torch.cat([x, torch.zeros((n_pad - n, feature_dim), device=dev)])
    st_fwd = time_stats(lambda: spmm(gb, xb) * scale, dev, iters)
    st_fwdbwd = time_stats(_grad_fn(lambda z: spmm(gb, z), xb, scale * scale * 0.5), dev, iters)
    t_fwd, t_fwdbwd = st_fwd["best_s"], st_fwdbwd["best_s"]
    res.update(
        fwd_time_s=t_fwd,
        fwd_edges_per_s=e / t_fwd,
        fwd_stats=st_fwd,
        fwdbwd_time_s=t_fwdbwd,
        fwdbwd_edges_per_s=e / t_fwdbwd,
        fwdbwd_stats=st_fwdbwd,
        fraction_of_roofline_fwd=model.fraction_of_roofline(e / t_fwd, fwd_bwd=False),
        fraction_of_roofline_fwdbwd=model.fraction_of_roofline(e / t_fwdbwd, fwd_bwd=True),
        bell_block=gb.bell_block,
        bell_wp=gb.bell_wp,
    )
    del gb, xb

    ge = _device_graph(n, d, dev)
    st_fwd_e = time_stats(lambda: spmm(ge, x) * scale, dev, iters)
    st_fb_e = time_stats(_grad_fn(lambda z: spmm(ge, z), x, scale * scale * 0.5), dev, iters)
    x16 = x.to(torch.bfloat16)
    st_fwd_e16 = time_stats(lambda: (spmm(ge, x16) * scale).to(torch.bfloat16), dev, iters)
    t_fwd_e, t_fb_e = st_fwd_e["best_s"], st_fb_e["best_s"]
    res.update(
        expander_fwd_edges_per_s=e / t_fwd_e,
        expander_fwdbwd_edges_per_s=e / t_fb_e,
        expander_fwd_stats=st_fwd_e,
        expander_fwdbwd_stats=st_fb_e,
        expander_bf16_fwd_edges_per_s=e / st_fwd_e16["best_s"],
        expander_bf16_fwd_stats=st_fwd_e16,
        expander_fraction_of_roofline_fwd=model.fraction_of_roofline(e / t_fwd_e, fwd_bwd=False),
        expander_fraction_of_roofline_fwdbwd=model.fraction_of_roofline(e / t_fb_e, fwd_bwd=True),
    )
    return res


def banded_offsets(d: int, bandwidth: int) -> tuple[int, ...]:
    """The bench's d offsets ``(s1, -s1, ...)``, drawn as the JAX bench
    draws them."""
    if d % 2:
        raise ValueError("banded bench requires even d")
    rng = np.random.default_rng(0)
    half = rng.choice(np.arange(1, bandwidth + 1), size=d // 2, replace=False)
    return tuple(int(o) for pair in ((s, -s) for s in half) for o in pair)


def bench_spmm_banded(
    n: int = 131_072,
    d: int = 8,
    feature_dim: int = 128,
    bandwidth: int = 63,
    chip: str = "h100",
    iters: int = 30,
    n_big: int = 1_250_304,
    device: str | torch.device | None = None,
) -> Dict[str, float]:
    """Banded SpMM edges/s: the unit kernel (K2) forward and forward+
    backward and the weighted kernel (K4) forward at n, then both forwards
    again at ``n_big`` rows, whose 1.3 GB of traffic no cache holds."""
    dev = resolve_device(device)
    e = n * d
    model = RooflineModel(chip_specs(chip), feature_dim, n, e)
    offsets = banded_offsets(d, bandwidth)
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((n, feature_dim), generator=gen, device=dev)
    w = torch.ones((n, d), device=dev)
    scale = 1.0 / d

    st_fwd = time_stats(lambda: banded_spmm_unit(x, offsets) * scale, dev, iters)
    st_fwdbwd = time_stats(
        _grad_fn(lambda z: banded_spmm_unit(z, offsets), x, scale * scale * 0.5), dev, iters)
    st_fwd_w = time_stats(lambda: banded_spmm(x, w, offsets) * scale, dev, iters)
    t_fwd, t_fwdbwd, t_fwd_w = st_fwd["best_s"], st_fwdbwd["best_s"], st_fwd_w["best_s"]
    res = {
        "n": n,
        "d": d,
        "feature_dim": feature_dim,
        "bandwidth": bandwidth,
        "fwd_time_s": t_fwd,
        "fwd_edges_per_s": e / t_fwd,
        "fwd_stats": st_fwd,
        "fwdbwd_time_s": t_fwdbwd,
        "fwdbwd_edges_per_s": e / t_fwdbwd,
        "fwdbwd_stats": st_fwdbwd,
        "weighted_fwd_time_s": t_fwd_w,
        "weighted_fwd_edges_per_s": e / t_fwd_w,
        "weighted_fwd_stats": st_fwd_w,
        # read x and write y once: 2·4·F bytes a row, d edges a row
        "banded_roofline_edges_per_s": model.chip.hbm_gbps * 1e9 / (2 * 4.0 * feature_dim / d),
        # the weighted kernel also reads its [n, d] weight table
        "weighted_roofline_edges_per_s": model.chip.hbm_gbps * 1e9
        / ((2 * 4.0 * feature_dim + 4.0 * d) / d),
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
    res["fraction_of_banded_roofline"] = (
        res["fwd_edges_per_s"] / res["banded_roofline_edges_per_s"])
    res["weighted_fraction_of_banded_roofline"] = (
        res["weighted_fwd_edges_per_s"] / res["weighted_roofline_edges_per_s"])
    del x, w

    xb = torch.randn((n_big, feature_dim), generator=gen, device=dev)
    st_big = time_stats(lambda: banded_spmm_unit(xb, offsets) * scale, dev, max(3, iters // 3))
    wb = torch.rand((n_big, d), generator=gen, device=dev) + 0.5
    st_big_w = time_stats(lambda: banded_spmm(xb, wb, offsets) * scale, dev, max(3, iters // 3))
    e_big = n_big * d
    res.update(
        hbm_regime_n=n_big,
        hbm_regime_fwd_edges_per_s=e_big / st_big["best_s"],
        hbm_regime_fwd_stats=st_big,
        hbm_regime_gbps=2 * n_big * feature_dim * 4 / st_big["best_s"] / 1e9,
        hbm_regime_weighted_fwd_edges_per_s=e_big / st_big_w["best_s"],
        hbm_regime_weighted_fwd_stats=st_big_w,
    )
    return res


def _recipe_setup(num_graphs: int, n: int, d_range, max_nodes: int, seed: int, dev):
    """The reference recipe's training set-up (``num_graphs`` d-regular
    graphs, 1000-wide features, the default ``TrainingConfig``): the
    stacked batch on the host, the config and a train state on ``dev``."""
    from gcn_maxcut_tpu_torch.core.graph import pad_graph_batch
    from gcn_maxcut_tpu_torch.data.generate import generate_graph
    from gcn_maxcut_tpu_torch.data.process import DataConfig, process_graphs
    from gcn_maxcut_tpu_torch.train.config import TrainingConfig
    from gcn_maxcut_tpu_torch.train.loop import setup_train_state

    rng = np.random.default_rng(seed)
    specs = []
    while len(specs) < num_graphs:
        deg = int(rng.integers(d_range[0], d_range[1] + 1))
        if (n * deg) % 2:
            continue
        specs.append(generate_graph(n=n, d=deg, graph_type="reg", seed=seed + len(specs)))
    ds = process_graphs(specs, DataConfig(max_nodes=max_nodes))
    batch = pad_graph_batch([ds.graphs[k] for k in sorted(ds.graphs)])
    cfg = TrainingConfig(n_nodes=max_nodes)
    return batch, cfg, setup_train_state(cfg, device=dev)


def recipe_trainer(
    num_graphs: int = 20,
    n: int = 500,
    d_range=(6, 8),
    max_nodes: int = 1000,
    seed: int = 1000,
    device: str | torch.device | None = None,
):
    """The reference recipe's training set-up on the device.  Returns
    ``(state, run_epoch)``: the train state and a function that runs one
    eager epoch as ``train_model`` does and returns its loss."""
    from gcn_maxcut_tpu_torch.train.loop import make_epoch_fn

    dev = resolve_device(device)
    batch, cfg, state = _recipe_setup(num_graphs, n, d_range, max_nodes, seed, dev)
    epoch_fn = make_epoch_fn(cfg, state)
    inputs = epoch_fn.epoch_inputs(batch)
    gen = torch.Generator(device=dev).manual_seed(0)
    return state, lambda: epoch_fn.run_epoch(inputs, gen)


def bench_train_epoch(
    num_graphs: int = 20,
    n: int = 500,
    d_range=(6, 8),
    max_nodes: int = 1000,
    epochs_timed: int = 10,
    seed: int = 1000,
    device: str | torch.device | None = None,
) -> Dict[str, float]:
    """The reference recipe's epoch (20 graphs n = 500, d ∈ [6, 8],
    1000-wide features, per-graph Adam steps) inside one device call, as
    the JAX package times it.

    The epochs run through ``train/loop.make_epoch_fn``: on the card an
    epoch captured once and replayed, one host read a chunk.  Chunks of
    k_hi = max(20, 2·``epochs_timed``) and k_lo = 5 epochs, each the best of
    3 on a host clock between synchronisations that includes the chunk's
    host read, are differenced: (best k_hi − best k_lo) / (k_hi − k_lo)
    cancels the per-chunk cost.  Three such estimates; the epoch time is
    the least, ``epoch_time_stats`` their mean and spread (``n_valid``
    counts the positive differences).  ``compile_time_s``: the first chunk
    of k_lo epochs, which builds the epoch's inputs and captures the epoch.
    ``final_epoch_loss``: as in the JAX package, the loss of the last of
    k_hi epochs from the initial parameters (the state is set back to them,
    and the generator to its seed, after the timing).
    ``speedup_vs_reference`` divides the reference's CPU epoch, 171.81 s /
    486 epochs (BASELINE.md §4).  On the CPU the same epochs run eagerly
    and the numbers are no device metric.
    """
    from gcn_maxcut_tpu_torch.train.loop import make_epoch_fn

    dev = resolve_device(device)
    batch, cfg, state = _recipe_setup(num_graphs, n, d_range, max_nodes, seed, dev)
    k_hi, k_lo = max(20, 2 * epochs_timed), 5
    epoch_fn = make_epoch_fn(cfg, state, max_chunk=k_hi)
    gen = torch.Generator(device=dev).manual_seed(0)
    start = state.params(), state.opt_state()

    def sync() -> None:
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def run(k: int) -> float:
        sync()
        t0 = time.perf_counter()
        epoch_fn(batch, gen, k)
        sync()
        return time.perf_counter() - t0

    compile_time = run(k_lo)
    estimates = []
    for _ in range(3):
        best = {k: min(run(k) for _ in range(3)) for k in (k_hi, k_lo)}
        d_t = best[k_hi] - best[k_lo]
        if d_t > 0:
            estimates.append(d_t / (k_hi - k_lo))
    epoch_time = min(estimates) if estimates else float("nan")
    state.load(*start)
    gen.manual_seed(0)
    losses = epoch_fn(batch, gen, k_hi)
    ref_epoch_time = 171.81 / 486.0
    return {
        "num_graphs": num_graphs,
        "n": n,
        "epoch_time_s": epoch_time,
        "epoch_time_stats": {
            "best_s": epoch_time,
            "mean_s": sum(estimates) / len(estimates) if estimates else float("nan"),
            "spread_s": max(estimates) - min(estimates) if estimates else float("nan"),
            "n": 3,
            "n_valid": len(estimates),
        },
        "compile_time_s": compile_time,
        "final_epoch_loss": float(losses[-1]),
        "reference_epoch_time_s": ref_epoch_time,
        "speedup_vs_reference": ref_epoch_time / epoch_time,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }


def bench_post_processing(
    n: int = 500, d: int = 8, iterations: int = 200, iters: int = 10,
    device: str | torch.device | None = None,
) -> Dict[str, float]:
    """Post-processing (``iterations`` sampled rollouts, scored, best
    kept) on one n-node d-regular graph with random probabilities: the
    best of ``iters`` timed calls after warm-up."""
    from gcn_maxcut_tpu_torch.data.generate import generate_graph
    from gcn_maxcut_tpu_torch.data.process import DataConfig, process_graphs
    from gcn_maxcut_tpu_torch.eval.decode import post_process

    dev = resolve_device(device)
    spec = generate_graph(n=n, d=d, graph_type="reg", seed=0)
    g = process_graphs([spec], DataConfig(max_nodes=n)).graphs[0].to(dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    probs = torch.softmax(torch.randn((g.n_pad, 3), generator=gen, device=dev), dim=-1)
    stats = time_stats(lambda: post_process(g, probs, gen, iterations), dev, iters)
    t = stats["best_s"]
    return {
        "n": n,
        "iterations": iterations,
        "time_s": t,
        "samples_per_s": iterations / t,
        "time_stats": stats,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
    }
