"""P2: precision and shape of the block-ELL window gather.

Port of ``experiments/gather_probe2.py``.  Two plain PyTorch expander
variants (tree and serial adds), then ``ops/probe_kernels.window_gather``
at the JAX probe's (W, B, mode) configurations and at d = 16.  Modes
"split", "high" and "highest" were three ways of getting float32 sums out
of the TPU's bf16 MXU and are all float32 x here; "default" sums x stored
in bfloat16.  The JAX list ran (255, 256) split at two one-hot panel
widths P; P was mechanism, so that configuration runs once.

    python -m gcn_maxcut_tpu_torch.experiments.gather_probe2 [--device cpu --n 4096]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from gcn_maxcut_tpu_torch.bench.microbench import time_stats
from gcn_maxcut_tpu_torch.device import resolve_device
from gcn_maxcut_tpu_torch.experiments import device_name, probe_cli, roofline_edges_per_s
from gcn_maxcut_tpu_torch.experiments.gather_probe import run_window
from gcn_maxcut_tpu_torch.ops.banded import padded_bandwidth

N, D, F = 100_000, 8, 128
MODES = ("split", "default", "high", "highest")
# (W, B, mode, d)
CONFIGS = ((255, 256, "split", D), (255, 256, "default", D), (255, 256, "high", D),
           (127, 256, "split", D), (127, 512, "split", D), (255, 512, "split", D),
           (511, 512, "split", D), (255, 256, "split", 16))


def block_table(W: int, B: int, d: int = D, n: int = N, seed: int = 1):
    """P2's graph: n_use = ⌊n/B⌋·B rows, each with d senders within ±W
    clipped to the array.  Returns (nbr, lidx, n_use, Wp) as
    ``gather_probe.block_table`` does."""
    rng = np.random.default_rng(seed)
    Wp = padded_bandwidth((W,))
    n_use = (n // B) * B
    i = np.arange(n_use)[:, None]
    nbr = np.clip(i + rng.integers(-W, W + 1, size=(n_use, d)), 0, n_use - 1)
    blk_start = (np.arange(n_use)[:, None] // B) * B
    lidx = (nbr - (blk_start - Wp)).astype(np.int32)
    if lidx.min() < 0 or lidx.max() >= B + 2 * Wp:
        raise RuntimeError(f"local indices {lidx.min()}..{lidx.max()} leave the window")
    return nbr, lidx, n_use, Wp


def proto(W: int, B: int, mode: str, d: int = D, n: int = N, device=None, iters: int = 10) -> dict:
    """The window gather at one (W, B, mode, d)."""
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    dev = resolve_device(device)
    nbr, lidx, n_use, Wp = block_table(W, B, d, n)
    row = run_window(f"block-ELL W={W:4d} B={B:4d} d={d:2d} mode={mode:8s}", nbr, lidx, n_use,
                     B, Wp, mode == "default", dev, iters)
    return {"W": W, "mode": mode, **row}


def expander_variants(n: int, dev: torch.device, iters: int) -> dict:
    rng = np.random.default_rng(0)
    nbr = torch.from_numpy(rng.integers(0, n, size=(n, D))).to(dev)
    x = torch.randn((n, F), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    scale = 1.0 / D
    e = n * D
    roof = roofline_edges_per_s(F, n, e)
    res = {}

    def tree_add():  # pairwise tree instead of serial chain, no weights
        gs = [x[nbr[:, j]] for j in range(D)]
        while len(gs) > 1:
            gs = [gs[i] + gs[i + 1] for i in range(0, len(gs), 2)]
        return gs[0] * scale

    def serial_unit():  # serial chain, no weight multiply
        out = x[nbr[:, 0]]
        for j in range(1, D):
            out = out + x[nbr[:, j]]
        return out * scale

    for name, fn in (("expander tree-add unit", tree_add), ("expander serial-add unit", serial_unit)):
        t = time_stats(fn, dev, iters)["best_s"]
        print(f"{name:27s} {e / t:.3e} e/s ({100 * e / t / roof:5.1f}% of roofline)", flush=True)
        res[name] = e / t
    return res


def main(n: int = N, iters: int = 10, device=None) -> dict:
    """P2: expander add orders, then the window gather's configurations."""
    dev = resolve_device(device)
    print(f"gather_probe2 on {device_name(dev)}: n={n} F={F}", flush=True)
    res = {"device": device_name(dev), "n": n, "expander": expander_variants(n, dev, iters)}
    res["block_ell"] = [proto(W, B, mode, d, n, dev, iters) for W, B, mode, d in CONFIGS]
    return res


if __name__ == "__main__":
    sys.exit(probe_cli(main, N))
