"""P1: how fast can a general-graph SpMM go on this card?

Port of ``experiments/gather_probe.py``.  Measures (a) plain PyTorch
gather formulations on the expander case, and (b) the block-ELL windowed
gather (``ops/probe_kernels.window_gather``) on a banded graph clipped at
both ends, at five (W, B): precision "highest" sums float32 x, "default"
sums x stored in bfloat16 (the TPU's default MXU precision truncated x to
bf16).  The TPU's one-hot panel width P was mechanism and is gone.

    python -m gcn_maxcut_tpu_torch.experiments.gather_probe [--device cpu --n 4096]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from gcn_maxcut_tpu_torch.bench.microbench import time_stats
from gcn_maxcut_tpu_torch.device import resolve_device
from gcn_maxcut_tpu_torch.experiments import (
    device_name,
    probe_cli,
    rel_err,
    roofline_edges_per_s,
)
from gcn_maxcut_tpu_torch.ops.banded import padded_bandwidth
from gcn_maxcut_tpu_torch.ops.probe_kernels import window_gather

N, D, F = 100_000, 8, 128
CONFIGS = ((127, 512), (255, 512), (255, 256), (511, 512), (1023, 1024))
PRECISIONS = ("default", "highest")


def block_table(W: int, B: int, n: int = N, d: int = D, seed: int = 1):
    """P1's graph: each row draws d senders within ±W, clipped to the
    array (no wrap), cut to n_use = ⌊n/B⌋·B rows.  Returns (nbr, lidx,
    n_use, Wp): absolute senders [n_use, d] and their indices local to the
    receiver's block window, in [0, B + 2·Wp)."""
    rng = np.random.default_rng(seed)
    Wp = padded_bandwidth((W,))
    i = np.arange(n)[:, None]
    nbr = np.clip(i + rng.integers(-W, W + 1, size=(n, d)), 0, n - 1)
    n_use = (n // B) * B
    nbr = np.clip(nbr[:n_use].astype(np.int64), 0, n_use - 1)
    blk_start = (np.arange(n_use)[:, None] // B) * B
    lidx = (nbr - (blk_start - Wp)).astype(np.int32)
    if lidx.min() < 0 or lidx.max() >= B + 2 * Wp:
        raise RuntimeError(f"local indices {lidx.min()}..{lidx.max()} leave the window")
    return nbr, lidx, n_use, Wp


def pad_rows(x: torch.Tensor, wp: int) -> torch.Tensor:
    """x with wp zero rows before and after."""
    z = torch.zeros((wp, x.shape[1]), dtype=x.dtype, device=x.device)
    return torch.cat([z, x, z])


def gather_sum(x: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """Σ_j x[nbr[:, j]], the probes' reference."""
    out = x[nbr[:, 0]]
    for j in range(1, nbr.shape[1]):
        out = out + x[nbr[:, j]]
    return out


def run_window(label: str, nbr: np.ndarray, lidx: np.ndarray, n_use: int, B: int,
               Wp: int, bf16: bool, dev: torch.device, iters: int) -> dict:
    """One window_gather case: correctness against the gather sum, then
    time and rate; prints the probe's line."""
    d = lidx.shape[1]
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((n_use, F), generator=gen, device=dev)
    xpad = pad_rows(x, Wp)
    if bf16:
        xpad = xpad.to(torch.bfloat16)
    lidx_t = torch.from_numpy(lidx).to(dev)
    w = torch.ones((n_use, d), device=dev)
    y = window_gather(xpad, lidx_t, w, B, Wp)
    err = rel_err(y, gather_sum(x, torch.from_numpy(nbr).to(dev)))
    st = time_stats(lambda: window_gather(xpad, lidx_t, w, B, Wp), dev, iters)
    e_use = n_use * d
    eps = e_use / st["best_s"]
    frac = eps / roofline_edges_per_s(F, n_use, e_use)
    print(f"{label} {eps:.3e} edges/s ({100 * frac:5.1f}% of roofline) relerr={err:.2e} "
          f"t={st['best_s'] * 1e3:.4f} ms", flush=True)
    return {"n_use": n_use, "d": d, "B": B, "Wp": Wp, "x_dtype": "bfloat16" if bf16 else "float32",
            "relerr": err, "stats": st, "edges_per_s": eps, "fraction_of_roofline": frac}


def proto_block_ell(W: int, B: int, prec: str, n: int = N, device=None, iters: int = 10) -> dict:
    """The windowed block-ELL gather at one (W, B) and precision."""
    dev = resolve_device(device)
    nbr, lidx, n_use, Wp = block_table(W, B, n)
    row = run_window(f"block-ELL W={W:5d} B={B:5d} prec={prec:8s}", nbr, lidx, n_use, B, Wp,
                     prec == "default", dev, iters)
    return {"W": W, "prec": prec, **row}


def expander(n: int, dev: torch.device, iters: int) -> dict:
    """Plain PyTorch gather formulations on an arbitrary ELL table."""
    rng = np.random.default_rng(0)
    nbr = torch.from_numpy(rng.integers(0, n, size=(n, D))).to(dev)
    w = torch.ones((n, D), device=dev)
    x = torch.randn((n, F), generator=torch.Generator(device=dev).manual_seed(1), device=dev)
    scale = 1.0 / D
    e = n * D
    roof = roofline_edges_per_s(F, n, e)
    res = {}

    def report(name, fn):
        t = time_stats(fn, dev, iters)["best_s"]
        print(f"{name:44s} {e / t:.3e} edges/s  ({100 * e / t / roof:5.1f}% of roofline)  "
              f"t={t * 1e3:.4f} ms", flush=True)
        res[name] = e / t

    def ell_loop():
        out = w[:, 0:1] * x[nbr[:, 0]]
        for j in range(1, D):
            out = out + w[:, j : j + 1] * x[nbr[:, j]]
        return out * scale
    report("d-gathers (current ELL)", ell_loop)

    flat = nbr.reshape(-1)
    report("flat gather + reshape-sum", lambda: x[flat].reshape(n, D, F).sum(dim=1) * scale)

    def ell_bf16():
        xb = x.to(torch.bfloat16)
        out = xb[nbr[:, 0]].float()
        for j in range(1, D):
            out = out + xb[nbr[:, j]].float()
        return out * scale
    report("bf16 d-gathers", ell_bf16)

    nbr_sorted = torch.sort(nbr, dim=0).values
    report("d-gathers, column-sorted idx", lambda: gather_sum(x, nbr_sorted) * scale)

    t1 = time_stats(lambda: x[nbr[:, 0]] * scale, dev, iters)["best_s"]
    print(f"single [N] gather: {n / t1:.3e} rows/s ({n * F * 4 / t1 / 1e9:.0f} GB/s gathered)",
          flush=True)
    res["single_gather_rows_per_s"] = n / t1
    return res


def main(n: int = N, iters: int = 10, device=None) -> dict:
    """P1: expander gathers, then the block-window gather at five (W, B)
    in both precisions."""
    dev = resolve_device(device)
    print(f"gather_probe on {device_name(dev)}: n={n} d={D} F={F}", flush=True)
    res = {"device": device_name(dev), "n": n, "expander": expander(n, dev, iters)}
    res["block_ell"] = [proto_block_ell(W, B, prec, n, dev, iters)
                        for W, B in CONFIGS for prec in PRECISIONS]
    return res


if __name__ == "__main__":
    sys.exit(probe_cli(main, N))
