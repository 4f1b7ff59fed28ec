"""P5: five ways of delivering the weights of the weighted banded SpMM.

Port of ``experiments/weighted_probe.py``.  The TPU variants differed in
how the [n, D] weights reached the vector unit; on Hopper each variant's
function is K4's on weights w' rounded as the TPU variant rounded them:

  blockw, fullw, hoist, mxuall3   w' = w (mxuall3's three bf16 parts sum
                                  back to w exactly)
  mxu1, mxuallbf16                w' = bf16(w)
  mxu2, mxuall                    w' = bf16(w) + bf16(w − bf16(w))
  hybrid<s>                       the mxu2 rounding on the first s offsets
                                  of the order (1, 3, …, 0, 2, …) by parity,
                                  w elsewhere
  cols                            w' = w, as D column arrays: the
                                  column-major [D, n] layout

``cols`` runs ``ops/probe_kernels.banded_spmm_cols``; every other variant
runs K4 (``ops/banded.banded_spmm``) on w', rounded by plain PyTorch before
the launch (the MXU broadcast was the mechanism, the rounding the
function).  The unit kernel (K2) gives the run's anchor.  Times are of the
kernel on weights already in the variant's layout; the TPU's block size
was mechanism and is gone.

    python -m gcn_maxcut_tpu_torch.experiments.weighted_probe [--device cpu --n 4096]
"""

from __future__ import annotations

import sys
from typing import Sequence

import numpy as np
import torch

from gcn_maxcut_tpu_torch.bench.microbench import time_stats
from gcn_maxcut_tpu_torch.bench.roofline import chip_specs
from gcn_maxcut_tpu_torch.device import resolve_device
from gcn_maxcut_tpu_torch.experiments import device_name, probe_cli, rel_err
from gcn_maxcut_tpu_torch.ops.banded import banded_spmm, banded_spmm_plain, banded_spmm_unit
from gcn_maxcut_tpu_torch.ops.probe_kernels import banded_spmm_cols

N, D, F, W = 131_072, 8, 128, 63
VARIANTS = ("blockw", "fullw", "hoist", "cols", "mxu1", "mxu2", "mxuall", "mxuall3",
            "mxuallbf16", "hybrid4")


def probe_offsets(d: int = D, bandwidth: int = W) -> tuple[int, ...]:
    """The probe's offsets (s1, −s1, …), drawn as the JAX probe draws them."""
    rng = np.random.default_rng(0)
    half = rng.choice(np.arange(1, bandwidth + 1), size=d // 2, replace=False)
    return tuple(int(o) for pair in ((s, -s) for s in half) for o in pair)


def _hi_lo(w: torch.Tensor) -> torch.Tensor:
    hi = w.to(torch.bfloat16)
    lo = (w - hi.float()).to(torch.bfloat16)
    return hi.float() + lo.float()


def variant_weights(w: torch.Tensor, variant: str) -> torch.Tensor:
    """The weights [n, D] a variant's kernel multiplied by (``cols``: the
    [D, n] column-major array)."""
    if variant in ("blockw", "fullw", "hoist", "mxuall3"):
        return w
    if variant == "cols":
        return w.t().contiguous()
    if variant in ("mxu1", "mxuallbf16"):
        return w.to(torch.bfloat16).float()
    if variant in ("mxu2", "mxuall"):
        return _hi_lo(w)
    if variant.startswith("hybrid"):
        s = int(variant[6:])
        d = w.shape[1]
        order = sorted(range(d), key=lambda k: (k % 2, k))
        split = torch.zeros(d, dtype=torch.bool, device=w.device)
        split[order[:s]] = True
        return torch.where(split, _hi_lo(w), w)
    raise ValueError(f"unknown variant {variant!r}")


def apply_variant(x: torch.Tensor, wv: torch.Tensor, offsets: Sequence[int],
                  variant: str) -> torch.Tensor:
    """The variant's kernel on weights from ``variant_weights``."""
    if variant == "cols":
        return banded_spmm_cols(x, wv, offsets)
    return banded_spmm(x, wv, offsets)


def weighted_variant(x: torch.Tensor, w: torch.Tensor, offsets: Sequence[int],
                     variant: str) -> torch.Tensor:
    """y[i] = Σ_k w'[i, k]·x[(i + o_k) mod n] for one variant."""
    return apply_variant(x, variant_weights(w, variant), offsets, variant)


def main(n: int = N, iters: int = 10, device=None) -> dict:
    """P5: the unit kernel, then every weight-delivery variant."""
    dev = resolve_device(device)
    offsets = probe_offsets()
    gen = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((n, F), generator=gen, device=dev)
    w = torch.rand((n, D), generator=gen, device=dev) + 0.5
    e = n * D
    hbm = chip_specs("h100").hbm_gbps * 1e9
    sol_unit = hbm / (2 * 4.0 * F / D)             # read x + write y
    sol_w = hbm / ((2 * 4.0 * F + 4.0 * D) / D)    # + read w
    print(f"weighted_probe on {device_name(dev)}: n={n} D={D} F={F} offsets {offsets}",
          flush=True)
    ref = banded_spmm_plain(x, w, offsets)

    t = time_stats(lambda: banded_spmm_unit(x, offsets), dev, iters)["best_s"]
    print(f"unit        : {e / t:.3e} edges/s  ({100 * (e / t) / sol_unit:.1f}% of roofline)",
          flush=True)
    res = {"device": device_name(dev), "n": n, "offsets": offsets,
           "unit": {"best_s": t, "edges_per_s": e / t, "fraction_of_roofline": e / t / sol_unit},
           "variants": {}}
    with torch.no_grad():
        for variant in VARIANTS:
            wv = variant_weights(w, variant)
            err = rel_err(apply_variant(x, wv, offsets, variant), ref)
            st = time_stats(lambda: apply_variant(x, wv, offsets, variant), dev, iters)
            eps = e / st["best_s"]
            res["variants"][variant] = {"stats": st, "edges_per_s": eps,
                                        "fraction_of_roofline": eps / sol_w, "rel_err": err}
            print(f"{variant:12s}: {eps:.3e} edges/s  ({100 * eps / sol_w:.1f}% of roofline-w)  "
                  f"rel_err={err:.2e}", flush=True)
    return res


if __name__ == "__main__":
    sys.exit(probe_cli(main, N))
