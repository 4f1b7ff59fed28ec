"""Ports of the JAX package's SpMM design probes (``experiments/``).

    python -m gcn_maxcut_tpu_torch.experiments.gather_probe      # P1
    python -m gcn_maxcut_tpu_torch.experiments.gather_probe2     # P2
    python -m gcn_maxcut_tpu_torch.experiments.subblock_probe    # P3
    python -m gcn_maxcut_tpu_torch.experiments.panel_ell_probe   # P4
    python -m gcn_maxcut_tpu_torch.experiments.weighted_probe    # P5

Each runs on the CUDA device unless ``--device cpu`` is given (then with
the kernels' plain versions and host-clock times, which are no device
metric), takes ``--n`` and ``--iters``, prints the JAX probe's lines and
returns its numbers as a dict.  Rates are edges/s beside the fraction of
``bench/roofline.py``'s H100 least-bytes bound; times are the best of
``iters`` CUDA-event timings of the kernel call alone (``bench/microbench.py
time_stats``).  The JAX probes' retrying child processes, compilation
cache and DMA choreography are TPU mechanism and are not ported.
"""

from __future__ import annotations

import argparse
from typing import Callable

import torch

from gcn_maxcut_tpu_torch.bench.roofline import RooflineModel, chip_specs


def roofline_edges_per_s(F: int, n: int, e: int) -> float:
    """Forward least-bytes bound of an SpMM with float32 features."""
    return RooflineModel(chip_specs("h100"), F, n, e).edges_per_s(fwd_bwd=False)


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def rel_err(y: torch.Tensor, ref: torch.Tensor, keep: torch.Tensor | None = None) -> float:
    """max |y − ref| (over the kept rows) / max |ref|."""
    diff = (y.float() - ref).abs()
    if keep is not None:
        diff = diff * keep[:, None]
    return float(diff.max() / (ref.abs().max() + 1e-9))


def probe_cli(main: Callable[..., dict], n_default: int, argv=None) -> int:
    p = argparse.ArgumentParser(description=main.__doc__)
    p.add_argument("--n", type=int, default=n_default, help="nodes")
    p.add_argument("--iters", type=int, default=10, help="timed calls per case")
    p.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = p.parse_args(argv)
    main(n=args.n, iters=args.iters, device=args.device)
    return 0
