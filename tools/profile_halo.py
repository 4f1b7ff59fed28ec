#!/usr/bin/env python3
"""Where the giant trainers' epoch time goes on the card.

    python tools/profile_halo.py [--epochs 10] [--shards 4]

Runs, on a ring of ``--shards`` shards on one card (``make_mesh(devices=
["cuda:0"] * shards)``), the packed halo trainer at its defaults (n =
10,002,432) and the plain halo trainer at ``HaloGiantConfig`` widths on
262,144-node shards, and beside them the single-chip trainers: the packed
one at the same n and the plain one at n = 1,048,576.  Each runs once untraced for ``--epochs`` epochs (its steady epoch
time, CUDA events) and once traced with ``torch.profiler`` (CPU and CUDA
activities) for as many epochs.  Prints one JSON object: for each trainer
the epoch time, the device time per epoch summed over the device's own
events (kernels and copies on one stream; the parameter draw and the first
epoch are included, divided over the epochs), the device busy share (device
time / untraced epoch time), and the top device events by time with their
launches per epoch.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from gcn_maxcut_tpu_torch.bench.giant_demo import (  # noqa: E402
    train_banded_giant,
    train_banded_giant_packed,
)
from gcn_maxcut_tpu_torch.device import resolve_device  # noqa: E402
from gcn_maxcut_tpu_torch.parallel.giant_banded import (  # noqa: E402
    HaloGiantConfig,
    PackedHaloGiantConfig,
    train_halo_giant,
    train_halo_giant_packed,
)
from gcn_maxcut_tpu_torch.parallel.mesh import make_mesh  # noqa: E402

GIANT_N = 10_002_432
PLAIN_SHARD = 262_144
PLAIN_N = 1_048_576


def _device_us(evt) -> float:
    """Device time of an event that ran on the device (a kernel or a copy);
    0 for a host op, whose device time is its kernels' and counted there."""
    if not str(evt.device_type).endswith("CUDA"):
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def _profile(run, epochs: int) -> dict:
    res = run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        traced = run()
        torch.cuda.synchronize()
    rows = [(evt.key, _device_us(evt), evt.count) for evt in prof.key_averages()]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    device_us = sum(r[1] for r in rows)
    epoch_ms = res["epoch_time_s"] * 1e3
    return {
        "n": res["n"], "epochs": epochs, "epoch_ms": epoch_ms,
        "traced_epoch_ms": traced["epoch_time_s"] * 1e3,
        "device_ms_per_epoch": device_us / 1e3 / epochs,
        "device_busy_share": device_us / 1e3 / epochs / epoch_ms,
        "cut_fraction": res["cut_fraction"],
        "top_kernels": [
            {"name": k[:90], "ms_per_epoch": us / 1e3 / epochs,
             "share_of_device": us / device_us, "launches_per_epoch": c / epochs}
            for k, us, c in rows[:12]
        ],
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=10)
    ap.add_argument("--shards", type=int, default=4)
    args = ap.parse_args()
    resolve_device()
    ring = make_mesh(devices=["cuda:0"] * args.shards)
    E = args.epochs
    out = {"device": torch.cuda.get_device_name(0), "shards": args.shards}
    out["packed_halo"] = _profile(lambda: train_halo_giant_packed(
        GIANT_N // args.shards, PackedHaloGiantConfig(epochs=E), ring), E)
    out["single_chip_packed"] = _profile(lambda: train_banded_giant_packed(
        n=GIANT_N, epochs=E, device="cuda"), E)
    out["plain_halo"] = _profile(lambda: train_halo_giant(
        PLAIN_SHARD, HaloGiantConfig(epochs=E), ring), E)
    out["single_chip_plain"] = _profile(lambda: train_banded_giant(
        n=PLAIN_N, epochs=E, device="cuda"), E)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
