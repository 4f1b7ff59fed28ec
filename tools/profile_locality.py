#!/usr/bin/env python3
"""Where the locality trainer's epoch time goes on the card.

    python tools/profile_locality.py [--n 100000] [--epochs 20]

Builds the locality trainer's graph (``bench/locality.py``), trains 3
warm-up epochs, times ``--epochs`` more on the host clock (ending in a
synchronize), then traces as many again with ``torch.profiler`` (CPU and
CUDA activities).  Prints one JSON object: the wall time per epoch without
and with the profiler, the device time per epoch summed over the device's
own events (kernels and copies; one stream, so they do not overlap), the
device busy share (device time / unprofiled wall time), and the top device
events by time with their counts.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from gcn_maxcut_tpu_torch.bench.locality import (  # noqa: E402
    locality_graph,
    locality_params,
    locality_spec,
)
from gcn_maxcut_tpu_torch.convert import params_from_jax  # noqa: E402
from gcn_maxcut_tpu_torch.core.graph import pad_graph_batch  # noqa: E402
from gcn_maxcut_tpu_torch.device import resolve_device  # noqa: E402
from gcn_maxcut_tpu_torch.train.config import TrainingConfig  # noqa: E402
from gcn_maxcut_tpu_torch.train.loop import setup_train_state, train_model  # noqa: E402


def _device_us(evt) -> float:
    """Device time of an event that ran on the device (a kernel or a copy);
    0 for a host op, whose device time is its kernels' and counted there."""
    if not str(evt.device_type).endswith("CUDA"):
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--epochs", type=int, default=20)
    args = ap.parse_args()
    dev = resolve_device()
    g, _ = locality_graph(locality_spec(args.n))
    batch = pad_graph_batch([g]).to(dev)

    def config(epochs):
        return TrainingConfig(
            n_nodes=args.n, dim_embedding=128, hidden_dim=64, number_classes=3,
            learning_rate=1e-3, number_epochs=epochs, patience=10**6, dropout=0.0,
            feature_mode="embedding", aggregation="sparse")

    state = setup_train_state(config(3), params=params_from_jax(locality_params(args.n), dev),
                              device=dev)
    train_model(batch, config(3), state=state)                 # warm-up, kernel build
    state.config = config(args.epochs)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_model(batch, state.config, state=state)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train_model(batch, state.config, state=state)
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    rows = [(evt.key, _device_us(evt), evt.count) for evt in prof.key_averages()]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    device_us = sum(r[1] for r in rows)
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "n": args.n, "epochs": args.epochs,
        "wall_ms_per_epoch": wall_s * 1e3 / args.epochs,
        "traced_wall_ms_per_epoch": traced_s * 1e3 / args.epochs,
        "device_ms_per_epoch": device_us / 1e3 / args.epochs,
        "device_busy_share": device_us / 1e6 / wall_s,
        "top_kernels": [
            {"name": k[:90], "ms_per_epoch": us / 1e3 / args.epochs,
             "share_of_device": us / device_us, "launches_per_epoch": c / args.epochs}
            for k, us, c in rows[:15]
        ],
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
