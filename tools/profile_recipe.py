#!/usr/bin/env python3
"""Where the recipe's time goes on the card: its training epoch and one
graph's default decode.

    python tools/profile_recipe.py [--epochs 20] [--decodes 10]

Epoch: the reference recipe's training set-up (``bench/microbench.py
recipe_trainer``: 20 graphs of n = 500, d in [6, 8], padded to 1000,
GCNSoftmax 1000-500-3, per-graph Adam steps), 3 warm-up epochs, then
``--epochs`` epochs timed on the host clock (ending in a synchronize), then
as many again traced with ``torch.profiler`` (CPU and CUDA activities).

Decode: the default decode (``eval/decode.refine_multi_start``: 200
sampled rollouts, then the 4-start greedy flip) of one n = 500 graph of the
quality suite (``bench/quality._suite_specs``), with the parameters the
epochs above left, timed and traced the same way over ``--decodes`` calls.

Prints one JSON object: for each, the wall time per call without and with
the profiler, the device time per call summed over the device's own events
(kernels and copies; one stream, so they do not overlap), the device busy
share (device time / unprofiled wall time) and the top device events by
time with their counts.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path
from typing import Callable

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from gcn_maxcut_tpu_torch.bench.microbench import recipe_trainer  # noqa: E402
from gcn_maxcut_tpu_torch.bench.quality import _suite_specs  # noqa: E402
from gcn_maxcut_tpu_torch.data.process import DataConfig, process_graphs  # noqa: E402
from gcn_maxcut_tpu_torch.device import resolve_device  # noqa: E402
from gcn_maxcut_tpu_torch.eval.decode import refine_multi_start  # noqa: E402
from gcn_maxcut_tpu_torch.eval.harness import _forward  # noqa: E402


def _device_us(evt) -> float:
    """Device time of an event that ran on the device (a kernel or a copy);
    0 for a host op, whose device time is its kernels' and counted there."""
    if not str(evt.device_type).endswith("CUDA"):
        return 0.0
    for name in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def profile_calls(fn: Callable[[], object], calls: int) -> dict:
    """Host-clock wall time of ``calls`` calls, then the same traced."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    rows = [(evt.key, _device_us(evt), evt.count) for evt in prof.key_averages()]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    device_us = sum(r[1] for r in rows)
    return {
        "calls": calls,
        "wall_ms_per_call": wall_s * 1e3 / calls,
        "traced_wall_ms_per_call": traced_s * 1e3 / calls,
        "device_ms_per_call": device_us / 1e3 / calls,
        "device_busy_share": device_us / 1e6 / wall_s,
        "top_kernels": [
            {"name": k[:90], "ms_per_call": us / 1e3 / calls,
             "share_of_device": us / device_us, "launches_per_call": c / calls}
            for k, us, c in rows[:12]
        ],
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--epochs", type=int, default=20)
    ap.add_argument("--decodes", type=int, default=10)
    args = ap.parse_args()
    dev = resolve_device()
    state, run_epoch = recipe_trainer(device=dev)
    for _ in range(3):
        run_epoch()
    epoch = profile_calls(run_epoch, args.epochs)

    params = state.params()
    g = process_graphs(_suite_specs(500, 1), DataConfig(max_nodes=1000)).graphs[0].to(dev)
    with torch.no_grad():
        probs = _forward(params, g)
    gen = torch.Generator(device=dev).manual_seed(0)

    def decode():
        with torch.no_grad():
            return refine_multi_start(g, probs, gen, 200, 4)

    decode()
    print(json.dumps({
        "device": torch.cuda.get_device_name(0),
        "epoch": epoch,
        "decode": {"n": 500, "refined_cut": float(decode()[1]),
                   **profile_calls(decode, args.decodes)},
    }, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
