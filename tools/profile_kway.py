#!/usr/bin/env python3
"""Where the k-way sweep's epoch time goes on the card.

    python tools/profile_kway.py [--n 100000] [--epochs 20]

Three cells of ``parallel/giant.py`` at k = 3 (embedding 128, hidden 64):
the sweep's 8-regular graph on one shard and on a 4-shard virtual ring of
one card, and the banded-random graph on the 4-shard ring with hop 0 on K1
(``block_ell=True``, per-shard RCM).  For each: 3 warm-up epochs, then
``--epochs`` timed on the host clock (ending in a synchronize), then as
many traced with ``torch.profiler``.  Prints one JSON object per cell: wall
ms an epoch, device ms an epoch (summed over the device's own events, one
stream), the device busy share, device events an epoch, and the top device
events with their counts.  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from gcn_maxcut_tpu_torch.bench.locality import locality_params  # noqa: E402
from gcn_maxcut_tpu_torch.bench.microbench import banded_random_edges  # noqa: E402
from gcn_maxcut_tpu_torch.data.generate import random_regular_edges  # noqa: E402
from gcn_maxcut_tpu_torch.device import resolve_device  # noqa: E402
from gcn_maxcut_tpu_torch.parallel import giant  # noqa: E402
from gcn_maxcut_tpu_torch.parallel.mesh import make_mesh  # noqa: E402
from gcn_maxcut_tpu_torch.parallel.partition import shard_graph  # noqa: E402
from profile_locality import _device_us  # noqa: E402


def profile_cell(name, edges, n, shards, epochs, **cfg_kw) -> dict:
    mesh = make_mesh(devices=["cuda:0"] * shards)
    src = np.concatenate([edges[:, 0], edges[:, 1]])
    dst = np.concatenate([edges[:, 1], edges[:, 0]])
    cfg = giant.GiantConfig(**cfg_kw)
    sg, _ = shard_graph(src, dst, n, shards, local_reorder=cfg.local_reorder,
                        block_ell=cfg.block_ell)
    sg = sg.to(mesh)
    params = locality_params(shards * sg.n_shard, cfg.dim_embedding, cfg.hidden_dim,
                             cfg.num_classes, cfg.seed)
    params["embed"] = params["embed"].reshape(shards, sg.n_shard, -1)
    state = giant.GiantState.create(params, mesh, cfg.learning_rate)

    def run(k):
        for _ in range(k):
            giant._epoch(state, sg, mesh, cfg)
        torch.cuda.synchronize()

    run(3)
    t0 = time.perf_counter()
    run(epochs)
    wall_s = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(epochs)
        traced_s = time.perf_counter() - t0
    rows = [(evt.key, _device_us(evt), evt.count) for evt in prof.key_averages()]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    device_us = sum(r[1] for r in rows)
    return {
        "cell": name, "n": n, "shards": shards, "n_shard": sg.n_shard,
        "ell_width": None if sg.ell_senders is None else int(sg.ell_senders[0].shape[-1]),
        "block_ell": sg.bell_block is not None, "epochs": epochs,
        "wall_ms_per_epoch": wall_s * 1e3 / epochs,
        "traced_wall_ms_per_epoch": traced_s * 1e3 / epochs,
        "device_ms_per_epoch": device_us / 1e3 / epochs,
        "device_busy_share": device_us / 1e6 / wall_s,
        "device_events_per_epoch": sum(r[2] for r in rows) / epochs,
        "top_kernels": [
            {"name": k[:90], "ms_per_epoch": us / 1e3 / epochs, "share_of_device": us / device_us,
             "launches_per_epoch": c / epochs}
            for k, us, c in rows[:12]
        ],
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--epochs", type=int, default=20)
    args = ap.parse_args()
    resolve_device()
    regular = random_regular_edges(args.n, 8, seed=0)
    banded = banded_random_edges(args.n, 8, 255, 0)
    cells = [
        profile_cell("sweep k=3, 1 shard", regular, args.n, 1, args.epochs),
        profile_cell("sweep k=3, 4-shard virtual ring", regular, args.n, 4, args.epochs),
        profile_cell("banded k=3, 4-shard virtual ring, hop 0 on K1", banded, args.n, 4,
                     args.epochs, block_ell=True, local_reorder="rcm"),
    ]
    print(json.dumps({"device": torch.cuda.get_device_name(0), "cells": cells}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
