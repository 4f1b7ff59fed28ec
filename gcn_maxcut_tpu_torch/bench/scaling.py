"""Scaling harness: one sharded GCN conv across device counts.

Port of ``gcn_maxcut_tpu/bench/scaling.py``.  ``bench_sharded_conv`` times
the forward and forward+backward of one ``parallel.spmm.sharded_gcn_conv``
on an n-node d-regular graph node-sharded over D devices;
``scaling_sweep`` runs it at 1, 2, 4, ... CUDA devices, as many as there
are.  A mesh that repeats a device (``devices=["cuda:0"] * 4``) is a
virtual ring: it runs the cross-shard hops on one card and is marked
``virtual_ring``, which is no scaling point.  Times are the host clock
around ``iters`` calls after two warm-up calls, every device synchronized.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from gcn_maxcut_tpu_torch.bench.giant_demo import _synchronize
from gcn_maxcut_tpu_torch.bench.locality import locality_params
from gcn_maxcut_tpu_torch.data.generate import random_regular_edges
from gcn_maxcut_tpu_torch.device import resolve_device
from gcn_maxcut_tpu_torch.parallel.mesh import make_mesh
from gcn_maxcut_tpu_torch.parallel.partition import shard_graph
from gcn_maxcut_tpu_torch.parallel.spmm import sharded_gcn_conv

logger = logging.getLogger(__name__)


def bench_sharded_conv(
    n: int,
    d: int,
    feature_dim: int = 128,
    out_dim: int = 128,
    num_devices: Optional[int] = None,
    schedule: str = "ring",
    iters: int = 10,
    seed: int = 0,
    edges: Optional[np.ndarray] = None,
    devices: Optional[Sequence[str | torch.device]] = None,
    device: str | torch.device | None = None,
) -> Dict[str, float]:
    """Forward and forward+backward of one sharded conv.  The mesh is
    ``devices`` when given, else the first ``num_devices`` CUDA devices
    (default all; ``device`` names the one card type: "cpu" gives a CPU
    ring of ``num_devices`` shards).  Raises without CUDA unless the
    devices are CPUs."""
    if devices is None:
        dev = resolve_device(device)
        count = num_devices or (torch.cuda.device_count() if dev.type == "cuda" else 1)
        devices = ([torch.device("cuda", i) for i in range(count)] if dev.type == "cuda"
                   else [dev] * count)
    mesh = make_mesh(devices=devices)
    D = mesh.size

    if edges is None:
        edges = random_regular_edges(n, d, seed=seed)
    senders = np.concatenate([edges[:, 0], edges[:, 1]])
    receivers = np.concatenate([edges[:, 1], edges[:, 0]])
    t0 = time.perf_counter()
    sg, _ = shard_graph(senders, receivers, n, D)
    sg = sg.to(mesh)
    partition_time = time.perf_counter() - t0

    p = locality_params(D * sg.n_shard, feature_dim, out_dim, out_dim, seed)
    w = torch.from_numpy(p["conv1"]["w"]).to(mesh.devices[0])
    b = torch.from_numpy(p["conv1"]["b"]).to(mesh.devices[0])
    xs = [torch.from_numpy(x).to(dev).requires_grad_(True)
          for x, dev in zip(p["embed"].reshape(D, sg.n_shard, feature_dim), mesh.devices)]

    def loss():
        ys = sharded_gcn_conv(w, b, sg, xs, mesh, schedule)
        return sum(torch.sum(y * y).to(mesh.devices[0]) for y in ys)

    def fwd():
        with torch.no_grad():
            return loss()

    def grad():
        return torch.autograd.grad(loss(), xs)

    def timeit(fn):
        for _ in range(2):
            fn()
        _synchronize(mesh.devices)
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        _synchronize(mesh.devices)
        return (time.perf_counter() - t0) / iters

    t_fwd = timeit(fwd)
    t_bwd = timeit(grad)
    e = int(senders.shape[0])
    res = {
        "n": n,
        "d": d,
        "num_devices": D,
        "virtual_ring": len(set(mesh.devices)) < D,
        "device": str(mesh.devices[0]),
        "schedule": schedule,
        "partition_time_s": partition_time,
        "fwd_time_s": t_fwd,
        "fwd_edges_per_s": e / t_fwd,
        "fwdbwd_time_s": t_bwd,
        "fwdbwd_edges_per_s": e / t_bwd,
    }
    logger.info("sharded conv n=%d d=%d D=%d (%s%s): fwd %.2e edges/s, fwd+bwd %.2e",
                n, d, D, schedule, ", virtual ring" if res["virtual_ring"] else "",
                res["fwd_edges_per_s"], res["fwdbwd_edges_per_s"])
    return res


def scaling_sweep(
    n: int,
    d: int = 8,
    feature_dim: int = 128,
    device_counts: Optional[Sequence[int]] = None,
    schedule: str = "ring",
    device: str | torch.device | None = None,
) -> List[Dict[str, float]]:
    """edges/s at 1, 2, 4, ... devices, up to every CUDA device (one card:
    ``[1]``; ``device="cpu"``: one CPU shard)."""
    dev = resolve_device(device)
    total = torch.cuda.device_count() if dev.type == "cuda" else 1
    if device_counts is None:
        device_counts = [c for c in (1, 2, 4, 8, 16, 32) if c <= total]
        if total not in device_counts:
            device_counts.append(total)
    edges = random_regular_edges(n, d, seed=0)
    out = [bench_sharded_conv(n, d, feature_dim, num_devices=c, schedule=schedule,
                              edges=edges, device=dev) for c in device_counts]
    base = out[0]["fwdbwd_edges_per_s"]
    for r in out:
        r["scaling_efficiency"] = r["fwdbwd_edges_per_s"] / (base * r["num_devices"])
    return out
