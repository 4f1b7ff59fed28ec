"""P3: row-sub-blocked staging for the block-ELL SpMM.

Port of ``experiments/subblock_probe.py``.  On the TPU, tiling a B-row
block into 128-row sub-blocks, each comparing only its slice of the window
[k·128 − Wp, k·128 + 128 + Wp), cut the one-hot build's compare work.
Hopper builds no one-hot matrix.  P3's kernel
(``ops/probe_kernels.subblock_spmm``, ``csrc/subblock_stream.cu``) streams
a strip of S sub-blocks through a shared-memory ring, each sub-block
reading only its slice, so x is read (S·128 + 2·Wp)/(S·128) times, where
staging each slice on its own read it (128 + 2·Wp)/128 times.  Each
configuration also runs the whole-window kernel (``window_gather`` on the
wrapped window, (B + 2·Wp)/B) on the same graph, and the shipped path
(``spmm`` through the graph's block-ELL plan) when the graph plans.

    python -m gcn_maxcut_tpu_torch.experiments.subblock_probe [--device cpu --n 4096]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from gcn_maxcut_tpu_torch.bench.microbench import _banded_regular_graph, time_stats
from gcn_maxcut_tpu_torch.core.graph import Graph, round_up
from gcn_maxcut_tpu_torch.device import resolve_device
from gcn_maxcut_tpu_torch.experiments import (
    device_name,
    probe_cli,
    rel_err,
    roofline_edges_per_s,
)
from gcn_maxcut_tpu_torch.ops.probe_kernels import (
    subblock_spmm,
    subblock_stream_shape,
    window_gather,
)
from gcn_maxcut_tpu_torch.ops.segment import spmm

N, D, F = 100_000, 8, 128
R0 = 128
CONFIGS = ((255, 256, 256), (511, 512, 512))     # (locality W, B, Wp)


def subblock_table(g: Graph, n: int, d: int):
    """The exact-degree ELL table of a d-regular graph, receiver-major,
    absolute sender ids, padded to n_pad rows with weight 0.  Returns
    (sidx int32, w float32, offset of each edge (receiver-major, wrapped to
    ±n_pad/2), receiver of each edge)."""
    n_pad = g.n_pad
    s = g.senders.cpu().numpy()[: int(g.n_edges)]
    r = g.receivers.cpu().numpy()[: int(g.n_edges)]
    order = np.argsort(r, kind="stable")
    sidx = s[order].reshape(n, d)
    sidx = np.concatenate([sidx, np.zeros((n_pad - n, d), sidx.dtype)]).astype(np.int32)
    w = np.zeros((n_pad, d), np.float32)
    w[:n] = 1.0
    off = (s[order] - r[order] + n_pad // 2) % n_pad - n_pad // 2
    return sidx, w, off, r[order]


def window_operands(x: torch.Tensor, sidx: torch.Tensor, B: int, wp: int):
    """The same table for the whole-window kernel: xpad holds the wrapped
    window rows (x's last wp rows, x, its first wp rows), and each index is
    the sender's place in its receiver's block window, mod n."""
    n = x.shape[0]
    xpad = torch.cat([x[n - wp:], x, x[:wp]])
    start = (torch.arange(n, device=x.device) // B * B)[:, None]
    lidx = ((sidx.long() - start + wp) % n).to(torch.int32)
    return xpad, lidx


def main(n: int = N, iters: int = 10, device=None) -> dict:
    """P3: 128-row slices read from a ring against the whole block window."""
    dev = resolve_device(device)
    n_pad = round_up(n, 2048)
    e = n * D
    roof = roofline_edges_per_s(F, n, e)
    print(f"subblock_probe on {device_name(dev)}: n={n} (n_pad {n_pad}) d={D} F={F}", flush=True)
    rows = []
    for locality, B, wp in CONFIGS:
        g = _banded_regular_graph(n, D, locality, n_pad=n_pad)
        gd = g.to(dev)
        x = torch.randn((n_pad, F), generator=torch.Generator(device=dev).manual_seed(1),
                        device=dev)
        row = {"W": locality, "B": B, "Wp": wp, "shipped_block": g.bell_block}
        if g.bell_block is not None:
            st = time_stats(lambda: spmm(gd, x), dev, iters)
            row["shipped"] = {"stats": st, "edges_per_s": e / st["best_s"]}
            print(f"W={locality}: shipped {e / st['best_s']:.3e} edges/s "
                  f"({100 * e / st['best_s'] / roof:.0f}% of roofline, spread "
                  f"{100 * st['spread_frac']:.0f}%)", flush=True)
        sidx, w, off, recv = subblock_table(g, n, D)
        far = np.abs(off) > wp
        row["n_far"] = int(far.sum())
        print(f"W={locality}: edges with |offset|>wp: {row['n_far']}", flush=True)
        ij, wj = torch.from_numpy(sidx).to(dev), torch.from_numpy(w).to(dev)
        ref = spmm(gd, x)
        # mask rows touched by dropped (far) edges
        far_rows = np.zeros(n_pad, bool)
        far_rows[recv[far]] = True
        keep = torch.from_numpy(~far_rows).to(dev).float()
        xpad, lidx = window_operands(x, ij, B, wp)
        ring = subblock_stream_shape(n_pad, F, R0, wp, D, 4)
        designs = (
            ("sub-blocked", ring.reads, lambda: subblock_spmm(x, ij, wj, n_pad, B, wp)),
            ("whole window", (B + 2 * wp) / B, lambda: window_gather(xpad, lidx, wj, B, wp)),
        )
        for name, staged, fn in designs:
            err = rel_err(fn(), ref, keep)
            st = time_stats(fn, dev, iters)
            eps = e / st["best_s"]
            row[name] = {"stats": st, "edges_per_s": eps, "fraction_of_roofline": eps / roof,
                         "relerr": err, "rows_staged_per_row": staged}
            print(f"W={locality} B={B}: {name} {eps:.3e} edges/s ({100 * eps / roof:.0f}% of "
                  f"roofline, spread {100 * st['spread_frac']:.0f}%, {staged:g} rows staged a row), "
                  f"rel err {err:.1e}", flush=True)
        rows.append(row)
    return {"device": device_name(dev), "n": n, "n_pad": n_pad, "configs": rows}


if __name__ == "__main__":
    sys.exit(probe_cli(main, N))
