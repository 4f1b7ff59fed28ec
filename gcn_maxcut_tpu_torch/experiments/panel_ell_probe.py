"""P4: a panel-bucketed block-ELL table.

Port of ``experiments/panel_ell_probe.py``.  On the TPU, bucketing each
row's senders by the 128-row panel of its block window cut the one-hot
build to W_P compare passes a panel.  On Hopper there is no one-hot build,
and the bucketed table is 3–6× K1's: n_panels·W_P slots a row instead of d.
``ops/probe_kernels.panel_ell_spmm`` reads the tables as they are, beside
the shipped path (``spmm`` through the graph's block-ELL plan, K1).  A
configuration that drops more than 5% of the edges (escapes from the
window, or spills beyond W_P in a panel) is skipped, as in the JAX probe.

    python -m gcn_maxcut_tpu_torch.experiments.panel_ell_probe [--device cpu --n 4096]
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from gcn_maxcut_tpu_torch.bench.microbench import _banded_regular_graph, time_stats
from gcn_maxcut_tpu_torch.core.graph import round_up
from gcn_maxcut_tpu_torch.device import resolve_device
from gcn_maxcut_tpu_torch.experiments import (
    device_name,
    probe_cli,
    rel_err,
    roofline_edges_per_s,
)
from gcn_maxcut_tpu_torch.ops.probe_kernels import PANEL, panel_ell_spmm
from gcn_maxcut_tpu_torch.ops.segment import spmm

N, D, F = 100_000, 8, 128
CONFIGS = ((255, 256), (511, 512))     # (locality W, Wp)
PANEL_SLOTS = (2, 3, 4)                # W_P
MAX_DROP = 0.05


def build_panel_tables(senders, receivers, weights, n_pad, B, Wp, W_P):
    """[n_pad, n_panels*W_P] panel-local index + weight tables.

    Out-of-window edges (wrap-around; the shipped plan's outlier COO) and
    over-W_P spills are DROPPED here — the probe measures the kernel, not
    the correction — and the affected receiver rows are returned so the
    correctness check can mask them.  Returns (idx, wgt, n_dropped,
    dropped_rows_mask).  The JAX probe's function, array for array."""
    Wwin = B + 2 * Wp
    n_panels = Wwin // PANEL
    if Wwin % PANEL:
        raise ValueError(f"window {Wwin} not divisible by PANEL={PANEL}")
    lidx = (senders - (receivers // B) * B + Wp) % n_pad
    in_win = lidx < Wwin
    escaped_recv = receivers[~in_win]
    senders, receivers, weights, lidx = (
        senders[in_win], receivers[in_win], weights[in_win], lidx[in_win]
    )
    panel = lidx // PANEL
    local = lidx % PANEL
    key = receivers * n_panels + panel
    order = np.lexsort((local, key))
    rank = np.arange(senders.shape[0]) - np.concatenate(
        [[0], np.cumsum(np.bincount(key[order]))[:-1]]
    )[key[order]]
    fits = rank < W_P
    idx = np.full((n_pad, n_panels * W_P), -1, np.int32)
    wgt = np.zeros((n_pad, n_panels * W_P), np.float32)
    r_ord = receivers[order]
    idx[r_ord[fits], (panel[order] * W_P + rank)[fits]] = local[order][fits]
    wgt[r_ord[fits], (panel[order] * W_P + rank)[fits]] = weights[order][fits]
    n_drop = int((~in_win).sum() + (~fits).sum())
    # rows losing any edge: out-of-window receivers + spilled receivers
    dropped_rows = np.zeros(n_pad, bool)
    dropped_rows[escaped_recv] = True
    dropped_rows[r_ord[~fits]] = True
    return idx, wgt, n_drop, dropped_rows


def panel_block(bell_block: int | None) -> int:
    """The probe's block: the graph's planned block, else 256."""
    return bell_block or 256


def main(n: int = N, iters: int = 10, device=None) -> dict:
    """P4: the panel-ELL kernel at W_P = 2, 3, 4 beside the shipped path."""
    dev = resolve_device(device)
    n_pad = round_up(n, 2048)
    e = n * D
    roof = roofline_edges_per_s(F, n, e)
    print(f"panel_ell_probe on {device_name(dev)}: n={n} (n_pad {n_pad}) d={D} F={F}", flush=True)
    rows = []
    for locality, wp in CONFIGS:
        g = _banded_regular_graph(n, D, locality, n_pad=n_pad)
        gd = g.to(dev)
        x = torch.randn((n_pad, F), generator=torch.Generator(device=dev).manual_seed(1),
                        device=dev)
        if g.bell_block is not None:
            st = time_stats(lambda: spmm(gd, x), dev, iters)
            rows.append({"W": locality, "design": "shipped", "B": g.bell_block, "stats": st,
                         "edges_per_s": e / st["best_s"]})
            print(f"W={locality}: shipped block-ELL {e / st['best_s']:.3e} edges/s "
                  f"({100 * e / st['best_s'] / roof:.0f}% of roofline, spread "
                  f"{100 * st['spread_frac']:.0f}%)", flush=True)
        ref = spmm(gd, x)
        s = g.senders.cpu().numpy()[: int(g.n_edges)].astype(np.int64)
        r = g.receivers.cpu().numpy()[: int(g.n_edges)].astype(np.int64)
        w = np.ones_like(s, np.float32)
        B = panel_block(g.bell_block)
        for W_P in PANEL_SLOTS:
            idx, wgt, n_drop, dropped = build_panel_tables(s, r, w, n_pad, B, wp, W_P)
            if n_drop > MAX_DROP * e:
                print(f"W={locality} W_P={W_P}: dropped {n_drop} "
                      f"({100 * n_drop / e:.2f}%) too high", flush=True)
                continue
            ij, wj = torch.from_numpy(idx).to(dev), torch.from_numpy(wgt).to(dev)
            keep = torch.from_numpy(~dropped).to(dev).float()
            err = rel_err(panel_ell_spmm(x, ij, wj, n_pad, B, wp, W_P), ref, keep)
            st = time_stats(lambda: panel_ell_spmm(x, ij, wj, n_pad, B, wp, W_P), dev, iters)
            eps = e / st["best_s"]
            rows.append({"W": locality, "design": "panel-ELL", "W_P": W_P, "B": B, "Wp": wp,
                         "slots": idx.shape[1], "dropped": n_drop, "stats": st,
                         "edges_per_s": eps, "fraction_of_roofline": eps / roof, "relerr": err})
            print(f"W={locality} W_P={W_P}: panel-ELL {eps:.3e} edges/s "
                  f"({100 * eps / roof:.0f}% of roofline, spread "
                  f"{100 * st['spread_frac']:.0f}%), dropped "
                  f"{100 * n_drop / e:.2f}%, rel err (kept rows) {err:.1e}", flush=True)
    return {"device": device_name(dev), "n": n, "n_pad": n_pad, "rows": rows}


if __name__ == "__main__":
    sys.exit(probe_cli(main, N))
