#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``gcn_maxcut_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases; any failure ends the run with a non-zero exit code:

  1. build      compile every ``gcn_maxcut_tpu_torch/csrc/*.cu``
                (``banded_window.cu``: K2, K3, K4, K5, K6; ``block_ell_window.cu``:
                K1; ``probe_kernels.cu``: the probes' window_gather,
                panel_ell_spmm and banded_spmm_cols) with nvcc for sm_90a,
                one nvcc per source, started together, and print the card's
                name and power limit;
  2. kernels    hold K1 (``block_ell_spmm``: the microbenchmark's plan at
                F = 128, the locality trainer's at F = 64 and 3, and small
                odd plans), K2 (``banded_spmm_unit``, r = 1, F = 16 and 3;
                F = 128 at ``bench --what banded``'s two sizes),
                K3 (``banded_spmm_unit_packed``, r = 8, F = 16) and K4
                (``banded_spmm``, n = 131,072 and 1,250,304 at F = 128, and
                F = 3) against their plain PyTorch versions on the card,
                forward and gradient; time each beside its bound, its plain
                version and one PyTorch library call where there is one;
     halo       hold K5 (``halo_banded_spmm``: n = 131,072 at F = 128,
                weighted, and the plain halo trainer's 262,144-row shards at
                F = 128 and 3, unit weights) and K6
                (``halo_banded_spmm_unit_packed``: the packed halo trainer's
                10,002,432 × 16 at r = 8) against their plain versions on
                rings of 1, 2 and 4 shards on the card, forward and gradient,
                and in float32 bit for bit against K4/K2 and K3 on the
                gathered array; time one shard's launch and the ring op;
     probes     hold the design probes' kernels against their plain versions
                at the probes' sizes (``window_gather`` at every P1 (W, B),
                float32 and bf16 x, and P2's d = 16; ``subblock_spmm`` on
                K1's kernel at both P3 configurations; ``panel_ell_spmm`` at
                every P4 (W, W_P) the 5% rule keeps; ``banded_spmm_cols``
                and K4 on every P5 variant's weights), time each beside its
                bound, its plain version and ``torch.sparse.mm``; then run
                the five probe entry points (``gcn_maxcut_tpu_torch.experiments``)
                and check their launch counts and errors;
  3. giant      the packed giant trainer at its defaults (n = 10,002,432,
                d = 8, bandwidth 63, bf16 aggregation and first moment, 40
                epochs) through K3, after a small run held against the CPU;
                then the plain-layout trainer at n = 1,048,576 through K2;
     halo       the node-sharded trainers on a ring of 4 shards on the card:
                a small packed run held against a CPU ring, a 1-shard ring
                against the single-chip packed trainer, then the packed halo
                trainer at its defaults (n = 10,002,432, 40 epochs) through
                K6, held to the giant phase's cut, and the plain halo trainer
                (emb 128, hidden 128, n = 1,048,576, 10 epochs) through K5;
  4. recipe     the ``pipeline`` flow: 20 graphs of n = 500, d in [6, 8],
                padded to 1000, GCNSoftmax 1000-500-3, 300 epochs, decoded
                with 200 rollouts and held against the JAX pipeline's cut;
                the randomized baseline is printed beside it;
  5. locality   the locality trainer (``bench --what locality``): a small
                run held against the CPU, then n = 100,000 through K1 (RCM,
                plan, 200 epochs, decode), held against the JAX package's
                cut on the same graph (checked by its digest; the RCM
                relabeling is saved for the reference) and initial
                parameters;
  6. microbench ``bench --what spmm`` (K1) and ``bench --what banded`` (K2,
                K4) at their defaults.

Each path runs with the launch counters set to 0 just before it and read
just after.  The end of the output is the card's name and power limit, one
JSON line of kernel numbers, and ``{"ok": true, "device": {...}}``.  Detail
goes to ``chiprun_out/chip_smoke.json``.  TF32 is off for matmuls and cuDNN:
the JAX reference computes in full float32.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out"
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
F32_OPS_PER_S = 67e12          # H100 SXM float32 outside the tensor cores
KERNEL_SOURCE = "gcn_maxcut_tpu_torch/csrc/banded_window.cu"
BLOCK_ELL_SOURCE = "gcn_maxcut_tpu_torch/csrc/block_ell_window.cu"
PROBE_SOURCE = "gcn_maxcut_tpu_torch/csrc/probe_kernels.cu"
PROBE_ITERS = 10                # timed calls of each probe case (plus 2 warm-up)

GIANT_N = 10_002_432
GIANT_EPOCHS = 40
PLAIN_N = 1_048_576
PLAIN_EPOCHS = 10
HALO_SHARDS = 4                 # the virtual ring of the halo trainers
HALO_K5_N = 131_072             # K5 at the banded microbenchmark's n
HALO_PLAIN_SHARD = 262_144      # plain halo trainer: n = 1,048,576 on 4 shards
HALO_PLAIN_EPOCHS = 10
HALO_PACKED_SHARD = GIANT_N // HALO_SHARDS
SMALL_CASES = [                 # (n, F, r, offsets): odd shapes and wrap edges
    (296, 3, 8, (1, -1, 7, -7)),
    (400, 20, 8, (2, -5, 6)),
    (1024, 16, 8, (63, -63, 1, -1)),
]
# The JAX package's pipeline at the recipe's defaults (seed 1000), decoded
# on the same held-out graphs: argmax 1205.0, post-processed 1238.6,
# randomized baseline 1253.8 (average cuts).
REFERENCE_POST_CUT = 1238.6
# The JAX package's train_model on the locality trainer's graph from the same
# initial parameters (tools/locality_reference.py at its defaults on the CPU,
# with --perm the RCM relabeling this script saves on the card's machine,
# SciPy 1.18.1: bandwidth 331, 119 outliers): 200 epochs, decoded argmax cut
# 390,629 of 400,000 edges, on the graph of this digest.
REFERENCE_LOCALITY_CUT = 390_629.0
REFERENCE_LOCALITY_GRAPH = "cf6f0c38cf606dbc"
LOCALITY_N = 100_000
MICRO_N = 100_000
BANDED_N, BANDED_BIG_N = 131_072, 1_250_304


def log(*args) -> None:
    print(*args, flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]


def best_ms(torch, fn, reps: int = 15, warmup: int = 3) -> float:
    """Best of ``reps`` CUDA-event timings of ``fn`` after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return min(s.elapsed_time(e) for s, e in pairs)


def bound(n: int, F: int, d: int, elsize: int) -> tuple[float, str]:
    """Least time (ms) for one call: read x once and write y once, against
    n·F·d float32 adds."""
    bytes_ms = 2 * n * F * elsize / HBM_BYTES_PER_S * 1e3
    ops_ms = n * F * d / F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def max_err_within_tolerance(torch, got, ref) -> float:
    """float32: rtol = atol = 1e-5.  bfloat16: within one bf16 ulp of the
    plain version, which sums in float32 and rounds once."""
    diff = (got.float() - ref.float()).abs()
    if ref.dtype == torch.float32:
        torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)
    else:
        ref32 = ref.float()
        _, exp = torch.frexp(ref32)
        ulp = torch.where(ref32 == 0, torch.full_like(ref32, 2.0**-133),
                          torch.ldexp(torch.ones_like(ref32), exp - 8))
        check(bool((diff <= ulp).all()), "bf16 kernel within one ulp of its plain version")
    return float(diff.max())


def phase_build(build) -> dict:
    log("== build")
    t0 = time.perf_counter()
    logs = build.build_all()
    seconds = time.perf_counter() - t0
    for name, text in logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log(f"  {name}: {line.strip()}")
    log(f"  built {sorted(logs)} in {seconds:.2f} s")
    card = card_line()
    log(f"  card: {card}")
    return {"seconds": seconds, "card": card}


def phase_kernels(torch, tb, offsets: tuple[int, ...], bench_offsets: tuple[int, ...]) -> dict:
    """Kernel against plain version, forward and gradient; then timings.
    ``offsets`` are the giant trainers', ``bench_offsets`` those of
    ``bench --what banded``, which runs K2 at F = 128."""
    log("== kernels")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    d = len(offsets)
    wp = tb.padded_bandwidth(offsets)
    ops = {
        "K2": (lambda x, o, r: tb.banded_spmm_unit(x, o),
               lambda x, o, r: tb.banded_spmm_unit_plain(x, o)),
        "K3": (lambda x, o, r: tb.banded_spmm_unit_packed(x, o, r),
               lambda x, o, r: tb.banded_spmm_unit_packed_plain(x, o, r)),
    }
    cases = [("K2", GIANT_N, 16, 1, offsets), ("K2", GIANT_N, 3, 1, offsets),
             ("K2", PLAIN_N, 16, 1, offsets), ("K2", PLAIN_N, 3, 1, offsets),
             ("K3", GIANT_N, 16, 8, offsets),
             ("K2", BANDED_N, 128, 1, bench_offsets), ("K2", BANDED_BIG_N, 128, 1, bench_offsets)]
    cases += [(k, n, F, r, o) for (n, F, r, o) in SMALL_CASES for k in ("K2", "K3")]
    errors = {"K2": 0.0, "K3": 0.0}
    for name, n, F, r, offs in cases:
        kernel, plain = ops[name]
        for dtype in (torch.float32, torch.bfloat16):
            x = torch.randn(n, F, generator=gen, device=dev).to(dtype)
            dy = torch.randn(n, F, generator=gen, device=dev).to(dtype)
            xk = x.clone().requires_grad_(True)
            yk = kernel(xk, offs, r)
            yk.backward(dy)
            xp = x.clone().requires_grad_(True)
            yp = plain(xp, offs, r)
            yp.backward(dy)
            torch.cuda.synchronize()
            err = max(max_err_within_tolerance(torch, yk.detach(), yp.detach()),
                      max_err_within_tolerance(torch, xk.grad, xp.grad))
            errors[name] = max(errors[name], err)
            log(f"  {name} n={n} F={F} r={r} {str(dtype)[6:]}: fwd+grad max |err| {err:.3g}")
            del x, dy, xk, yk, xp, yp

    def circular_conv(F: int, dtype):
        # one cuDNN call for K2's function: a depthwise circular convolution
        # whose taps are the offsets (cross-correlation: tap o + W reads x[i + o])
        conv = torch.nn.Conv1d(F, F, 2 * wp + 1, padding=wp, padding_mode="circular",
                               groups=F, bias=False).to(dev, dtype)
        with torch.no_grad():
            conv.weight.zero_()
            for o in offsets:
                conv.weight[:, 0, o + wp] += 1
        return conv

    timings = []
    with torch.no_grad():
        for name, n, F, r, dtype in [
            ("K2", GIANT_N, 16, 1, torch.float32), ("K2", GIANT_N, 3, 1, torch.float32),
            ("K2", GIANT_N, 16, 1, torch.bfloat16), ("K2", PLAIN_N, 16, 1, torch.float32),
            ("K2", PLAIN_N, 3, 1, torch.float32),
            ("K3", GIANT_N, 16, 8, torch.bfloat16), ("K3", GIANT_N, 16, 8, torch.float32),
        ]:
            kernel, plain = ops[name]
            x = torch.randn(n, F, generator=gen, device=dev).to(dtype)
            row = {"name": name, "n": n, "F": F, "r": r, "dtype": str(dtype)[6:]}
            row["ms"] = best_ms(torch, lambda: kernel(x, offsets, r))
            row["plain_ms"] = best_ms(torch, lambda: plain(x, offsets, r))
            row["library_ms"] = row["library_max_abs_err"] = None
            if name == "K2":
                conv = circular_conv(F, dtype)
                xt = x.t().unsqueeze(0)
                lib = conv(xt)[0].t()
                row["library_max_abs_err"] = float(
                    (lib.float() - plain(x, offsets, r).float()).abs().max())
                row["library_ms"] = best_ms(torch, lambda: conv(xt))
                del conv, xt, lib
            row["bound_ms"], row["bound_by"] = bound(n, F, d, x.element_size())
            timings.append(row)
            log(f"  {name} n={n} F={F} r={r} {row['dtype']}: kernel {row['ms']:.4f} ms, "
                f"plain {row['plain_ms']:.4f} ms, library {row['library_ms']} ms, "
                f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
            del x
    torch.cuda.empty_cache()
    return {"max_abs_err": errors, "timings": timings}


def bell_operands(g, mode: str = "mask") -> tuple:
    """(sidx, w, out_s, out_r, out_w) of a graph's block-ELL plan."""
    w = g.bell_mask if mode == "mask" else g.bell_weights
    ow = g.bell_out_mask if mode == "mask" else g.bell_out_weights
    return g.bell_senders, w, g.bell_out_senders, g.bell_out_receivers, ow


def small_block_ell_graphs(np, tgraph) -> dict:
    """Odd plans, each with edges across the wrap at both ends."""
    rng = np.random.default_rng(7)

    def banded(n, per_node, w, long_edges=()):
        i = np.repeat(np.arange(n), per_node)
        j = (i + rng.integers(-w, w + 1, size=i.size)) % n
        keep = i != j
        extra = np.asarray(long_edges, dtype=np.int64).reshape(-1, 2)
        return np.concatenate([np.stack([i[keep], j[keep]], axis=1), extra])

    ring = np.stack([np.arange(2048), (np.arange(2048) + 1) % 2048], axis=1)
    adj = np.zeros((2048, 2048), np.float32)
    e = banded(2048, 3, 40, [(3, 1500), (700, 10)])
    adj[e[:, 0], e[:, 1]] = rng.random(e.shape[0]) + 0.5
    graphs = {
        "B=240, R0=B": tgraph.graph_from_edges(banded(1200, 2, 20, [(1, 600)]), 1200,
                                               block_ell=True),
        "width 1, directed ring (transpose plan)": tgraph.graph_from_edges(
            ring, 2048, symmetrize=False, block_ell=True),
        "width 1 forced, outliers + padding": tgraph.attach_block_ell(
            tgraph.graph_from_edges(banded(4096, 3, 60, [(0, 2000)]), 4096, block_ell=False),
            force_wp=64, force_width=1),
        "asymmetric weighted (transpose plan)": tgraph.graph_from_dense(adj, block_ell=True),
    }
    for name, g in graphs.items():
        check(g.bell_block is not None, f"small plan {name!r} exists")
    return graphs


def check_block_ell(torch, tbell, seg, g, F: int, gen, mode: str = "mask") -> float:
    """K1 through ``spmm`` (kernel forward and backward) against autograd
    through the plain version on the card; returns the max |error|."""
    dev = torch.device("cuda")
    gc = g.to(dev)
    n = g.n_pad
    x = torch.randn(n, F, generator=gen, device=dev)
    dy = torch.randn(n, F, generator=gen, device=dev)
    xk = x.clone().requires_grad_(True)
    yk = seg.spmm(gc, xk, None if mode == "mask" else gc.weights)
    yk.backward(dy)
    xp = x.clone().requires_grad_(True)
    yp = tbell.block_ell_spmm_plain(xp, *bell_operands(gc, mode), n, gc.bell_block, gc.bell_wp)
    yp.backward(dy)
    torch.cuda.synchronize()
    return max(max_err_within_tolerance(torch, yk.detach(), yp.detach()),
               max_err_within_tolerance(torch, xk.grad, xp.grad))


def csr_rect(torch, rows, cols, vals, shape):
    """float32 CSR matrix of ``shape`` with entries (rows, cols) = vals."""
    coo = torch.sparse_coo_tensor(torch.stack([rows.long(), cols.long()]), vals, shape)
    return coo.coalesce().to_sparse_csr()


def csr_of(torch, rows, cols, vals, n: int):
    """float32 CSR matrix [n, n] with entries (rows, cols) = vals."""
    return csr_rect(torch, rows, cols, vals, (n, n))


def time_block_ell(torch, tbell, g, F: int, gen, label: str) -> dict:
    dev = torch.device("cuda")
    gc = g.to(dev)
    n, B, wp = gc.n_pad, gc.bell_block, gc.bell_wp
    ops = bell_operands(gc)
    width, o_pad = ops[0].shape[1], ops[2].shape[0]
    x = torch.randn(n, F, generator=gen, device=dev)
    row = {"name": "K1", "case": label, "n": n, "F": F, "block": B, "wp": wp,
           "width": width, "o_pad": o_pad, "n_outliers": int(ops[4].sum()), "dtype": "float32"}
    with torch.no_grad():
        row["ms"] = best_ms(torch, lambda: tbell.block_ell_spmm(x, *ops, n, B, wp))
        row["kernel_only_ms"] = best_ms(torch, lambda: tbell._launch(x, ops[0], ops[1], n, B, wp))
        row["plain_ms"] = best_ms(torch, lambda: tbell.block_ell_spmm_plain(x, *ops, n, B, wp))
        real = gc.edge_mask > 0
        csr = csr_of(torch, gc.receivers[real], gc.senders[real], gc.edge_mask[real], n)
        lib = torch.sparse.mm(csr, x)
        row["library_max_abs_err"] = float(
            (lib - tbell.block_ell_spmm_plain(x, *ops, n, B, wp)).abs().max())
        row["library_ms"] = best_ms(torch, lambda: torch.sparse.mm(csr, x))
    bytes_ms = (2 * n * F * 4 + n * width * 8 + o_pad * (2 * F * 4 + 12)) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * n * width * F / F32_OPS_PER_S * 1e3
    row["bound_ms"] = max(bytes_ms, ops_ms)
    row["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    log(f"  K1 {label} n={n} F={F} B={B} Wp={wp} width={width} o_pad={o_pad}: op {row['ms']:.4f} ms "
        f"(kernel alone {row['kernel_only_ms']:.4f}), plain {row['plain_ms']:.4f} ms, "
        f"sparse.mm {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return row


def phase_kernels_block_ell(torch, np, tbell, seg, tgraph, micro, loc) -> dict:
    log("== kernels: K1 block_ell_spmm")
    gen = torch.Generator(device="cuda").manual_seed(1)
    t0 = time.perf_counter()
    g_micro = micro._banded_regular_graph(MICRO_N, 8, 255, n_pad=tgraph.round_up(MICRO_N, 2048))
    g_loc, bandwidth = loc.locality_graph(loc.locality_spec(LOCALITY_N))
    log(f"  plans built in {time.perf_counter() - t0:.2f} s: microbench B={g_micro.bell_block} "
        f"Wp={g_micro.bell_wp}; locality (RCM bandwidth {bandwidth}) B={g_loc.bell_block} "
        f"Wp={g_loc.bell_wp} outliers {int(g_loc.bell_out_mask.sum())}")
    cases = [("microbench", g_micro, 128, "mask"), ("locality", g_loc, 64, "mask"),
             ("locality", g_loc, 3, "mask"), ("microbench", g_micro, 3, "weights")]
    cases += [(name, g, F, mode) for name, g in small_block_ell_graphs(np, tgraph).items()
              for F, mode in ((16, "mask"), (3, "weights"))]
    err = 0.0
    for name, g, F, mode in cases:
        e = check_block_ell(torch, tbell, seg, g, F, gen, mode)
        err = max(err, e)
        log(f"  K1 {name} n={g.n_pad} F={F} {mode} B={g.bell_block} Wp={g.bell_wp} "
            f"width={g.bell_senders.shape[1]} symmetric={g.symmetric}: fwd+grad max |err| {e:.3g}")
    timings = [time_block_ell(torch, tbell, g_loc, 64, gen, "locality"),
               time_block_ell(torch, tbell, g_loc, 3, gen, "locality"),
               time_block_ell(torch, tbell, g_micro, 128, gen, "microbench")]
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "timings": timings}


def phase_kernels_weighted(torch, tb, offsets) -> dict:
    log("== kernels: K4 banded_spmm")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    d = len(offsets)
    err = 0.0
    timings = []
    for n, F in ((BANDED_N, 128), (BANDED_BIG_N, 128), (BANDED_N, 3), (296, 20)):
        x = torch.randn(n, F, generator=gen, device=dev)
        w = torch.rand(n, d, generator=gen, device=dev) + 0.5
        dy = torch.randn(n, F, generator=gen, device=dev)
        xk, wk = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        yk = tb.banded_spmm(xk, wk, offsets)
        yk.backward(dy)
        yk = yk.detach()
        xp, wq = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        yp = tb.banded_spmm_plain(xp, wq, offsets)
        yp.backward(dy)
        torch.cuda.synchronize()
        e = max(max_err_within_tolerance(torch, yk, yp.detach()),
                max_err_within_tolerance(torch, xk.grad, xp.grad),
                max_err_within_tolerance(torch, wk.grad, wq.grad))
        err = max(err, e)
        log(f"  K4 n={n} F={F} D={d}: fwd+grad (dx, dw) max |err| {e:.3g}")
        del xk, wk, xp, wq, yp, dy
        if n < BANDED_N:
            continue
        row = {"name": "K4", "n": n, "F": F, "D": d, "dtype": "float32"}
        with torch.no_grad():
            row["ms"] = best_ms(torch, lambda: tb.banded_spmm(x, w, offsets))
            row["plain_ms"] = best_ms(torch, lambda: tb.banded_spmm_plain(x, w, offsets))
            rows = torch.arange(n, device=dev).repeat_interleave(d)
            cols = (rows.view(n, d) + torch.tensor(offsets, device=dev)) % n
            csr = csr_of(torch, rows, cols.reshape(-1), w.reshape(-1), n)
            row["library_max_abs_err"] = float((torch.sparse.mm(csr, x) - yk).abs().max())
            row["library_ms"] = best_ms(torch, lambda: torch.sparse.mm(csr, x))
            del csr, rows, cols
        bytes_ms = (2 * n * F * 4 + n * d * 4) / HBM_BYTES_PER_S * 1e3
        ops_ms = 2 * n * d * F / F32_OPS_PER_S * 1e3
        row["bound_ms"] = max(bytes_ms, ops_ms)
        row["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
        timings.append(row)
        log(f"  K4 n={n} F={F}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"sparse.mm {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        del x, w, yk
    torch.cuda.empty_cache()
    return {"max_abs_err": err, "timings": timings}


def halo_bound(n_shard: int, L: int, d: int, wp: int, elsize: int,
               weighted: bool) -> tuple[float, str]:
    """Least time (ms) for one shard's launch: read the shard and its two
    Wp-row tiles once (and the [n_shard, d] float32 weights), write the
    shard once, against n_shard·L·d adds (2·n_shard·L·d operations
    weighted)."""
    nbytes = 2 * n_shard * L * elsize + 2 * wp * L * elsize + (n_shard * d * 4 if weighted else 0)
    ops = n_shard * L * d * (2 if weighted else 1)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def check_ring(torch, th, tb, mesh, name, x, offsets, gen, w=None, r=None) -> float:
    """A ring op against its plain version (forward, and the gradient of the
    unit op) and, for the same rows, against the circulant kernel on the
    gathered array: bit for bit in float32, within one ulp in bfloat16."""
    D = mesh.size
    shard = x.shape[0] // D
    xs = list(x.split(shard))
    dys = list(torch.randn(x.shape, generator=gen, device=x.device).to(x.dtype).split(shard))
    if r is None:
        op = lambda t: th.halo_banded_spmm_unit(t, offsets, mesh)  # noqa: E731
        circulant = tb.banded_spmm_unit(x, offsets)
    else:
        op = lambda t: th.halo_banded_spmm_unit_packed(t, offsets, r, mesh)  # noqa: E731
        circulant = tb.banded_spmm_unit_packed(x, offsets, r)
    xk = [t.clone().requires_grad_(True) for t in xs]
    yk = op(xk)
    torch.autograd.backward(yk, dys)
    # The plain version and its gradient in float32, rounded once.  In
    # bfloat16 the gradient is the plain version of the adjoint (negated
    # offsets), which sums in the kernel's order: autograd sums the shifted
    # cotangents in another order, and after cancellation the float32
    # results round to bfloat16 values more than one ulp apart.
    xp = [t.detach().float().requires_grad_(True) for t in xs]
    yp = th.halo_ring_plain(xp, offsets, mesh, r=r)
    torch.autograd.backward(yp, [d.float() for d in dys])
    gp = torch.cat([t.grad for t in xp])
    if x.dtype != torch.float32:
        gp = torch.cat(th.halo_ring_plain([d.float() for d in dys], [-o for o in offsets],
                                          mesh, r=r)).to(x.dtype)
    torch.cuda.synchronize()
    y = torch.cat(yk).detach()
    err = max(max_err_within_tolerance(torch, y, torch.cat(yp).detach().to(x.dtype)),
              max_err_within_tolerance(torch, torch.cat([t.grad for t in xk]), gp))
    exact = {"y": bool(torch.equal(y, circulant))}
    if x.dtype == torch.float32:
        check(exact["y"], f"{name} on {D} shards equals the circulant kernel bit for bit")
    else:
        max_err_within_tolerance(torch, y, circulant)
    if w is not None:
        ws = list(w.split(shard))
        yw = torch.cat(th.halo_banded_spmm(xs, ws, offsets, mesh))
        err = max(err, max_err_within_tolerance(
            torch, yw, torch.cat(th.halo_ring_plain(xs, offsets, mesh, ws=ws))))
        if x.dtype == torch.float32:
            exact["weighted"] = bool(torch.equal(yw, tb.banded_spmm(x, w, offsets)))
            check(exact["weighted"], f"weighted {name} on {D} shards equals K4 bit for bit")
    return err


def time_ring(torch, th, mesh, name, x, offsets, w=None, r=None) -> dict:
    """One shard's launch (shard 0, its tiles staged), the whole ring op,
    one shard's plain version, and for float32 K5 ``torch.sparse.mm`` of
    the shard's CSR operator [n_shard, n_shard + 2·Wp] on cat([pre, x,
    post]), the concat counted."""
    D, d = mesh.size, len(offsets)
    wp = th.padded_bandwidth(offsets)
    shard = x.shape[0] // D
    xs = list(x.split(shard))
    ws = None if w is None else list(w.split(shard))
    F = x.shape[1]
    views = xs if r is None else [t.view(shard // r, r * F) for t in xs]
    pre, post = th.halo_exchange(views, wp, mesh, None if r is None else F)[0]
    v0, w0 = views[0], None if ws is None else ws[0]
    m, L = v0.shape
    row = {"name": name, "shards": D, "n_shard": shard, "F": F, "r": r or 1, "L": L,
           "wp": wp, "weighted": w is not None, "dtype": str(x.dtype)[6:]}
    with torch.no_grad():
        row["ms"] = best_ms(torch, lambda: th._launch(v0, pre, post, offsets, w0))
        if w is not None:
            ring_op = lambda: th.halo_banded_spmm(xs, ws, offsets, mesh)  # noqa: E731
        elif r is None:
            ring_op = lambda: th.halo_banded_spmm_unit(xs, offsets, mesh)  # noqa: E731
        else:
            ring_op = lambda: th.halo_banded_spmm_unit_packed(xs, offsets, r, mesh)  # noqa: E731
        row["op_ms"] = best_ms(torch, ring_op)
        row["plain_ms"] = best_ms(
            torch, lambda: th.halo_banded_spmm_plain(v0, w0, pre, post, offsets))
        row["library_ms"] = row["library_max_abs_err"] = None
        if r is None and x.dtype == torch.float32:
            rows = torch.arange(m, device=x.device).repeat_interleave(d)
            cols = rows.view(m, d) + wp + torch.tensor(offsets, device=x.device)
            vals = torch.ones(m * d, device=x.device) if w0 is None else w0.reshape(-1)
            coo = torch.sparse_coo_tensor(torch.stack([rows, cols.reshape(-1)]), vals,
                                          (m, m + 2 * wp))
            csr = coo.coalesce().to_sparse_csr()
            lib = lambda: torch.sparse.mm(csr, torch.cat([pre, v0, post]))  # noqa: E731
            row["library_max_abs_err"] = float((lib() - th._launch(v0, pre, post, offsets, w0))
                                               .abs().max())
            row["library_ms"] = best_ms(torch, lib)
            del csr, coo, rows, cols, vals
    row["bound_ms"], row["bound_by"] = halo_bound(m, L, d, wp, x.element_size(), w is not None)
    log(f"  {name} {D} shards of [{m}, {L}] {row['dtype']}{' weighted' if w is not None else ''}:"
        f" shard launch {row['ms']:.4f} ms, ring op {row['op_ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, library {row['library_ms']} ms, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
    return row


def phase_kernels_halo(torch, th, tb, make_mesh, offsets, bench_offsets) -> dict:
    """K5 and K6 on rings of 1, 2 and 4 shards on the card."""
    log("== kernels: K5 halo_banded_spmm, K6 halo_banded_spmm_unit_packed")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(3)
    errors = {"K5": 0.0, "K6": 0.0}
    for D in (1, 2, 4):
        mesh = make_mesh(devices=["cuda:0"] * D)
        cases = [("K5", HALO_K5_N, 128, bench_offsets, True, None),
                 ("K5", HALO_PLAIN_SHARD * D, 128, offsets, False, None),
                 ("K5", HALO_PLAIN_SHARD * D, 3, offsets, False, None),
                 ("K6", GIANT_N, 16, offsets, False, 8)]
        for name, n, F, offs, weighted, r in cases:
            for dtype in (torch.float32, torch.bfloat16):
                x = torch.randn(n, F, generator=gen, device=dev).to(dtype)
                w = (torch.rand(n, len(offs), generator=gen, device=dev) + 0.5
                     if weighted else None)
                err = check_ring(torch, th, tb, mesh, name, x, offs, gen, w=w, r=r)
                errors[name] = max(errors[name], err)
                log(f"  {name} {D} shards n={n} F={F} r={r or 1} {str(dtype)[6:]}"
                    f"{' weighted' if weighted else ''}: fwd+grad max |err| {err:.3g}, "
                    f"{'equals' if dtype == torch.float32 else 'within one ulp of'} "
                    f"{'K3' if r else 'K2'}{' and K4' if weighted else ''} on the gathered array")
                del x, w
        torch.cuda.empty_cache()
    mesh = make_mesh(devices=["cuda:0"] * HALO_SHARDS)
    timings = []
    for name, n, F, offs, weighted, r, dtype in [
        ("K5", HALO_K5_N, 128, bench_offsets, True, None, torch.float32),
        ("K5", HALO_K5_N, 128, bench_offsets, True, None, torch.bfloat16),
        ("K5", HALO_PLAIN_SHARD * HALO_SHARDS, 128, offsets, False, None, torch.float32),
        ("K5", HALO_PLAIN_SHARD * HALO_SHARDS, 3, offsets, False, None, torch.float32),
        ("K6", GIANT_N, 16, offsets, False, 8, torch.bfloat16),
        ("K6", GIANT_N, 16, offsets, False, 8, torch.float32),
    ]:
        x = torch.randn(n, F, generator=gen, device=dev).to(dtype)
        w = torch.rand(n, len(offs), generator=gen, device=dev) + 0.5 if weighted else None
        timings.append(time_ring(torch, th, mesh, name, x, offs, w=w, r=r))
        del x, w
    torch.cuda.empty_cache()
    return {"max_abs_err": errors, "timings": timings}


def probe_timing(torch, name: str, case: str, kernel, plain, csr, rhs,
                 nbytes: float, ops: float) -> dict:
    """One probe kernel's row: the kernel, its plain version and
    ``torch.sparse.mm`` of the same operator (``csr`` on the float32
    ``rhs``) in ms, and the bound: the larger of bytes / 3.35 TB/s and
    operations / 67 TFLOP/s."""
    with torch.no_grad():
        row = {"name": name, "case": case, "ms": best_ms(torch, kernel),
               "plain_ms": best_ms(torch, plain)}
        row["library_max_abs_err"] = float((torch.sparse.mm(csr, rhs) - plain()).abs().max())
        row["library_ms"] = best_ms(torch, lambda: torch.sparse.mm(csr, rhs))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_OPS_PER_S * 1e3
    row["bound_ms"] = max(bytes_ms, ops_ms)
    row["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    log(f"  {name} {case}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
        f"sparse.mm {row['library_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
    return row


def check_probe(torch, got, ref, errors: dict, name: str) -> float:
    """A probe kernel against its plain version (float32, rtol = atol =
    1e-5); keeps the largest error under ``name``."""
    torch.cuda.synchronize()
    err = max_err_within_tolerance(torch, got, ref)
    errors[name] = max(errors.get(name, 0.0), err)
    return err


def phase_kernels_probes(torch, np, tpk, tb, tbell, micro, tgraph, probes) -> dict:
    """The probes' kernels against their plain versions at the probes'
    sizes, forward only, each timed at every shape.  bf16 x is held against
    the plain version on the same values widened to float32."""
    log("== kernels: probes P1-P5")
    gp, gp2, sp, pp, wpr = (probes[k] for k in ("gather_probe", "gather_probe2",
                                                "subblock_probe", "panel_ell_probe",
                                                "weighted_probe"))
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(4)
    F = gp.F
    errors, timings = {}, []

    # P1 at every (W, B), float32 and bf16 x; P2's d = 16 case
    tables = [(W, B, gp.block_table(W, B)) for W, B in gp.CONFIGS]
    tables.append((255, 256, gp2.block_table(255, 256, d=16)))
    for W, B, (_, lidx, n_use, Wp) in tables:
        d = lidx.shape[1]
        x = torch.randn(n_use, F, generator=gen, device=dev)
        li = torch.from_numpy(lidx).to(dev)
        w = torch.rand(n_use, d, generator=gen, device=dev) + 0.5
        rows = torch.arange(n_use, device=dev).repeat_interleave(d)
        cols = (torch.arange(n_use, device=dev) // B * B)[:, None] + li.long()
        csr = csr_rect(torch, rows, cols.reshape(-1), w.reshape(-1), (n_use, n_use + 2 * Wp))
        for dtype in (torch.float32, torch.bfloat16):
            xpad = gp.pad_rows(x, Wp).to(dtype)
            xf = xpad.float()
            y = tpk.window_gather(xpad, li, w, B, Wp)
            err = check_probe(torch, y, tpk.window_gather_plain(xf, li, w, B, Wp), errors,
                              "window_gather")
            case = f"W={W} B={B} d={d} {str(dtype)[6:]} x"
            log(f"  window_gather n={n_use} F={F} {case}: max |err| {err:.3g}")
            nbytes = (n_use + 2 * Wp) * F * xpad.element_size() + n_use * F * 4 + n_use * d * 8
            row = probe_timing(torch, "window_gather", case,
                               lambda: tpk.window_gather(xpad, li, w, B, Wp),
                               lambda: tpk.window_gather_plain(xpad, li, w, B, Wp),
                               csr, xf, nbytes, 2 * n_use * d * F)
            timings.append({**row, "W": W, "B": B, "d": d, "n": n_use, "F": F,
                            "dtype": str(dtype)[6:]})
        del x, li, w, csr, rows, cols, xpad, xf, y

    # P3 on K1's kernel and P4 on the panel tables, on the probes' two graphs
    n, d = MICRO_N, 8
    n_pad = tgraph.round_up(n, 2048)
    graphs = {W: micro._banded_regular_graph(n, d, W, n_pad=n_pad) for W, _ in pp.CONFIGS}
    for W, B, wp in sp.CONFIGS:
        sidx, w0, _, _ = sp.subblock_table(graphs[W], n, d)
        x = torch.randn(n_pad, F, generator=gen, device=dev)
        si = torch.from_numpy(sidx).to(dev)
        w = torch.from_numpy(w0).to(dev) * (torch.rand(n_pad, d, generator=gen, device=dev) + 0.5)
        y = tpk.subblock_spmm(x, si, w, n_pad, B, wp)
        err = check_probe(torch, y, tpk.subblock_spmm_plain(x, si, w, n_pad, B, wp), errors,
                          "subblock_spmm")
        log(f"  subblock_spmm n={n_pad} F={F} W={W} B={B} Wp={wp}: max |err| {err:.3g}")
        r0 = tbell.sub_block_rows(B)
        start = (torch.arange(n_pad, device=dev) // r0 * r0)[:, None]
        valid = (si.long() - start + wp) % n_pad < r0 + 2 * wp
        rows = torch.arange(n_pad, device=dev).repeat_interleave(d)
        csr = csr_rect(torch, rows, si.reshape(-1), (w * valid).reshape(-1), (n_pad, n_pad))
        row = probe_timing(torch, "subblock_spmm", f"W={W} B={B} Wp={wp}",
                           lambda: tpk.subblock_spmm(x, si, w, n_pad, B, wp),
                           lambda: tpk.subblock_spmm_plain(x, si, w, n_pad, B, wp),
                           csr, x, 2 * n_pad * F * 4 + n_pad * d * 8,
                           2 * int(valid.sum()) * F)
        timings.append({**row, "W": W, "B": B, "wp": wp, "n": n_pad, "F": F, "dtype": "float32"})
        del x, si, w, y, csr, rows, valid, start

    panel_ran = {W: 0 for W, _ in pp.CONFIGS}
    for W, wp in pp.CONFIGS:
        g = graphs[W]
        s = g.senders.numpy()[: int(g.n_edges)].astype(np.int64)
        r = g.receivers.numpy()[: int(g.n_edges)].astype(np.int64)
        B = pp.panel_block(g.bell_block)
        for W_P in pp.PANEL_SLOTS:
            idx, wgt, n_drop, _ = pp.build_panel_tables(
                s, r, np.ones_like(s, np.float32), n_pad, B, wp, W_P)
            if n_drop > pp.MAX_DROP * n * d:
                log(f"  panel_ell_spmm W={W} W_P={W_P}: skipped, drops {n_drop} edges")
                continue
            panel_ran[W] += 1
            x = torch.randn(n_pad, F, generator=gen, device=dev)
            ii = torch.from_numpy(idx).to(dev)
            wg = torch.from_numpy(wgt).to(dev) * (
                torch.rand(idx.shape, generator=gen, device=dev) + 0.5)
            y = tpk.panel_ell_spmm(x, ii, wg, n_pad, B, wp, W_P)
            err = check_probe(torch, y, tpk.panel_ell_spmm_plain(x, ii, wg, n_pad, B, wp, W_P),
                              errors, "panel_ell_spmm")
            log(f"  panel_ell_spmm n={n_pad} F={F} W={W} B={B} Wp={wp} W_P={W_P} "
                f"({idx.shape[1]} slots, {n_drop} edges dropped): max |err| {err:.3g}")
            valid = ii >= 0
            first = (torch.arange(n_pad, device=dev) // B * B - wp)[:, None]
            base = (torch.arange(idx.shape[1], device=dev) // W_P * tpk.PANEL)[None, :]
            cols = (first + base + ii) % n_pad
            rows = torch.arange(n_pad, device=dev)[:, None].expand_as(ii)
            csr = csr_rect(torch, rows[valid], cols[valid], wg[valid], (n_pad, n_pad))
            row = probe_timing(torch, "panel_ell_spmm", f"W={W} B={B} Wp={wp} W_P={W_P}",
                               lambda: tpk.panel_ell_spmm(x, ii, wg, n_pad, B, wp, W_P),
                               lambda: tpk.panel_ell_spmm_plain(x, ii, wg, n_pad, B, wp, W_P),
                               csr, x, 2 * n_pad * F * 4 + n_pad * idx.shape[1] * 8,
                               2 * int(valid.sum()) * F)
            timings.append({**row, "W": W, "B": B, "wp": wp, "W_P": W_P, "slots": idx.shape[1],
                            "n": n_pad, "F": F, "dtype": "float32"})
            del x, ii, wg, y, csr, rows, cols, valid
    check(all(panel_ran.values()), f"panel_ell_spmm ran at least one W_P for each W: {panel_ran}")

    # P5: banded_spmm_cols, and K4 on every row-major variant's weights
    offsets = wpr.probe_offsets()
    n5, D = wpr.N, len(offsets)
    x = torch.randn(n5, F, generator=gen, device=dev)
    w = torch.rand(n5, D, generator=gen, device=dev) + 0.5
    rows = torch.arange(n5, device=dev).repeat_interleave(D)
    cols = (rows.view(n5, D) + torch.tensor(offsets, device=dev)) % n5
    csr = csr_rect(torch, rows, cols.reshape(-1), w.reshape(-1), (n5, n5))
    nbytes, ops = 2 * n5 * F * 4 + n5 * D * 4, 2 * n5 * D * F
    for variant in wpr.VARIANTS:
        wv = wpr.variant_weights(w, variant)
        if variant == "cols":
            name = "banded_spmm_cols"
            fns = (lambda: tpk.banded_spmm_cols(x, wv, offsets),
                   lambda: tpk.banded_spmm_cols_plain(x, wv, offsets))
        else:
            name = "banded_spmm (P5b)"
            fns = (lambda: tb.banded_spmm(x, wv, offsets),
                   lambda: tb.banded_spmm_plain(x, wv, offsets))
        with torch.no_grad():
            err = check_probe(torch, fns[0](), fns[1](), errors, name)
        log(f"  P5 {variant} n={n5} F={F} D={D}: max |err| {err:.3g}")
        if variant in ("cols", "blockw"):
            row = probe_timing(torch, name, f"n={n5} F={F} D={D} {variant}", *fns, csr, x,
                               nbytes, ops)
            timings.append({**row, "n": n5, "F": F, "D": D, "dtype": "float32"})
    del x, w, rows, cols, csr
    torch.cuda.empty_cache()
    return {"max_abs_err": errors, "timings": timings, "panel_configs": panel_ran}


def phase_probes(torch, tpk, tb, tbell, probes) -> dict:
    """The five probe entry points at the JAX probes' sizes, each with the
    launch counters set to 0 just before it and read just after; checks
    the exact launch counts and each case's error."""
    log("== probes")
    calls = PROBE_ITERS + 3        # a correctness call, 2 warm-up calls, the timed calls
    out = {}
    for name, mod in probes.items():
        for counters in (tpk, tb, tbell):
            counters.reset_launches()
        t0 = time.perf_counter()
        res = mod.main(n=mod.N, iters=PROBE_ITERS, device="cuda")
        torch.cuda.synchronize()
        launches = {**tpk.LAUNCHES, **tb.LAUNCHES, **tbell.LAUNCHES}
        res["launches"] = launches
        res["seconds"] = time.perf_counter() - t0
        log(f"  {name}: {res['seconds']:.2f} s, launches {launches}")
        expect = {}
        if name in ("gather_probe", "gather_probe2"):
            expect["window_gather"] = len(res["block_ell"]) * calls
            per_config = len(mod.PRECISIONS) if name == "gather_probe" else 1
            check(len(res["block_ell"]) == len(mod.CONFIGS) * per_config,
                  f"{name} ran every configuration")
            for row in res["block_ell"]:
                limit = 1e-2 if row["x_dtype"] == "bfloat16" else 1e-6
                check(row["relerr"] <= limit, f"{name} W={row['W']} B={row['B']} d={row['d']} "
                      f"{row['x_dtype']} x: relerr {row['relerr']:.3g} <= {limit}")
        elif name == "subblock_probe":
            planned = sum(row["shipped_block"] is not None for row in res["configs"])
            expect.update(subblock_spmm=len(mod.CONFIGS) * calls,
                          window_gather=len(mod.CONFIGS) * calls,
                          block_ell_spmm=planned * calls)
            for row in res["configs"]:
                for design in ("sub-blocked", "whole window"):
                    check(row[design]["relerr"] <= 1e-5,
                          f"P3 W={row['W']} {design}: relerr {row[design]['relerr']:.3g}")
        elif name == "panel_ell_probe":
            panel = [row for row in res["rows"] if row["design"] == "panel-ELL"]
            shipped = [row for row in res["rows"] if row["design"] == "shipped"]
            check({row["W"] for row in panel} == {W for W, _ in mod.CONFIGS},
                  "P4 ran at least one W_P for each W")
            expect.update(panel_ell_spmm=len(panel) * calls, block_ell_spmm=len(shipped) * calls)
            for row in panel:
                check(row["relerr"] <= 1e-5, f"P4 W={row['W']} W_P={row['W_P']}: relerr "
                      f"{row['relerr']:.3g}")
        else:
            expect.update(banded_spmm_cols=calls, banded_spmm=(len(mod.VARIANTS) - 1) * calls,
                          banded_spmm_unit=PROBE_ITERS + 2)
            limits = {"mxu1": 1e-2, "mxuallbf16": 1e-2, "mxu2": 1e-4, "mxuall": 1e-4}
            for variant, row in res["variants"].items():
                limit = limits.get(variant, 1e-4 if variant.startswith("hybrid") else 1e-6)
                check(row["rel_err"] <= limit,
                      f"P5 {variant}: rel_err {row['rel_err']:.3g} <= {limit}")
        check(launches == {k: expect.get(k, 0) for k in launches},
              f"{name} launched {launches}, expected {expect} and nothing else")
        out[name] = res
    return out


def circulant_cut(torch, assignment, offsets) -> int:
    """Cut of a node-order assignment on the circulant graph: each positive
    offset s contributes the edges (i, i + s mod n)."""
    a = torch.from_numpy(assignment).cuda()
    return int(sum(int((a != torch.roll(a, -s)).sum()) for s in offsets if s > 0))


def phase_giant(torch, tb, giant) -> dict:
    log("== giant")
    small = dict(n=4096, bandwidth=31, epochs=4, agg_dtype=None, mu_dtype=None,
                 return_assignment=True)
    p0 = giant.packed_params(4096, seed=0, device="cpu")
    on_card = giant.train_banded_giant_packed(params=p0, device="cuda", **small)
    on_cpu = giant.train_banded_giant_packed(params=p0, device="cpu", **small)
    agree = float((on_card["assignment"] == on_cpu["assignment"]).mean())
    log(f"  small packed run, card vs CPU: history {on_card['history']} vs "
        f"{on_cpu['history']}, assignments agree on {agree:.6f}")
    torch.testing.assert_close(torch.tensor(on_card["history"]),
                               torch.tensor(on_cpu["history"]), rtol=1e-3, atol=0)
    check(agree >= 0.999, "small packed run: card and CPU assignments agree")

    torch.cuda.reset_peak_memory_stats()
    tb.reset_launches()
    res = giant.train_banded_giant_packed(epochs=GIANT_EPOCHS, return_assignment=True,
                                          device="cuda")
    launches = dict(tb.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cut = circulant_cut(torch, res["assignment"], res["offsets"])
    m = res["n"] // 8
    log(f"  packed n={res['n']} d={res['d']} offsets {res['offsets']}: epoch "
        f"{res['epoch_time_s'] * 1e3:.3f} ms (first {res['first_epoch_s']:.3f} s), "
        f"{res['edges_per_s_per_epoch']:.4g} edges/s, cut fraction {res['cut_fraction']:.5f} "
        f"(decoded {cut / res['edges']:.5f}), peak {peak_gb:.2f} GB, launches {launches}")
    check(launches["banded_spmm_unit_packed"] == 6 * GIANT_EPOCHS + 2,
          "K3 launched 6 times an epoch plus 2 for the decode")
    check(launches["banded_spmm_unit"] == 0, "the packed trainer runs no K2")
    check(all(map(math.isfinite, res["history"])), "finite loss history")
    check(res["cut_fraction"] >= 0.90, "packed cut fraction >= 0.90")
    check(cut / res["edges"] >= 0.90, "decoded assignment cuts >= 0.90 of the edges")
    check(res["assignment"].shape == (res["n"],)
          and list(res["assignment"][[0, m, 2 * m]]) == [0, 1, 2],
          "terminals keep their classes")

    tb.reset_launches()
    plain = giant.train_banded_giant(n=PLAIN_N, epochs=PLAIN_EPOCHS, device="cuda")
    plain_launches = dict(tb.LAUNCHES)
    log(f"  plain n={plain['n']}: epoch {plain['epoch_time_s'] * 1e3:.3f} ms, cut "
        f"{plain['initial_cut']:.0f} -> {plain['final_cut']:.0f} "
        f"(fraction {plain['cut_fraction']:.5f}), launches {plain_launches}")
    check(plain_launches["banded_spmm_unit"] == 6 * PLAIN_EPOCHS, "K2 launched 6 times an epoch")
    check(plain_launches["banded_spmm_unit_packed"] == 0, "the plain trainer runs no K3")
    check(plain["final_cut"] > plain["initial_cut"], "plain trainer improves the cut")
    for r in (res, plain):
        r.pop("history")
        r.pop("assignment", None)
    torch.cuda.empty_cache()
    return {"packed": {**res, "decoded_cut_fraction": cut / res["edges"],
                       "peak_memory_gb": peak_gb, "launches": launches},
            "plain": {**plain, "launches": plain_launches},
            "small_agreement": agree}


def phase_halo(torch, tb, th, tgb, giant, make_mesh, single_fraction: float) -> dict:
    """The node-sharded trainers on a ring of 4 shards on the card."""
    log("== halo")
    ring = make_mesh(devices=["cuda:0"] * HALO_SHARDS)
    small = tgb.PackedHaloGiantConfig(bandwidth=31, epochs=4, agg_dtype=None, mu_dtype=None)
    p0 = giant.packed_params(4096, seed=0, device="cpu")
    on_card = tgb.train_halo_giant_packed(1024, small, ring, params=p0, return_assignment=True)
    on_cpu = tgb.train_halo_giant_packed(1024, small, make_mesh(devices=["cpu"] * HALO_SHARDS),
                                         params=p0, return_assignment=True)
    agree = float((on_card["assignment"] == on_cpu["assignment"]).mean())
    log(f"  small packed run on 4 shards, card vs CPU ring: history {on_card['history']} vs "
        f"{on_cpu['history']}, assignments agree on {agree:.6f}")
    torch.testing.assert_close(torch.tensor(on_card["history"]),
                               torch.tensor(on_cpu["history"]), rtol=1e-3, atol=0)
    check(agree >= 0.999, "small packed halo run: card and CPU assignments agree")
    one = tgb.train_halo_giant_packed(4096, small, make_mesh(devices=["cuda:0"]), params=p0)
    single = giant.train_banded_giant_packed(n=4096, bandwidth=31, epochs=4, agg_dtype=None,
                                             mu_dtype=None, params=p0, device="cuda")
    one_rel = max(abs(a - b) / abs(b) for a, b in zip(one["history"], single["history"]))
    log(f"  1-shard ring vs the single-chip packed trainer: history {one['history']} vs "
        f"{single['history']}, largest relative difference {one_rel:.3g}")
    torch.testing.assert_close(torch.tensor(one["history"]), torch.tensor(single["history"]),
                               rtol=1e-3, atol=0)

    torch.cuda.reset_peak_memory_stats()
    tb.reset_launches()
    th.reset_launches()
    res = tgb.train_halo_giant_packed(HALO_PACKED_SHARD, tgb.PackedHaloGiantConfig(epochs=GIANT_EPOCHS),
                                      ring, return_assignment=True)
    launches = {**tb.LAUNCHES, **th.LAUNCHES}
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    cut = circulant_cut(torch, res["assignment"], res["offsets"])
    m = res["n"] // 8
    log(f"  packed halo n={res['n']} on {res['num_devices']} shards: epoch "
        f"{res['epoch_time_s'] * 1e3:.3f} ms (first {res['first_epoch_s']:.3f} s), "
        f"{res['edges_per_s_per_epoch']:.4g} edges/s, cut fraction {res['cut_fraction']:.5f} "
        f"(decoded {cut / res['edges']:.5f}; single-chip {single_fraction:.5f}), peak "
        f"{peak_gb:.2f} GB, launches {launches}")
    check(launches["halo_banded_spmm_unit_packed"] == 6 * HALO_SHARDS * GIANT_EPOCHS + 2 * HALO_SHARDS,
          "K6 launched 6 times an epoch on each shard, plus 2 each for the decode")
    check(all(v == 0 for k, v in launches.items() if k != "halo_banded_spmm_unit_packed"),
          "the packed halo trainer runs no K2, K3, K4 or K5")
    check(all(map(math.isfinite, res["history"])), "finite loss history")
    check(res["cut_fraction"] >= 0.90, "packed halo cut fraction >= 0.90")
    check(cut / res["edges"] >= 0.90, "decoded assignment cuts >= 0.90 of the edges")
    check(list(res["assignment"][[0, m, 2 * m]]) == [0, 1, 2], "terminals keep their classes")
    check(abs(res["cut_fraction"] - single_fraction) <= 0.005,
          "packed halo cut within 0.005 of the single-chip packed trainer's")

    tb.reset_launches()
    th.reset_launches()
    plain = tgb.train_halo_giant(HALO_PLAIN_SHARD, tgb.HaloGiantConfig(epochs=HALO_PLAIN_EPOCHS),
                                 ring)
    plain_launches = {**tb.LAUNCHES, **th.LAUNCHES}
    log(f"  plain halo n={plain['n']} on {plain['num_devices']} shards: epoch "
        f"{plain['epoch_time_s'] * 1e3:.3f} ms, cut {plain['initial_cut']:.0f} -> "
        f"{plain['final_cut']:.0f} (fraction {plain['cut_fraction']:.5f}), launches {plain_launches}")
    check(plain_launches["halo_banded_spmm"] == 6 * HALO_SHARDS * HALO_PLAIN_EPOCHS,
          "K5 launched 6 times an epoch on each shard")
    check(all(v == 0 for k, v in plain_launches.items() if k != "halo_banded_spmm"),
          "the plain halo trainer runs no other kernel")
    check(all(map(math.isfinite, plain["history"])), "finite loss history")
    check(plain["final_cut"] > plain["initial_cut"], "plain halo trainer improves the cut")
    for r in (res, plain):
        r.pop("history")
        r.pop("assignment", None)
    torch.cuda.empty_cache()
    return {"packed": {**res, "decoded_cut_fraction": cut / res["edges"], "peak_memory_gb": peak_gb,
                       "launches": launches, "single_chip_cut_fraction": single_fraction},
            "plain": {**plain, "launches": plain_launches},
            "small_agreement": agree, "one_shard_max_rel_diff": one_rel}


def phase_recipe(tb, run_pipeline) -> dict:
    log("== recipe")
    tb.reset_launches()
    res = run_pipeline(OUT_DIR / "chip_smoke_pipeline", device="cuda")
    launches = dict(tb.LAUNCHES)
    log(f"  {res['epochs_run']} epochs, {res['epoch_ms']:.3f} ms an epoch (training "
        f"{res['training_s']:.2f} s); avg cut simple {res['avg_simple_cut']:.2f}, "
        f"post-processed {res['avg_post_cut']:.2f}, randomized {res['avg_randomized_cut']:.2f}; "
        f"launches {launches}")
    # The JAX package's own pipeline on this configuration (python -m
    # gcn_maxcut_tpu pipeline, run on the CPU) decodes a post-processed
    # average cut of REFERENCE_POST_CUT and does not beat its randomized
    # baseline either, so the gate is the reference's cut, not the baseline.
    check(res["avg_post_cut"] > res["avg_simple_cut"],
          "post-processing improves on the argmax decode")
    check(res["avg_post_cut"] >= 0.98 * REFERENCE_POST_CUT,
          f"post-processed cut at least 98% of the JAX pipeline's {REFERENCE_POST_CUT}")
    res.pop("summary")
    res.pop("history")
    return {**res, "launches": launches}


def phase_locality(torch, np, tbell, tb, loc) -> dict:
    log("== locality")
    small = dict(n=4096, epochs=10)
    p0 = loc.locality_params(4096)
    on_card = loc.train_locality(params=p0, device="cuda", **small)
    on_cpu = loc.train_locality(params=p0, device="cpu", **small)
    agree = float((on_card["assignment"] == on_cpu["assignment"]).mean())
    log(f"  n=4096, card vs CPU: history {on_card['history']} vs {on_cpu['history']}, "
        f"assignments agree on {agree:.6f}")
    torch.testing.assert_close(torch.tensor(on_card["history"]),
                               torch.tensor(on_cpu["history"]), rtol=1e-3, atol=0)
    check(agree >= 0.999, "small locality run: card and CPU assignments agree")

    import scipy

    from gcn_maxcut_tpu_torch.data.reorder import rcm_permutation

    # this machine's relabeling, for tools/locality_reference.py --perm
    perm = rcm_permutation(loc.locality_spec(LOCALITY_N).edges, LOCALITY_N)
    np.save(OUT_DIR / "locality_rcm_perm.npy", perm)
    log(f"  SciPy {scipy.__version__} (its RCM relabels the graph; saved to "
        f"{OUT_DIR.name}/locality_rcm_perm.npy)")
    tbell.reset_launches()
    tb.reset_launches()
    res = loc.train_locality(n=LOCALITY_N, device="cuda")
    launches = {**tbell.LAUNCHES, **tb.LAUNCHES}
    ratio = res["final_cut"] / REFERENCE_LOCALITY_CUT
    log(f"  n={res['n']} (n_pad {res['n_pad']}, RCM bandwidth {res['rcm_bandwidth']}, B="
        f"{res['bell_block']}, Wp={res['bell_wp']}, width {res['bell_width']}, "
        f"{res['n_outliers']} outliers): {res['epochs_run']} epochs, {res['epoch_ms']:.3f} ms an "
        f"epoch (graph built in {res['build_s']:.2f} s on the host); cut {res['initial_cut']:.0f} -> "
        f"{res['final_cut']:.0f} (fraction {res['cut_fraction']:.5f}, {ratio:.5f} of the JAX "
        f"package's {REFERENCE_LOCALITY_CUT:.0f}); launches {launches}")
    # 4 a training epoch (conv1 and conv2, forward and backward), 2 for each
    # of the two decode forwards (initial and best parameters)
    check(launches["block_ell_spmm"] == 4 * res["epochs_run"] + 2 * 2,
          "K1 launched 4 times an epoch plus 2 for each decode")
    check(all(v == 0 for k, v in launches.items() if k != "block_ell_spmm"),
          "the locality trainer runs no banded kernel")
    check(all(map(math.isfinite, res["history"])), "finite loss history")
    check(res["final_cut"] > res["initial_cut"], "training improves the cut")
    check(res["cut_fraction"] > 2 / 3, "cut beats the (k-1)/k = 2/3 floor")
    check(res["graph_digest"] == REFERENCE_LOCALITY_GRAPH,
          f"the graph is the one the JAX reference trained on (digest {res['graph_digest']}, "
          f"reference {REFERENCE_LOCALITY_GRAPH}): rerun tools/locality_reference.py --perm "
          f"{OUT_DIR.name}/locality_rcm_perm.npy")
    check(abs(ratio - 1) <= 0.02, "cut within 2% of the JAX package's")
    res.pop("assignment")
    res.pop("history")
    torch.cuda.empty_cache()
    return {**res, "launches": launches, "reference_cut": REFERENCE_LOCALITY_CUT,
            "reference_graph": REFERENCE_LOCALITY_GRAPH, "small_agreement": agree}


def phase_microbench(tbell, tb, micro) -> dict:
    log("== microbench")
    tbell.reset_launches()
    tb.reset_launches()
    spmm = micro.bench_spmm(device="cuda")
    spmm_launches = {**tbell.LAUNCHES, **tb.LAUNCHES}
    log(f"  spmm n={spmm['n']} d={spmm['d']} F={spmm['feature_dim']}: banded-random on K1 "
        f"(B={spmm['bell_block']}, Wp={spmm['bell_wp']}) fwd {spmm['fwd_edges_per_s']:.4g} "
        f"edges/s ({spmm['fraction_of_roofline_fwd']:.4f} of roofline), fwd+bwd "
        f"{spmm['fwdbwd_edges_per_s']:.4g} ({spmm['fraction_of_roofline_fwdbwd']:.4f}); "
        f"expander gather fwd {spmm['expander_fwd_edges_per_s']:.4g} "
        f"({spmm['expander_fraction_of_roofline_fwd']:.4f}), fwd+bwd "
        f"{spmm['expander_fwdbwd_edges_per_s']:.4g} "
        f"({spmm['expander_fraction_of_roofline_fwdbwd']:.4f}), bf16 fwd "
        f"{spmm['expander_bf16_fwd_edges_per_s']:.4g}; launches {spmm_launches}")
    check(spmm_launches["block_ell_spmm"] == 3 * (2 + 10), "K1 launched 3 times a timed call")
    tbell.reset_launches()
    tb.reset_launches()
    banded = micro.bench_spmm_banded(device="cuda")
    banded_launches = {**tbell.LAUNCHES, **tb.LAUNCHES}
    banded["hbm_regime_fraction"] = (
        banded["hbm_regime_fwd_edges_per_s"] / banded["banded_roofline_edges_per_s"])
    banded["hbm_regime_weighted_fraction"] = (
        banded["hbm_regime_weighted_fwd_edges_per_s"] / banded["weighted_roofline_edges_per_s"])
    log(f"  banded n={banded['n']} W={banded['bandwidth']}: K2 fwd "
        f"{banded['fwd_edges_per_s']:.4g} edges/s ({banded['fraction_of_banded_roofline']:.4f} "
        f"of roofline), fwd+bwd {banded['fwdbwd_edges_per_s']:.4g}, K4 fwd "
        f"{banded['weighted_fwd_edges_per_s']:.4g} "
        f"({banded['weighted_fraction_of_banded_roofline']:.4f}); n={banded['hbm_regime_n']}: "
        f"K2 {banded['hbm_regime_fwd_edges_per_s']:.4g} ({banded['hbm_regime_fraction']:.4f}, "
        f"{banded['hbm_regime_gbps']:.1f} GB/s), K4 "
        f"{banded['hbm_regime_weighted_fwd_edges_per_s']:.4g} "
        f"({banded['hbm_regime_weighted_fraction']:.4f}); launches {banded_launches}")
    check(banded_launches["banded_spmm_unit"] == 3 * (2 + 30) + (2 + 10), "K2 launch count")
    check(banded_launches["banded_spmm"] == (2 + 30) + (2 + 10), "K4 launch count")
    fractions = [spmm[k] for k in spmm if "fraction" in k]
    fractions += [banded[k] for k in banded if "fraction" in k]
    check(all(0 < f <= 1 for f in fractions), "every roofline fraction in (0, 1]")
    return {"spmm": {**spmm, "launches": spmm_launches},
            "banded": {**banded, "launches": banded_launches}}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    if not (ROOT / "gcn_maxcut_tpu_torch" / "csrc").is_dir():
        print(f"chip_smoke: no gcn_maxcut_tpu_torch package beside {__file__}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from gcn_maxcut_tpu_torch import build
    from gcn_maxcut_tpu_torch.bench import giant_demo as giant
    from gcn_maxcut_tpu_torch.bench import locality as loc
    from gcn_maxcut_tpu_torch.bench import microbench as micro
    from gcn_maxcut_tpu_torch.cli import run_pipeline
    from gcn_maxcut_tpu_torch.core import graph as tgraph
    from gcn_maxcut_tpu_torch.device import resolve_device
    from gcn_maxcut_tpu_torch.experiments import (
        gather_probe,
        gather_probe2,
        panel_ell_probe,
        subblock_probe,
        weighted_probe,
    )
    from gcn_maxcut_tpu_torch.ops import banded as tb
    from gcn_maxcut_tpu_torch.ops import block_ell as tbell
    from gcn_maxcut_tpu_torch.ops import halo as th
    from gcn_maxcut_tpu_torch.ops import probe_kernels as tpk
    from gcn_maxcut_tpu_torch.ops import segment as seg
    from gcn_maxcut_tpu_torch.parallel import giant_banded as tgb
    from gcn_maxcut_tpu_torch.parallel.mesh import make_mesh

    resolve_device()                      # turns TF32 off
    OUT_DIR.mkdir(exist_ok=True)
    t_start = time.perf_counter()
    report = {"build": phase_build(build)}
    report["kernels"] = phase_kernels(torch, tb, giant.circulant_offsets(8, 63, 0),
                                      micro.banded_offsets(8, 63))
    report["kernels_k1"] = phase_kernels_block_ell(torch, np, tbell, seg, tgraph, micro, loc)
    report["kernels_k4"] = phase_kernels_weighted(torch, tb, micro.banded_offsets(8, 63))
    report["kernels_halo"] = phase_kernels_halo(torch, th, tb, make_mesh,
                                                giant.circulant_offsets(8, 63, 0),
                                                micro.banded_offsets(8, 63))
    probes = {"gather_probe": gather_probe, "gather_probe2": gather_probe2,
              "subblock_probe": subblock_probe, "panel_ell_probe": panel_ell_probe,
              "weighted_probe": weighted_probe}
    report["kernels_probes"] = phase_kernels_probes(torch, np, tpk, tb, tbell, micro, tgraph,
                                                    probes)
    report["probes"] = phase_probes(torch, tpk, tb, tbell, probes)
    report["giant"] = phase_giant(torch, tb, giant)
    report["halo"] = phase_halo(torch, tb, th, tgb, giant, make_mesh,
                                report["giant"]["packed"]["cut_fraction"])
    report["recipe"] = phase_recipe(tb, run_pipeline)
    report["locality"] = phase_locality(torch, np, tbell, tb, loc)
    report["microbench"] = phase_microbench(tbell, tb, micro)
    report["seconds"] = time.perf_counter() - t_start
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=float))

    rows = {t["name"]: t for t in report["kernels"]["timings"]
            if (t["name"], t["n"], t["F"], t["dtype"]) in
            {("K2", GIANT_N, 16, "float32"), ("K3", GIANT_N, 16, "bfloat16")}}
    rows["K1"] = next(t for t in report["kernels_k1"]["timings"]
                      if (t["case"], t["F"]) == ("locality", 64))
    rows["K4"] = next(t for t in report["kernels_k4"]["timings"]
                      if (t["n"], t["F"]) == (BANDED_N, 128))
    rows["K5"] = next(t for t in report["kernels_halo"]["timings"]
                      if (t["name"], t["n_shard"] * t["shards"], t["dtype"])
                      == ("K5", HALO_K5_N, "float32"))
    rows["K6"] = next(t for t in report["kernels_halo"]["timings"]
                      if (t["name"], t["dtype"]) == ("K6", "bfloat16"))
    for name in ("K5", "K6"):
        rows[name]["n"] = rows[name]["n_shard"]
    launches = {"K1": report["locality"]["launches"]["block_ell_spmm"],
                "K2": report["giant"]["plain"]["launches"]["banded_spmm_unit"],
                "K3": report["giant"]["packed"]["launches"]["banded_spmm_unit_packed"],
                "K4": report["microbench"]["banded"]["launches"]["banded_spmm"],
                "K5": report["halo"]["plain"]["launches"]["halo_banded_spmm"],
                "K6": report["halo"]["packed"]["launches"]["halo_banded_spmm_unit_packed"]}
    errors = {**report["kernels"]["max_abs_err"], "K1": report["kernels_k1"]["max_abs_err"],
              "K4": report["kernels_k4"]["max_abs_err"], **report["kernels_halo"]["max_abs_err"]}
    names = {"K1": "block_ell_spmm", "K2": "banded_spmm_unit",
             "K3": "banded_spmm_unit_packed", "K4": "banded_spmm",
             "K5": "halo_banded_spmm", "K6": "halo_banded_spmm_unit_packed"}
    replaces = {"K1": "gcn_maxcut_tpu/ops/pallas_block_ell.py:146",
                "K2": "gcn_maxcut_tpu/ops/pallas_banded.py:257",
                "K3": "gcn_maxcut_tpu/ops/pallas_banded.py:529",
                "K4": "gcn_maxcut_tpu/ops/pallas_banded.py:257",
                "K5": "gcn_maxcut_tpu/ops/pallas_halo.py:162",
                "K6": "gcn_maxcut_tpu/ops/pallas_halo.py:409"}
    kernels = [{
        "name": f"{name} {names[name]}", "route": "cuda",
        "source": BLOCK_ELL_SOURCE if name == "K1" else KERNEL_SOURCE,
        "replaces": replaces[name], "launches": launches[name],
        "max_abs_err": errors[name], "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"],
        "bound_ms": rows[name]["bound_ms"], "bound_by": rows[name]["bound_by"],
        "library_ms": rows[name]["library_ms"],
        "shape": [rows[name]["n"], rows[name]["F"]], "dtype": rows[name]["dtype"],
        **({"shards": rows[name]["shards"], "op_ms": rows[name]["op_ms"]}
           if name in ("K5", "K6") else {}),
    } for name in ("K1", "K2", "K3", "K4", "K5", "K6")]

    # the probes' rows: (label, wrapper, source, pallas_call, probe run,
    # launch counter, error key, timing case)
    probe_timings = report["kernels_probes"]["timings"]
    probe_errors = report["kernels_probes"]["max_abs_err"]
    for label, wrapper, source, replaced, run, counter, err_key, case in [
        ("P1", "window_gather", PROBE_SOURCE, "experiments/gather_probe.py:169", "gather_probe",
         "window_gather", "window_gather", "W=255 B=512 d=8 float32 x"),
        ("P2", "window_gather (bf16 x)", PROBE_SOURCE, "experiments/gather_probe2.py:92",
         "gather_probe2", "window_gather", "window_gather", "W=255 B=256 d=8 bfloat16 x"),
        ("P3", "subblock_spmm (K1's kernel)", BLOCK_ELL_SOURCE,
         "experiments/subblock_probe.py:123", "subblock_probe", "subblock_spmm",
         "subblock_spmm", "W=255 B=256 Wp=256"),
        ("P4", "panel_ell_spmm", PROBE_SOURCE, "experiments/panel_ell_probe.py:157",
         "panel_ell_probe", "panel_ell_spmm", "panel_ell_spmm", "W=255 B=256 Wp=256 W_P=4"),
        ("P5a", "banded_spmm_cols", PROBE_SOURCE, "experiments/weighted_probe.py:224",
         "weighted_probe", "banded_spmm_cols", "banded_spmm_cols", f"n={BANDED_N} F=128 D=8 cols"),
        ("P5b", "banded_spmm (K4 on w')", KERNEL_SOURCE, "experiments/weighted_probe.py:251",
         "weighted_probe", "banded_spmm", "banded_spmm (P5b)", f"n={BANDED_N} F=128 D=8 blockw"),
    ]:
        row = next(t for t in probe_timings if t["case"] == case)
        kernels.append({
            "name": f"{label} {wrapper}", "route": "cuda", "source": source,
            "replaces": replaced, "launches": report["probes"][run]["launches"][counter],
            "max_abs_err": probe_errors[err_key], "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"], "shape": [row["n"], row["F"]], "dtype": row["dtype"],
        })
    log(f"total {report['seconds']:.1f} s")
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
