#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``gcn_maxcut_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases; any failure ends the run with a non-zero exit code:

  1. build    compile every ``gcn_maxcut_tpu_torch/csrc/*.cu`` with nvcc for
              sm_90a (one nvcc per source, started together) and print the
              card's name and power limit;
  2. kernels  hold K2 (``banded_spmm_unit``, r = 1, F = 16 and 3) and K3
              (``banded_spmm_unit_packed``, r = 8, F = 16) against their
              plain PyTorch versions on the card, forward and gradient, in
              float32 and bfloat16, at the giant trainer's shapes and at
              small odd ones; time each beside its bound, its plain version
              and (K2) one cuDNN circular convolution;
  3. giant    the packed giant trainer at its defaults (n = 10,002,432,
              d = 8, bandwidth 63, bf16 aggregation and first moment, 40
              epochs) through K3, after a small run held against the CPU;
              then the plain-layout trainer at n = 1,048,576 through K2;
  4. recipe   the ``pipeline`` flow: 20 graphs of n = 500, d in [6, 8],
              padded to 1000, GCNSoftmax 1000-500-3, 300 epochs, decoded
              with 200 rollouts and held against the JAX pipeline's cut;
              the randomized baseline is printed beside it.

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

GIANT_N = 10_002_432
GIANT_EPOCHS = 40
PLAIN_N = 1_048_576
PLAIN_EPOCHS = 10
SMALL_CASES = [                 # (n, F, r, offsets): odd shapes and wrap edges
    (296, 3, 8, (1, -1, 7, -7)),
    (400, 20, 8, (2, -5, 6)),
    (1024, 16, 8, (63, -63, 1, -1)),
]
# The JAX package's pipeline at the recipe's defaults (seed 1000), decoded
# on the same held-out graphs: argmax 1205.0, post-processed 1238.6,
# randomized baseline 1253.8 (average cuts).
REFERENCE_POST_CUT = 1238.6


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


def phase_kernels(torch, tb, offsets: tuple[int, ...]) -> dict:
    """Kernel against plain version, forward and gradient; then timings."""
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
             ("K3", GIANT_N, 16, 8, offsets)]
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
    from gcn_maxcut_tpu_torch import build
    from gcn_maxcut_tpu_torch.bench import giant_demo as giant
    from gcn_maxcut_tpu_torch.cli import run_pipeline
    from gcn_maxcut_tpu_torch.device import resolve_device
    from gcn_maxcut_tpu_torch.ops import banded as tb

    resolve_device()                      # turns TF32 off
    OUT_DIR.mkdir(exist_ok=True)
    t_start = time.perf_counter()
    report = {"build": phase_build(build)}
    report["kernels"] = phase_kernels(torch, tb, giant.circulant_offsets(8, 63, 0))
    report["giant"] = phase_giant(torch, tb, giant)
    report["recipe"] = phase_recipe(tb, run_pipeline)
    report["seconds"] = time.perf_counter() - t_start
    (OUT_DIR / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=float))

    rows = {t["name"]: t for t in report["kernels"]["timings"]
            if (t["name"], t["n"], t["F"], t["dtype"]) in
            {("K2", GIANT_N, 16, "float32"), ("K3", GIANT_N, 16, "bfloat16")}}
    launches = {"K2": report["giant"]["plain"]["launches"]["banded_spmm_unit"],
                "K3": report["giant"]["packed"]["launches"]["banded_spmm_unit_packed"]}
    replaces = {"K2": "gcn_maxcut_tpu/ops/pallas_banded.py:257",
                "K3": "gcn_maxcut_tpu/ops/pallas_banded.py:529"}
    kernels = [{
        "name": f"{name} {'banded_spmm_unit' if name == 'K2' else 'banded_spmm_unit_packed'}",
        "route": "cuda", "source": KERNEL_SOURCE, "replaces": replaces[name],
        "launches": launches[name], "max_abs_err": report["kernels"]["max_abs_err"][name],
        "ms": rows[name]["ms"], "plain_ms": rows[name]["plain_ms"],
        "bound_ms": rows[name]["bound_ms"], "bound_by": rows[name]["bound_by"],
        "library_ms": rows[name]["library_ms"],
        "shape": [rows[name]["n"], rows[name]["F"]], "dtype": rows[name]["dtype"],
    } for name in ("K2", "K3")]
    log(f"total {report['seconds']:.1f} s")
    log(card_line())
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
