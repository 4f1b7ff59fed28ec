#!/usr/bin/env python3
"""Launch geometries of P3's ring (``csrc/subblock_stream.cu``) on the card.

    python tools/sweep_subblock_stream.py

At the probe's n = 100,352, F = 128, d = 8 and both P3 configurations
(Wp = 256 and 512, 128-row sub-blocks), and past the L2 at n = 1,048,576
(Wp = 256, the table of ``chip_smoke.py``'s past-L2 row), times the ring at the geometry
``ops/probe_kernels.subblock_stream_shape`` ships and at other column
tiles (16, 32 and 64 columns where the ring fits), 256 or 512 threads a
block, and strip lengths (one and two waves of blocks), in turns: best of 15 CUDA-event timings, two rounds.  Every geometry's output
is held bit for bit to the shipped one's.  Prints the card's name and
power limit and one JSON object; a line for each geometry whose blocks an
SM differ on the card (``subblock_stream_blocks_per_sm``) from the count
the strip was chosen by.  Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import math
import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gcn_maxcut_tpu_torch.ops import probe_kernels as tpk  # noqa: E402

F, D, R0 = 128, 8, 128
CONFIGS = ((100_352, 256), (100_352, 512), (1_048_576, 256))     # (n, Wp)


def best_ms(fn, reps: int = 15, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
             for _ in range(reps)]
    torch.cuda.synchronize()
    torch.cuda._sleep(10_000_000)
    for start, end in pairs:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return min(s.elapsed_time(e) for s, e in pairs)


def launch(x, sidx, w, wp, cols, threads, strip):
    N = x.shape[0]
    ring_rows = 2 * R0 + 2 * wp
    smem = tpk.subblock_stream_smem_bytes(ring_rows, cols, R0, D)
    out = torch.empty_like(x)
    err = tpk._fn("subblock_stream_launch", (tpk._P,) * 4 + (tpk._I,) * 11 + (tpk._P,),
                  "subblock_stream")(
        x.data_ptr(), sidx.data_ptr(), w.data_ptr(), out.data_ptr(), N, F, D, wp, R0, 4,
        strip, cols, ring_rows, threads, smem, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"subblock_stream_launch failed: CUDA error {err}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_subblock_stream: needs a CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          check=True, capture_output=True, text=True).stdout.strip()
    rng = np.random.default_rng(12)
    result = {"card": card, "F": F, "d": D, "configs": []}
    for N, wp in CONFIGS:
        i = np.arange(N)[:, None]
        x = torch.randn(N, F, device="cuda", generator=torch.Generator("cuda").manual_seed(3))
        sidx = torch.from_numpy(((i + rng.integers(-wp + 1, wp, size=(N, D))) % N)
                                .astype(np.int32)).cuda()
        w = torch.from_numpy((rng.random((N, D)) + 0.5).astype(np.float32)).cuda()
        shipped = tpk.subblock_stream_shape(N, F, R0, wp, D, 4)
        ref = launch(x, sidx, w, wp, shipped.cols, shipped.threads, shipped.strip)
        cases = {}
        for cols in (16, 32, 64):
            smem = tpk.subblock_stream_smem_bytes(2 * R0 + 2 * wp, cols, R0, D)
            if smem > tpk.SMEM_LIMIT:
                continue
            for threads in (256, 512):
                per_sm = min(tpk.SM_SMEM // (smem + tpk.SM_BLOCK_RESERVED), 2048 // threads)
                occ = ctypes.c_int(0)
                err = tpk._fn("subblock_stream_blocks_per_sm", (tpk._I,) * 3 + (tpk._P,),
                              "subblock_stream")(4, threads, smem, ctypes.addressof(occ))
                if err:
                    raise RuntimeError(f"subblock_stream_blocks_per_sm failed: CUDA error {err}")
                if occ.value != per_sm:
                    print(f"n={N} Wp={wp} cols={cols} threads={threads}: "
                          f"{occ.value} blocks an SM on the card, {per_sm} counted", flush=True)
                    per_sm = occ.value
                wave = tpk.SM_COUNT * per_sm // (F // cols)
                for waves in (1, 2):
                    strip = -(-(N // R0) // (wave * waves))
                    name = (f"cols={cols} threads={threads} strip={strip} "
                            f"({per_sm}/SM, {waves} wave(s))")
                    cases[name] = (cols, threads, strip)
        for name, geom in cases.items():
            if not torch.equal(launch(x, sidx, w, wp, *geom), ref):
                raise RuntimeError(f"n={N} Wp={wp} {name}: differs from the shipped geometry")
        best = {name: math.inf for name in cases}
        for _ in range(2):
            for name, geom in cases.items():
                best[name] = min(best[name], best_ms(lambda: launch(x, sidx, w, wp, *geom)))
        shipped_name = f"cols={shipped.cols} threads={shipped.threads} strip={shipped.strip}"
        print(f"n={N} Wp={wp} shipped: {shipped_name}")
        for name, ms in sorted(best.items(), key=lambda kv: kv[1]):
            print(f"n={N} Wp={wp} {name}: {ms:.4f} ms", flush=True)
        result["configs"].append({"n": N, "wp": wp, "shipped": shipped_name, "ms": best})
        del x, sidx, w, ref
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
