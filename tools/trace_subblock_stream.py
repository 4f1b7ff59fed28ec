#!/usr/bin/env python3
"""Where the time of P3's ring (``csrc/subblock_stream.cu``) goes, by phase.

    python tools/trace_subblock_stream.py

Builds a copy of the kernel (under ``build/``) in which thread 0 of the
first blocks of column tile 0 reads ``clock64()`` at each phase of each
sub-block: the wait for its rows and table, the barrier after it, the slot
pass, its own sums, and the barrier that frees the slots.  Runs it at
``chip_smoke.py``'s P3 shapes (n = 100,352 at Wp = 256 and 512, n =
1,048,576 at Wp = 256; F = 128, d = 8, the shipped geometry), checks the
output bit for bit against the shipped kernel, and prints, for three
blocks, the SM cycles of the prologue and the median of each phase a
sub-block.  The clocks cost a few instructions a phase.  Needs a CUDA
device and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from gcn_maxcut_tpu_torch import build  # noqa: E402
from gcn_maxcut_tpu_torch.ops import probe_kernels as tpk  # noqa: E402

BLOCKS, SLOTS = 3, 1024          # traced blocks, clock slots a block
# (source text, text with the clock read added), in the order of the source
PROBES = [
    ("                       int ring_rows) {\n",
     "                       int ring_rows, long long* trace) {\n"
     "  long long* tr = (threadIdx.x == 0 && blockIdx.y == 0 && blockIdx.x < 3)\n"
     "                      ? trace + (size_t)blockIdx.x * 1024 : nullptr;\n"
     "  if (tr) tr[0] = clock64();\n"),
    ("    sstream_wait<1>();                            // sub-block j's group has landed\n"
     "    __syncthreads();\n",
     "    sstream_wait<1>();                            // sub-block j's group has landed\n"
     "    if (tr) tr[1 + 5 * j] = clock64();\n"
     "    __syncthreads();\n"
     "    if (tr) tr[2 + 5 * j] = clock64();\n"),
    ("                           __float_as_int(tw[e]));\n    }\n    __syncthreads();\n",
     "                           __float_as_int(tw[e]));\n    }\n    __syncthreads();\n"
     "    if (tr) tr[3 + 5 * j] = clock64();\n"),
    ("    base += r0;\n    if (base >= ring_rows) base -= ring_rows;\n"
     "    __syncthreads();                              // sub-block j's slots are free\n",
     "    if (tr) tr[4 + 5 * j] = clock64();\n"
     "    base += r0;\n    if (base >= ring_rows) base -= ring_rows;\n"
     "    __syncthreads();                              // sub-block j's slots are free\n"
     "    if (tr) tr[5 + 5 * j] = clock64();\n"),
    ("                              int, int, int, int, int, int);",
     "                              int, int, int, int, int, int, long long*);"),
    ("                                      int smem_bytes, void* stream) {",
     "                                      int smem_bytes, void* stream, void* trace) {"),
    ("      ring_rows);\n  return (int)cudaGetLastError();",
     "      ring_rows, static_cast<long long*>(trace));\n  return (int)cudaGetLastError();"),
]


def traced_library() -> ctypes.CDLL:
    src = (build.CSRC / "subblock_stream.cu").read_text()
    for old, new in PROBES:
        if src.count(old) != 1:
            raise RuntimeError(f"subblock_stream.cu no longer has the line to trace: {old!r}")
        src = src.replace(old, new)
    out = build.BUILD_DIR / "trace"
    out.mkdir(parents=True, exist_ok=True)
    (out / "subblock_trace.cu").write_text(src)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS[:-2], "-o", str(out / "libtrace.so"),
                    str(out / "subblock_trace.cu")], check=True)
    lib = ctypes.CDLL(str(out / "libtrace.so"))
    lib.subblock_stream_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [
        ctypes.c_void_p, ctypes.c_void_p]
    lib.subblock_stream_launch.restype = ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("trace_subblock_stream: needs a CUDA device", file=sys.stderr)
        return 1
    launch = traced_library().subblock_stream_launch
    rng = np.random.default_rng(12)
    F, D, R0 = 128, 8, 128
    for n, B, wp in ((100_352, 256, 256), (100_352, 512, 512), (1_048_576, 256, 256)):
        i = np.arange(n)[:, None]
        x = torch.randn(n, F, device="cuda", generator=torch.Generator("cuda").manual_seed(3))
        sidx = torch.from_numpy(((i + rng.integers(-wp + 1, wp, size=(n, D))) % n)
                                .astype(np.int32)).cuda()
        w = torch.from_numpy((rng.random((n, D)) + 0.5).astype(np.float32)).cuda()
        g = tpk.subblock_stream_shape(n, F, R0, wp, D, 4)
        out = torch.empty_like(x)
        trace = torch.zeros(BLOCKS * SLOTS, dtype=torch.int64, device="cuda")
        for _ in range(3):
            err = launch(x.data_ptr(), sidx.data_ptr(), w.data_ptr(), out.data_ptr(), n, F, D,
                         wp, R0, 4, g.strip, g.cols, g.ring_rows, g.threads, g.smem_bytes,
                         torch.cuda.current_stream().cuda_stream, trace.data_ptr())
            if err:
                raise RuntimeError(f"traced launch failed: CUDA error {err}")
        torch.cuda.synchronize()
        if not torch.equal(out, tpk.subblock_spmm(x, sidx, w, n, B, wp)):
            raise RuntimeError("the traced kernel differs from the shipped one")
        print(f"n={n} Wp={wp} (cols={g.cols}, threads={g.threads}, strip={g.strip}), "
              f"SM cycles:", flush=True)
        for b, t in enumerate(trace.view(BLOCKS, SLOTS).cpu().numpy()):
            steps = t[1:1 + 5 * g.strip].reshape(g.strip, 5)
            phase = {"wait": np.median(steps[1:, 0] - steps[:-1, 4]),
                     "barrier": np.median(steps[:, 1] - steps[:, 0]),
                     "slot pass": np.median(steps[:, 2] - steps[:, 1]),
                     "sums": np.median(steps[:, 3] - steps[:, 2]),
                     "end barrier": np.median(steps[:, 4] - steps[:, 3])}
            print(f"  block {b}: total {steps[-1, 4] - t[0]}, prologue {steps[0, 0] - t[0]}, "
                  f"a sub-block: " + ", ".join(f"{k} {v:.0f}" for k, v in phase.items()),
                  flush=True)
        del x, sidx, w, out
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
