// Block-ELL SpMM as a direct gather, for Hopper (sm_90a): K1.
//
// Replaces the TPU kernel gcn_maxcut_tpu/ops/pallas_block_ell.py::_block_ell_kernel
// (pallas_call in _kernel_call).  For a locality-reordered graph planned by
// plan_block_ell it computes
//   out[i, c] = sum_j w[i, j] * x[sidx[i, j], c]      (j = 0 .. width-1)
// over the plan's compact table, skipping every slot whose sender lies
// outside the receiver's slice.  The outlier COO correction is added after
// this kernel by the caller (a PyTorch index_add_, as it was an XLA scatter
// outside the Pallas kernel).
//
// The planner guarantees that every real table edge of a receiver in row
// sub-block s (rows [s*R0, s*R0 + R0)) has its sender in the slice of rows
// [s*R0 - Wp, s*R0 + R0 + Wp), taken mod n.  Padding slots hold sender n-1
// with weight 0 and may lie outside it: those are skipped, as on the TPU
// their one-hot row matched no window column.
//
// Bound on this card: bytes.  The function reads x once, the [n, width]
// int32 + float32 tables once and writes y once: 2*n*F*4 + n*width*8
// bytes, against 2*n*width*F float operations.  At the locality trainer's
// shape (n = 100,352, F = 64, width 8) that is ~58 MB, ~0.017 ms at
// 3.35 TB/s.
//
// Design.  Nothing is staged: staging an R0 + 2*Wp slice for each 128-row
// sub-block would re-read x 4-6x at the planner's Wp, and the staging
// would not overlap the sums.  A thread owns one receiver row and VEC adjacent
// columns and loads each in-slice sender's VEC values straight from
// L2/device memory (16-byte __ldg when F % 4 == 0, VEC = 4; else the
// scalar path, VEC = 1, for the locality trainer's F = 3).  The slice keeps
// a block's senders within a few hundred rows, so x is read from device
// memory about once and the width-fold reuse is served by L2: at the
// trainer's sizes x (1.2-51 MB) fits the 50 MB L2.  A shared-memory ring
// that streamed each strip's rows once (the design of banded_stream.cu)
// lost to this gather at every K1 shape measured (PERF.md): its saved
// reads were L2 hits, and its 2*Wp-row prologue preceded every strip.
//
// Sums are float32 in slot order from 0 with separate multiply and add
// roundings: the order and the arithmetic of the plain PyTorch version
// (ops/block_ell.py _ell_sum_exact), so results agree with it bit for bit.
// No TMA or wgmma: no matrix product, nothing staged.

#include <cuda_runtime.h>
#include <stdint.h>

#define BELL_GATHER_THREADS 256

template <int VEC>
__global__ void __launch_bounds__(BELL_GATHER_THREADS)
block_ell_gather_kernel(const float* __restrict__ x,
                        const int* __restrict__ sidx,
                        const float* __restrict__ w, float* __restrict__ out,
                        int n, int F, int width, int Wp, int r0) {
  const int groups = F / VEC;
  const int64_t idx = (int64_t)blockIdx.x * BELL_GATHER_THREADS + threadIdx.x;
  if (idx >= (int64_t)n * groups) return;
  const int i = (int)(idx / groups);
  const int col = (int)(idx - (int64_t)i * groups) * VEC;
  const int row0 = i / r0 * r0;
  const int slice_rows = r0 + 2 * Wp;
  float acc[VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
#pragma unroll 4
  for (int jj = 0; jj < width; ++jj) {
    const int s = __ldg(sidx + (int64_t)i * width + jj);
    // the sender's row in its receiver's slice, from its absolute id mod n
    int l = s - row0 + Wp;
    if (l < 0) {
      l += n;
    } else if (l >= n) {
      l -= n;
    }
    if ((unsigned)l < (unsigned)slice_rows) {
      const float wk = __ldg(w + (int64_t)i * width + jj);
      const float* src = x + (int64_t)s * F + col;
      if (VEC == 4) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(src));
        acc[0] = __fadd_rn(acc[0], __fmul_rn(wk, v.x));
        acc[1] = __fadd_rn(acc[1], __fmul_rn(wk, v.y));
        acc[2] = __fadd_rn(acc[2], __fmul_rn(wk, v.z));
        acc[3] = __fadd_rn(acc[3], __fmul_rn(wk, v.w));
      } else {
        acc[0] = __fadd_rn(acc[0], __fmul_rn(wk, __ldg(src)));
      }
    }
  }
  float* dst = out + (int64_t)i * F + col;
  if (VEC == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  } else {
    dst[0] = acc[0];
  }
}

// Plain C entry point of K1, bound with ctypes.  x [n, F] f32, sidx
// [n, width] int32, w [n, width] f32, out [n, F] f32, all contiguous on the
// device.  vec and blocks come from ops/block_ell.py gather_shape: vec 4
// needs F % 4 == 0 and 16-byte aligned x and out, and the blocks of
// BELL_GATHER_THREADS threads must cover n * F / vec threads.  Returns the
// cudaError_t of the launch (0 on success).
extern "C" int block_ell_gather_launch(const void* x, const void* sidx,
                                       const void* w, void* out, int n, int F,
                                       int width, int Wp, int r0, int vec,
                                       int blocks, void* stream) {
  if (n < 1 || F < 1 || width < 1 || Wp < 0 || r0 < 1 || n % r0 ||
      r0 + 2 * Wp > n || (vec != 1 && vec != 4) ||
      (vec == 4 && (F % 4 || (((uintptr_t)x | (uintptr_t)out) & 15))) ||
      blocks < 1 || (int64_t)blocks * BELL_GATHER_THREADS < (int64_t)n * (F / vec)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int* si = static_cast<const int*>(sidx);
  const float* wf = static_cast<const float*>(w);
  float* of = static_cast<float*>(out);
  if (vec == 4) {
    block_ell_gather_kernel<4><<<blocks, BELL_GATHER_THREADS, 0, s>>>(
        xf, si, wf, of, n, F, width, Wp, r0);
  } else {
    block_ell_gather_kernel<1><<<blocks, BELL_GATHER_THREADS, 0, s>>>(
        xf, si, wf, of, n, F, width, Wp, r0);
  }
  return (int)cudaGetLastError();
}
