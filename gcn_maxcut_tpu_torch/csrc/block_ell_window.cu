// Block-ELL SpMM over staged row slices, for Hopper (sm_90a): K1.
//
// Replaces the TPU kernel gcn_maxcut_tpu/ops/pallas_block_ell.py::_block_ell_kernel
// (pallas_call in _kernel_call).  It computes, for a locality-reordered
// graph planned by plan_block_ell,
//   out[i, c] = sum_j w[i, j] * x[sidx[i, j], c]      (j = 0 .. width-1)
// over the plan's compact table, skipping every slot whose sender lies
// outside the receiver's slice.  The outlier COO correction is added after
// this kernel by the caller (a PyTorch index_add_, as it was an XLA scatter
// outside the Pallas kernel).
//
// The planner guarantees that every real table edge of a receiver in row
// sub-block s (rows [s*R0, s*R0 + R0)) has its sender in the slice of rows
// [s*R0 - Wp, s*R0 + R0 + Wp), taken mod n.  Padding slots hold sender n-1
// with weight 0 and may lie outside it: those are skipped (on the TPU their
// one-hot row matched no window column), so no load leaves the slice.
//
// Bound on this card: bytes.  The function reads x once, the [n, width]
// int32 + float32 tables once and writes y once: 2*n*F*4 + n*width*8
// bytes, against 2*n*width*F float operations.  At the microbenchmark's
// shape (n = 100,352, F = 128, width 8) that is ~0.11 GB, ~0.032 ms at
// 3.35 TB/s, while the operations need ~3 us at 67 TFLOP/s.
//
// Design (simple and right first): one block per (R0-row sub-block, column
// tile of Fc columns).  It stages the [R0 + 2*Wp, Fc] slice of x in shared
// memory with coalesced loads (wrap rows included), then each thread sums
// its (row, column) outputs over the row's table slots in slot order, in
// float32, with separate multiply and add roundings: the order and the
// arithmetic of the plain PyTorch version (_ell_sum_exact), so results
// agree with it bit for bit.  Neighbouring threads take neighbouring
// columns of one row: the table entry is one broadcast load and the slice
// reads are conflict-free.  Fc is chosen by the caller so that the slice
// fits the shared-memory budget.  The slice re-reads 2*Wp halo rows per
// R0 rows; those mostly hit L2.  No TMA or wgmma: no matrix product here.
//
// Latency: a block's ~96 KB slice lets two blocks share an SM, so blocks
// have 1024 threads (the SM's full 2048), and the staging loop keeps
// BELL_UNROLL loads in flight per thread before it stores them.

#include <cuda_runtime.h>
#include <stdint.h>

#define BELL_THREADS 1024
#define BELL_UNROLL 4

__global__ void __launch_bounds__(BELL_THREADS)
block_ell_window_kernel(const float* __restrict__ x,
                        const int* __restrict__ sidx,
                        const float* __restrict__ w, float* __restrict__ out,
                        int n, int F, int width, int Wp, int r0, int fc) {
  extern __shared__ __align__(16) float bell_slice[];

  const int row0 = blockIdx.x * r0;
  const int c0 = blockIdx.y * fc;
  const int cols = min(fc, F - c0);
  const int slice_rows = r0 + 2 * Wp;

  // Stage the slice.  Slice row t holds source row q = row0 - Wp + t; the
  // caller guarantees r0 + 2*Wp <= n, so one wrap brings q into [0, n).
  const int staged = slice_rows * cols;
  for (int base = threadIdx.x; base < staged; base += BELL_UNROLL * blockDim.x) {
    float v[BELL_UNROLL];
    int dst[BELL_UNROLL];
#pragma unroll
    for (int u = 0; u < BELL_UNROLL; ++u) {
      const int idx = base + u * blockDim.x;
      dst[u] = -1;
      if (idx < staged) {
        const int t = idx / cols;
        const int cl = idx - t * cols;
        int q = row0 - Wp + t;
        if (q < 0) {
          q += n;
        } else if (q >= n) {
          q -= n;
        }
        v[u] = x[(int64_t)q * F + c0 + cl];
        dst[u] = t * fc + cl;
      }
    }
#pragma unroll
    for (int u = 0; u < BELL_UNROLL; ++u) {
      if (dst[u] >= 0) bell_slice[dst[u]] = v[u];
    }
  }
  __syncthreads();

  for (int idx = threadIdx.x; idx < r0 * cols; idx += blockDim.x) {
    const int i = idx / cols;
    const int cl = idx - i * cols;
    const int64_t gi = (int64_t)row0 + i;
    const int* srow = sidx + gi * width;
    const float* wrow = w + gi * width;
    float acc = 0.0f;
#pragma unroll 4
    for (int j = 0; j < width; ++j) {
      // local slice row of the sender, from its absolute id mod n
      int l = __ldg(srow + j) - row0 + Wp;
      if (l < 0) {
        l += n;
      } else if (l >= n) {
        l -= n;
      }
      if ((unsigned)l < (unsigned)slice_rows) {
        acc = __fadd_rn(acc, __fmul_rn(__ldg(wrow + j), bell_slice[l * fc + cl]));
      }
    }
    out[gi * F + c0 + cl] = acc;
  }
}

// Plain C entry point, bound with ctypes.  x [n, F] f32, sidx [n, width]
// int32, w [n, width] f32, out [n, F] f32, all contiguous on the device.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int block_ell_window_launch(const void* x, const void* sidx,
                                       const void* w, void* out, int n, int F,
                                       int width, int Wp, int r0, int fc,
                                       void* stream) {
  if (n < 1 || F < 1 || width < 1 || Wp < 0 || r0 < 1 || fc < 1 ||
      n % r0 != 0 || r0 + 2 * Wp > n) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)(r0 + 2 * Wp) * fc * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        block_ell_window_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid(n / r0, (F + fc - 1) / fc);
  block_ell_window_kernel<<<grid, BELL_THREADS, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(sidx),
      static_cast<const float*>(w), static_cast<float*>(out), n, F, width, Wp,
      r0, fc);
  return (int)cudaGetLastError();
}
