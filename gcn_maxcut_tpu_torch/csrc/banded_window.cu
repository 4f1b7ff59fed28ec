// Unit-weight banded (circulant) SpMM over row windows, for Hopper (sm_90a).
//
// Replaces the TPU kernel gcn_maxcut_tpu/ops/pallas_banded.py::_fused_window_kernel
// on its unit path, in both of its uses:
//   * K2, _banded_spmm_unit_raw: y[i] = sum_k x[(i + o_k) mod n] on [n, F];
//   * K3, _banded_spmm_unit_packed_raw: the same sum on arrays stored in the
//     interleaved node order, viewed as [m, L = r*F].  A node shift is then a
//     row shift, and rows that wrap past either end of the array read their
//     source with the lane groups rotated by F (the wrap_lo / wrap_hi tiles of
//     the TPU version, read here in place instead of staged).
//
// One body serves both: out[i, c] = sum_k src(i + o_k, c) on an [m, L]
// row-major array, where
//   src(q, c) = x[q, c]                      for 0 <= q < m,
//   src(q, c) = x[q + m, (c - F) mod L]      for q < 0,
//   src(q, c) = x[q - m, (c + F) mod L]      for q >= m.
// With r = 1 (F = L) the rotation is the identity and the kernel is K2.
//
// Bound on this card: bytes.  The function reads x once and writes y once,
// 2*m*L*sizeof(T) bytes, against m*L*d float adds; at the packed giant
// trainer's shape (n = 10,002,432, F = 16, bf16) that is ~0.64 GB per call,
// ~0.19 ms at 3.35 TB/s, while the adds need ~19 us at 67 TFLOP/s.
//
// Design (simple and right first): each block owns a tile of rows and up to
// 128 columns.  It stages the [rows + 2*Wp, cols] window, wrap rows included,
// in shared memory once, so every x element is read from device memory about
// (rows + 2*Wp) / rows times (the halo re-reads mostly hit L2), and each
// thread then sums the d shifted rows of its columns from shared memory in
// float.  Offsets arrive by value in a small struct.  Accumulation is f32 in
// offset order starting from 0, the order of the plain PyTorch version, so
// f32 results agree bit for bit and bf16 results agree after the one final
// rounding.  No TMA or wgmma: there is no matrix product here, and
// asynchronous staging is work for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define BANDED_MAX_OFFSETS 32
#define BANDED_THREADS 256

struct BandedOffsets {
  int n;
  int o[BANDED_MAX_OFFSETS];
};

__device__ __forceinline__ float banded_to_f32(float v) { return v; }
__device__ __forceinline__ float banded_to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void banded_store(float* p, float v) { *p = v; }
__device__ __forceinline__ void banded_store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(BANDED_THREADS)
banded_window_kernel(const T* __restrict__ x, T* __restrict__ out, int m,
                     int L, int F, int Wp, int tile_rows, int tile_cols,
                     BandedOffsets offs) {
  extern __shared__ __align__(16) unsigned char banded_smem[];
  T* win = reinterpret_cast<T*>(banded_smem);

  const int r0 = blockIdx.x * tile_rows;
  const int c0 = blockIdx.y * tile_cols;
  const int rows = min(tile_rows, m - r0);
  const int cols = min(tile_cols, L - c0);
  const int win_rows = rows + 2 * Wp;

  // Stage the window.  Window row t holds source row q = r0 - Wp + t; the
  // caller guarantees 2*Wp <= m, so a wrapped row lies inside [0, m).
  for (int idx = threadIdx.x; idx < win_rows * cols; idx += blockDim.x) {
    const int t = idx / cols;
    const int cl = idx - t * cols;
    const int q = r0 - Wp + t;
    const int c = c0 + cl;
    int64_t src;
    if (q < 0) {
      int cc = c - F;
      if (cc < 0) cc += L;
      src = (int64_t)(q + m) * L + cc;
    } else if (q >= m) {
      int cc = c + F;
      if (cc >= L) cc -= L;
      src = (int64_t)(q - m) * L + cc;
    } else {
      src = (int64_t)q * L + c;
    }
    win[t * tile_cols + cl] = x[src];
  }
  __syncthreads();

  // Neighbouring threads take neighbouring columns of one row: conflict-free
  // shared reads and coalesced stores.
  for (int idx = threadIdx.x; idx < rows * cols; idx += blockDim.x) {
    const int i = idx / cols;
    const int cl = idx - i * cols;
    float acc = 0.0f;
    for (int k = 0; k < offs.n; ++k) {
      acc += banded_to_f32(win[(i + Wp + offs.o[k]) * tile_cols + cl]);
    }
    banded_store(&out[(int64_t)(r0 + i) * L + c0 + cl], acc);
  }
}

template <typename T>
static int banded_window_launch_t(const void* x, void* out, int m, int L,
                                  int F, int Wp, int tile_rows, int tile_cols,
                                  const BandedOffsets& offs,
                                  cudaStream_t stream) {
  const size_t smem = (size_t)(tile_rows + 2 * Wp) * tile_cols * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        banded_window_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((m + tile_rows - 1) / tile_rows, (L + tile_cols - 1) / tile_cols);
  banded_window_kernel<T><<<grid, BANDED_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(out), m, L, F, Wp, tile_rows,
      tile_cols, offs);
  return (int)cudaGetLastError();
}

// Plain C entry point, bound with ctypes.  dtype: 0 = float32, 1 = bfloat16.
// Returns the cudaError_t of the launch (0 on success).  The caller checks
// shapes: |o_k| <= Wp, 2*Wp <= m, 1 <= F <= L, tile_cols <= L.
extern "C" int banded_window_launch(const void* x, void* out, int m, int L,
                                    int F, const int* offsets, int n_offsets,
                                    int Wp, int dtype, int tile_rows,
                                    int tile_cols, void* stream) {
  if (n_offsets < 1 || n_offsets > BANDED_MAX_OFFSETS || m < 1 || L < 1 ||
      F < 1 || F > L || tile_rows < 1 || tile_cols < 1 || 2 * Wp > m) {
    return (int)cudaErrorInvalidValue;
  }
  BandedOffsets offs;
  offs.n = n_offsets;
  for (int k = 0; k < n_offsets; ++k) {
    if (offsets[k] > Wp || offsets[k] < -Wp) return (int)cudaErrorInvalidValue;
    offs.o[k] = offsets[k];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return banded_window_launch_t<float>(x, out, m, L, F, Wp, tile_rows,
                                         tile_cols, offs, s);
  }
  if (dtype == 1) {
    return banded_window_launch_t<__nv_bfloat16>(x, out, m, L, F, Wp,
                                                 tile_rows, tile_cols, offs, s);
  }
  return (int)cudaErrorInvalidValue;
}
