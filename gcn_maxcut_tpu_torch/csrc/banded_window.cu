// Banded (circulant) SpMM over row windows, for Hopper (sm_90a).
//
// Replaces the TPU kernel gcn_maxcut_tpu/ops/pallas_banded.py::_fused_window_kernel
// in its three uses:
//   * K2, _banded_spmm_unit_raw: y[i] = sum_k x[(i + o_k) mod n] on [n, F];
//   * K4, _banded_spmm_raw (weighted, "mxu" and "vpu" modes):
//     y[i] = sum_k w[i, k] * x[(i + o_k) mod n], x float32 [n, F] and
//     w float32 [n, D]; both TPU modes are exact float32 here;
//   * K3, _banded_spmm_unit_packed_raw: the unit sum on arrays stored in the
//     interleaved node order, viewed as [m, L = r*F].  A node shift is then a
//     row shift, and rows that wrap past either end of the array read their
//     source with the lane groups rotated by F (the wrap_lo / wrap_hi tiles of
//     the TPU version, read here in place instead of staged).
//
// and, in its halo mode, the node-sharded kernels of
// gcn_maxcut_tpu/ops/pallas_halo.py:
//   * K5, _halo_kernel via halo_banded_spmm: the weighted sum on one shard
//     [m, F] of a contiguous row partition, x float32 or bfloat16, w float32
//     [m, D]; unit weights take the unit body, which equals w = 1 bit for bit;
//   * K6, _packed_halo_kernel via _halo_packed_raw: the unit sum on one shard
//     of the packed [m, L = r*F] view.
//
// One body serves all: out[i, c] = sum_k src(i + o_k, c) on an [m, L]
// row-major array, where
//   src(q, c) = x[q, c]                      for 0 <= q < m,
//   src(q, c) = x[q + m, (c - F) mod L]      for q < 0,
//   src(q, c) = x[q - m, (c + F) mod L]      for q >= m.
// With r = 1 (F = L) the rotation is the identity and the kernel is K2.  In
// the halo mode the rows beyond the shard come from two [Wp, L] tiles that
// the caller staged from the ring neighbours (the TPU kernel's RDMA halos):
//   src(q, c) = pre[q + Wp, c]               for q < 0,
//   src(q, c) = post[q - m, c]               for q >= m,
// with no rotation here: in the packed layout the sender of a tile across
// the global wrap has already rotated its lane groups.  The overlap of that
// exchange with the interior sweep is not ported: the caller stages the
// tiles first and then launches once per shard.
//
// Bound on this card: bytes.  The function reads x once and writes y once,
// 2*m*L*sizeof(T) bytes (K4 adds the n*D*4 bytes of w), against m*L*d
// float adds (K4: 2*m*L*d operations); at the packed giant trainer's shape
// (n = 10,002,432, F = 16, bf16) that is ~0.64 GB per call, ~0.19 ms at
// 3.35 TB/s, while the adds need ~19 us at 67 TFLOP/s.  The halo mode adds
// the 2*Wp*L*sizeof(T) bytes of the two tiles to each shard's launch.
//
// Design (simple and right first): each block owns a tile of rows and up to
// 128 columns.  It stages the [rows + 2*Wp, cols] window, wrap rows included,
// in shared memory once, so every x element is read from device memory about
// (rows + 2*Wp) / rows times (the halo re-reads mostly hit L2), and each
// thread then sums the d shifted rows of its columns from shared memory in
// float.  Offsets arrive by value in a small struct.  Accumulation is f32 in
// offset order starting from 0, the order of the plain PyTorch version, so
// f32 results agree bit for bit and bf16 results agree after the one final
// rounding.  K4 also stages its tile's [rows, D] weights in shared memory
// after the window, so each weight is read from device memory once, and
// adds w*x with separate multiply and add roundings (no FMA contraction),
// as the plain version does.  No TMA or wgmma: there is no matrix product
// here, and asynchronous staging is work for a later change.

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

// Bytes of the staged window, rounded up so that the weight tile after it
// starts 16-byte aligned.
__host__ __device__ __forceinline__ size_t banded_window_bytes(
    int tile_rows, int Wp, int tile_cols, size_t elsize) {
  return ((size_t)(tile_rows + 2 * Wp) * tile_cols * elsize + 15) / 16 * 16;
}

template <typename T, bool WEIGHTED, bool HALO>
__global__ void __launch_bounds__(BANDED_THREADS)
banded_window_kernel(const T* __restrict__ x, const T* __restrict__ pre,
                     const T* __restrict__ post, const float* __restrict__ w,
                     T* __restrict__ out, int m, int L, int F, int Wp,
                     int tile_rows, int tile_cols, BandedOffsets offs) {
  extern __shared__ __align__(16) unsigned char banded_smem[];
  T* win = reinterpret_cast<T*>(banded_smem);

  const int r0 = blockIdx.x * tile_rows;
  const int c0 = blockIdx.y * tile_cols;
  const int rows = min(tile_rows, m - r0);
  const int cols = min(tile_cols, L - c0);
  const int win_rows = rows + 2 * Wp;

  // K4, K5: the tile's weights, rows [r0, r0 + rows) of the [m, D] table.
  float* wtile = reinterpret_cast<float*>(
      banded_smem + banded_window_bytes(tile_rows, Wp, tile_cols, sizeof(T)));
  if (WEIGHTED) {
    for (int idx = threadIdx.x; idx < rows * offs.n; idx += blockDim.x) {
      wtile[idx] = w[(int64_t)r0 * offs.n + idx];
    }
  }

  // Stage the window.  Window row t holds source row q = r0 - Wp + t.  In
  // the halo mode rows beyond the shard come from the staged tiles; else
  // the caller guarantees 2*Wp <= m, so a wrapped row lies inside [0, m).
  for (int idx = threadIdx.x; idx < win_rows * cols; idx += blockDim.x) {
    const int t = idx / cols;
    const int cl = idx - t * cols;
    const int q = r0 - Wp + t;
    const int c = c0 + cl;
    if (HALO) {
      const T* src = q < 0    ? pre + (int64_t)(q + Wp) * L
                     : q >= m ? post + (int64_t)(q - m) * L
                              : x + (int64_t)q * L;
      win[t * tile_cols + cl] = src[c];
      continue;
    }
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
      const float v = banded_to_f32(win[(i + Wp + offs.o[k]) * tile_cols + cl]);
      if (WEIGHTED) {
        acc = __fadd_rn(acc, __fmul_rn(wtile[i * offs.n + k], v));
      } else {
        acc += v;
      }
    }
    banded_store(&out[(int64_t)(r0 + i) * L + c0 + cl], acc);
  }
}

template <typename T, bool WEIGHTED, bool HALO = false>
static int banded_window_launch_t(const void* x, const float* w, void* out,
                                  int m, int L, int F, int Wp, int tile_rows,
                                  int tile_cols, const BandedOffsets& offs,
                                  cudaStream_t stream,
                                  const void* pre = nullptr,
                                  const void* post = nullptr) {
  const size_t smem =
      WEIGHTED ? banded_window_bytes(tile_rows, Wp, tile_cols, sizeof(T)) +
                     (size_t)tile_rows * offs.n * sizeof(float)
               : (size_t)(tile_rows + 2 * Wp) * tile_cols * sizeof(T);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        banded_window_kernel<T, WEIGHTED, HALO>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((m + tile_rows - 1) / tile_rows, (L + tile_cols - 1) / tile_cols);
  banded_window_kernel<T, WEIGHTED, HALO>
      <<<grid, BANDED_THREADS, smem, stream>>>(
          static_cast<const T*>(x), static_cast<const T*>(pre),
          static_cast<const T*>(post), w, static_cast<T*>(out), m, L, F, Wp,
          tile_rows, tile_cols, offs);
  return (int)cudaGetLastError();
}

static int banded_offsets(const int* offsets, int n_offsets, int Wp,
                          BandedOffsets* offs) {
  if (n_offsets < 1 || n_offsets > BANDED_MAX_OFFSETS) {
    return (int)cudaErrorInvalidValue;
  }
  offs->n = n_offsets;
  for (int k = 0; k < n_offsets; ++k) {
    if (offsets[k] > Wp || offsets[k] < -Wp) return (int)cudaErrorInvalidValue;
    offs->o[k] = offsets[k];
  }
  return 0;
}

// Plain C entry point of the unit kernel (K2, K3), bound with ctypes.
// dtype: 0 = float32, 1 = bfloat16.  Returns the cudaError_t of the launch
// (0 on success).  The caller checks shapes: |o_k| <= Wp, 2*Wp <= m,
// 1 <= F <= L, tile_cols <= L.
extern "C" int banded_window_launch(const void* x, void* out, int m, int L,
                                    int F, const int* offsets, int n_offsets,
                                    int Wp, int dtype, int tile_rows,
                                    int tile_cols, void* stream) {
  if (m < 1 || L < 1 || F < 1 || F > L || tile_rows < 1 || tile_cols < 1 ||
      2 * Wp > m) {
    return (int)cudaErrorInvalidValue;
  }
  BandedOffsets offs;
  const int bad = banded_offsets(offsets, n_offsets, Wp, &offs);
  if (bad) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return banded_window_launch_t<float, false>(x, nullptr, out, m, L, F, Wp,
                                                tile_rows, tile_cols, offs, s);
  }
  if (dtype == 1) {
    return banded_window_launch_t<__nv_bfloat16, false>(
        x, nullptr, out, m, L, F, Wp, tile_rows, tile_cols, offs, s);
  }
  return (int)cudaErrorInvalidValue;
}

// Plain C entry point of the weighted kernel (K4): x and out float32 [n, F],
// w float32 [n, n_offsets], all contiguous.  Same checks and return value.
extern "C" int banded_window_weighted_launch(const void* x, const void* w,
                                             void* out, int n, int F,
                                             const int* offsets,
                                             int n_offsets, int Wp,
                                             int tile_rows, int tile_cols,
                                             void* stream) {
  if (n < 1 || F < 1 || tile_rows < 1 || tile_cols < 1 || 2 * Wp > n) {
    return (int)cudaErrorInvalidValue;
  }
  BandedOffsets offs;
  const int bad = banded_offsets(offsets, n_offsets, Wp, &offs);
  if (bad) return bad;
  return banded_window_launch_t<float, true>(
      x, static_cast<const float*>(w), out, n, F, F, Wp, tile_rows, tile_cols,
      offs, static_cast<cudaStream_t>(stream));
}

// Plain C entry points of the halo mode, bound with ctypes.  x and out are
// one shard [m, L], pre and post its staged [Wp, L] tiles, all contiguous
// and of one dtype (0 = float32, 1 = bfloat16).  The caller checks shapes:
// |o_k| <= Wp, tile_cols <= L.  Unlike the circulant entry points, m may be
// as small as one row: every row beyond the shard comes from a tile.
//
// K6, and K5 with unit weights: out[i] = sum_k win[Wp + i + o_k].
extern "C" int halo_window_launch(const void* x, const void* pre,
                                  const void* post, void* out, int m, int L,
                                  const int* offsets, int n_offsets, int Wp,
                                  int dtype, int tile_rows, int tile_cols,
                                  void* stream) {
  if (m < 1 || L < 1 || Wp < 0 || tile_rows < 1 || tile_cols < 1) {
    return (int)cudaErrorInvalidValue;
  }
  BandedOffsets offs;
  const int bad = banded_offsets(offsets, n_offsets, Wp, &offs);
  if (bad) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return banded_window_launch_t<float, false, true>(
        x, nullptr, out, m, L, L, Wp, tile_rows, tile_cols, offs, s, pre, post);
  }
  if (dtype == 1) {
    return banded_window_launch_t<__nv_bfloat16, false, true>(
        x, nullptr, out, m, L, L, Wp, tile_rows, tile_cols, offs, s, pre, post);
  }
  return (int)cudaErrorInvalidValue;
}

// K5: out[i] = sum_k w[i, k] * win[Wp + i + o_k], w float32 [m, n_offsets],
// summed in float32 with separate multiply and add roundings, out in x's
// dtype.  Same checks and return value.
extern "C" int halo_window_weighted_launch(const void* x, const void* pre,
                                           const void* post, const void* w,
                                           void* out, int m, int F,
                                           const int* offsets, int n_offsets,
                                           int Wp, int dtype, int tile_rows,
                                           int tile_cols, void* stream) {
  if (m < 1 || F < 1 || Wp < 0 || tile_rows < 1 || tile_cols < 1) {
    return (int)cudaErrorInvalidValue;
  }
  BandedOffsets offs;
  const int bad = banded_offsets(offsets, n_offsets, Wp, &offs);
  if (bad) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  if (dtype == 0) {
    return banded_window_launch_t<float, true, true>(
        x, wf, out, m, F, F, Wp, tile_rows, tile_cols, offs, s, pre, post);
  }
  if (dtype == 1) {
    return banded_window_launch_t<__nv_bfloat16, true, true>(
        x, wf, out, m, F, F, Wp, tile_rows, tile_cols, offs, s, pre, post);
  }
  return (int)cudaErrorInvalidValue;
}
