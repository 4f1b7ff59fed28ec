// Weighted banded (circulant) SpMM streamed through a shared-memory ring,
// for Hopper (sm_90a): K4.
//
// Replaces the TPU kernel gcn_maxcut_tpu/ops/pallas_banded.py::_fused_window_kernel
// on its weighted path (_banded_spmm_raw, the "mxu" and "vpu" modes, both
// exact float32 here):
//   out[i, c] = sum_k w[i, k] * x[(i + o_k) mod n, c],
// x and out float32 [n, F], w float32 [n, D], |o_k| <= Wp, 2*Wp <= n.
//
// Bound on this card: bytes.  The function reads x and w once and writes
// out once, 2*n*F*4 + n*D*4 bytes, against 2*n*D*F float operations; at
// the banded microbenchmark's shape (n = 131,072, F = 128, D = 8) that is
// ~138 MB, ~0.041 ms at 3.35 TB/s, while the operations need ~4 us at
// 67 TFLOP/s.
//
// Design.  The earlier body (csrc/banded_window.cu) staged a window of
// rows + 2*Wp rows for each 32-row tile, so every x element was read about
// five times, and the staging did not overlap the sums.  Here a block owns
// one column tile of fc columns and a strip of S consecutive output rows,
// walked in chunks of C rows.  Shared memory holds a ring of R = 2*C + 2*Wp
// source rows: the current chunk's window [r - Wp, r + C + Wp) and the next
// chunk's C new rows, in flight behind it.  Strip-local row t
// (source row s0 - Wp + t, taken mod n) lives in ring slot t mod R, and
// each row segment is copied on its own with cp.async, so the wrap at row
// n - 1 -> 0 needs no special tile.  While chunk j is summed, the C new
// rows and the [C, D] weights of chunk j + 1 are on their way, so every
// source row is read from device memory once per strip: (S + 2*Wp) / S
// times in all, against (32 + 2*Wp) / 32 before.  A direct gather (one
// thread per row and 4 columns, D float4 loads from L2) lost to this ring
// at F = 128 (PERF.md): x at those sizes (67-640 MB) does not fit in L2.
//
// A thread owns 4 adjacent columns of one row: 16-byte copies, 16-byte
// shared loads and 16-byte stores, so the kernel takes only F % 4 == 0
// with x and out 16-byte aligned; ops/banded.py sends anything else (F =
// 3) to the earlier body, which beat a scalar path of this ring there
// (PERF.md).  Sums are float32 in offset
// order from 0 with separate multiply and add roundings (no FMA
// contraction): the arithmetic of the plain PyTorch version
// (ops/banded.py banded_spmm_plain), so results agree with it bit for bit.
// No TMA or wgmma: there is no matrix product here.
//
// Column-weight mode (P5a).  The same ring also replaces
// experiments/weighted_probe.py::_kernel in its "cols" variant (the
// pallas_call in weighted_variant that took the weights as D separate
// column arrays): K4's function with the weights column-major, wc float32
// [D, n], out[i, c] = sum_k wc[k, i] * x[(i + o_k) mod n, c].  The weight
// layout is a compile-time parameter of the kernel; only the weights'
// copy and the sum's read of them differ.  A chunk's weights are D runs of
// `rows` floats at wc + k*n + r, copied with cp.async into the same two
// buffers as [D, chunk]: 16-byte copies where n % 4 == 0 and wc is 16-byte
// aligned (r is a multiple of the chunk, so every run is), else 4-byte
// copies.  The buffers hold the same bytes as K4's, so the geometry is
// ops/banded.py stream_shape unchanged.  Bound: K4's, 2*n*F*4 + n*D*4
// bytes.

#include <cuda_runtime.h>
#include <stdint.h>

#define BSTREAM_MAX_OFFSETS 32
#define BSTREAM_THREADS 256

struct BStreamOffsets {
  int n;
  int o[BSTREAM_MAX_OFFSETS];
};

__device__ __forceinline__ void bstream_cp16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void bstream_cp4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void bstream_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void bstream_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Bytes of the ring, rounded up so that the two weight buffers after it
// start 16-byte aligned.  ops/banded.py stream_shape computes the same sum.
static size_t bstream_smem_bytes(int ring_rows, int fc, int chunk, int D) {
  return ((size_t)ring_rows * fc * 4 + 15) / 16 * 16 + (size_t)2 * chunk * D * 4;
}

// The weights' layout: K4's [n, D] rows or P5a's [D, n] columns.
#define BSTREAM_ROWS 0
#define BSTREAM_COLS 1

template <int LAYOUT>
__global__ void __launch_bounds__(BSTREAM_THREADS)
banded_stream_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ out, int n, int F, int Wp, int chunk,
                     int strip, int fc, int ring_rows, BStreamOffsets offs) {
  extern __shared__ __align__(16) float bstream_smem[];
  const int D = offs.n;
  float* ring = bstream_smem;
  float* wbuf = bstream_smem + ((size_t)ring_rows * fc + 3) / 4 * 4;

  const int s0 = blockIdx.x * strip;
  const int rows_here = min(strip, n - s0);
  const int c0 = blockIdx.y * fc;
  const int cols = min(fc, F - c0);
  const int need = rows_here + 2 * Wp;            // strip-local rows read
  const int n_chunks = (rows_here + chunk - 1) / chunk;

  // Each thread keeps one column group and one row phase for the whole run.
  const int groups = fc / 4;
  const int row_step = BSTREAM_THREADS / groups;
  const int my_row = threadIdx.x / groups;
  const int col = (threadIdx.x - my_row * groups) * 4;
  const bool active = my_row < row_step && col < cols;

  // Strip-local rows [t_lo, min(t_hi, need)) into their ring slots.
  auto load_rows = [&](int t_lo, int t_hi) {
    if (!active) return;
    t_hi = min(t_hi, need);
    for (int t = t_lo + my_row; t < t_hi; t += row_step) {
      int q = s0 - Wp + t;
      if (q < 0) {
        q += n;
      } else if (q >= n) {
        q -= n;
      }
      bstream_cp16(ring + (size_t)(t % ring_rows) * fc + col,
                   x + (int64_t)q * F + c0 + col);
    }
  };
  // Chunk j's weights.  Rows: one contiguous run of rows * D floats, as
  // [chunk, D].  Columns: D runs of rows floats, one an offset, as
  // [D, chunk].
  auto load_weights = [&](int j) {
    const int r = s0 + j * chunk;
    float* dst = wbuf + (size_t)(j & 1) * chunk * D;
    if constexpr (LAYOUT == BSTREAM_ROWS) {
      const int count = min(chunk, n - r) * D;
      const float* src = w + (int64_t)r * D;
      if ((((uintptr_t)src) & 15) == 0 && count % 4 == 0) {
        for (int e = threadIdx.x * 4; e < count; e += BSTREAM_THREADS * 4) {
          bstream_cp16(dst + e, src + e);
        }
      } else {
        for (int e = threadIdx.x; e < count; e += BSTREAM_THREADS) {
          bstream_cp4(dst + e, src + e);
        }
      }
    } else {
      const int rows = min(chunk, n - r);
      const float* src = w + r;
      if ((((uintptr_t)w) & 15) == 0 && n % 4 == 0) {   // then rows % 4 == 0
        const int pieces = rows / 4;
        for (int e = threadIdx.x; e < D * pieces; e += BSTREAM_THREADS) {
          const int k = e / pieces;
          const int i = (e - k * pieces) * 4;
          bstream_cp16(dst + k * chunk + i, src + (int64_t)k * n + i);
        }
      } else {
        for (int e = threadIdx.x; e < D * rows; e += BSTREAM_THREADS) {
          const int k = e / rows;
          const int i = e - k * rows;
          bstream_cp4(dst + k * chunk + i, src + (int64_t)k * n + i);
        }
      }
    }
  };

  // Prologue: chunk 0's whole window and weights, one commit group.
  load_rows(0, chunk + 2 * Wp);
  load_weights(0);
  bstream_commit();

  int base = 0;                                   // ring slot of t = j * chunk
  for (int j = 0; j < n_chunks; ++j) {
    if (j + 1 < n_chunks) {
      // These slots held chunk j - 1's first rows, done at the last barrier.
      load_rows((j + 1) * chunk + 2 * Wp, (j + 2) * chunk + 2 * Wp);
      load_weights(j + 1);
    }
    bstream_commit();
    bstream_wait<1>();                            // chunk j's group has landed
    __syncthreads();

    const int r = s0 + j * chunk;
    const int rows = min(chunk, n - r);
    const float* wc = wbuf + (size_t)(j & 1) * chunk * D;
    if (active) {
      for (int i = my_row; i < rows; i += row_step) {
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll 8
        for (int k = 0; k < D; ++k) {
          int slot = base + Wp + i + offs.o[k];
          if (slot >= ring_rows) slot -= ring_rows;
          const float wk = LAYOUT == BSTREAM_ROWS ? wc[i * D + k] : wc[k * chunk + i];
          const float4 v = *reinterpret_cast<const float4*>(ring + (size_t)slot * fc + col);
          acc[0] = __fadd_rn(acc[0], __fmul_rn(wk, v.x));
          acc[1] = __fadd_rn(acc[1], __fmul_rn(wk, v.y));
          acc[2] = __fadd_rn(acc[2], __fmul_rn(wk, v.z));
          acc[3] = __fadd_rn(acc[3], __fmul_rn(wk, v.w));
        }
        *reinterpret_cast<float4*>(out + (int64_t)(r + i) * F + c0 + col) =
            make_float4(acc[0], acc[1], acc[2], acc[3]);
      }
    }
    base += chunk;
    if (base >= ring_rows) base -= ring_rows;
    __syncthreads();                              // chunk j's slots are free
  }
  bstream_wait<0>();
}

static int bstream_offsets(const int* offsets, int n_offsets, int Wp,
                           BStreamOffsets* offs) {
  if (n_offsets < 1 || n_offsets > BSTREAM_MAX_OFFSETS) {
    return (int)cudaErrorInvalidValue;
  }
  offs->n = n_offsets;
  for (int k = 0; k < n_offsets; ++k) {
    if (offsets[k] > Wp || offsets[k] < -Wp) return (int)cudaErrorInvalidValue;
    offs->o[k] = offsets[k];
  }
  return 0;
}

// Plain C entry points, bound with ctypes: K4 (banded_stream_launch) and
// its column-weight mode, P5a (banded_stream_cols_launch).  x and out
// float32 [n, F], w float32 [n, n_offsets] (K4) or [n_offsets, n] (P5a),
// all contiguous on the device; F % 4 == 0 and x and out 16-byte aligned.
// The geometry (chunk, strip, fc, ring_rows) and smem_bytes come from
// ops/banded.py stream_shape; smem_bytes must equal what the kernel uses.
// Each returns the cudaError_t of the launch (0 on success).
template <int LAYOUT>
static int bstream_launch(const void* x, const void* w, void* out, int n, int F,
                          const int* offsets, int n_offsets, int Wp, int chunk,
                          int strip, int fc, int ring_rows, int smem_bytes,
                          void* stream) {
  BStreamOffsets offs;
  const int bad = bstream_offsets(offsets, n_offsets, Wp, &offs);
  if (bad) return bad;
  if (n < 1 || F < 1 || F % 4 || Wp < 0 || 2 * Wp > n || chunk < 4 || chunk % 4 ||
      strip < chunk || strip % chunk || fc < 4 || fc % 4 ||
      fc / 4 > BSTREAM_THREADS || ring_rows < 2 * chunk + 2 * Wp ||
      (size_t)smem_bytes != bstream_smem_bytes(ring_rows, fc, chunk, n_offsets) ||
      (((uintptr_t)x | (uintptr_t)out) & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)smem_bytes;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        banded_stream_kernel<LAYOUT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((n + strip - 1) / strip, (F + fc - 1) / fc);
  banded_stream_kernel<LAYOUT><<<grid, BSTREAM_THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), static_cast<float*>(out),
      n, F, Wp, chunk, strip, fc, ring_rows, offs);
  return (int)cudaGetLastError();
}

extern "C" int banded_stream_launch(const void* x, const void* w, void* out,
                                    int n, int F, const int* offsets,
                                    int n_offsets, int Wp, int chunk,
                                    int strip, int fc, int ring_rows,
                                    int smem_bytes, void* stream) {
  return bstream_launch<BSTREAM_ROWS>(x, w, out, n, F, offsets, n_offsets, Wp, chunk,
                                      strip, fc, ring_rows, smem_bytes, stream);
}

extern "C" int banded_stream_cols_launch(const void* x, const void* wc, void* out,
                                         int n, int F, const int* offsets,
                                         int n_offsets, int Wp, int chunk,
                                         int strip, int fc, int ring_rows,
                                         int smem_bytes, void* stream) {
  return bstream_launch<BSTREAM_COLS>(x, wc, out, n, F, offsets, n_offsets, Wp, chunk,
                                      strip, fc, ring_rows, smem_bytes, stream);
}
