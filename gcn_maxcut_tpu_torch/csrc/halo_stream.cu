// Banded SpMM on one shard of a node-sharded ring, streamed through
// shared memory strip by strip, for Hopper (sm_90a): K5 and K6, and K2 and
// K3 as a ring of one shard.
//
// Replaces the TPU kernels of gcn_maxcut_tpu/ops/pallas_halo.py:
//   * K5, _halo_kernel via halo_banded_spmm and halo_banded_spmm_unit: the
//     weighted (or unit) banded sum on one shard [m, F] of a contiguous row
//     partition, x float32 or bfloat16, w float32 [m, D];
//   * K6, _packed_halo_kernel via _halo_packed_raw: the unit sum on one
//     shard of the packed [m, L = r*F] view;
// and of gcn_maxcut_tpu/ops/pallas_banded.py, on one card:
//   * K2, _fused_window_kernel's unit path via banded_spmm_unit: the
//     circulant sum on x [n, F], whose wrap the TPU kernel stages as the
//     tiles lo = x[n - Wp:] and hi = x[:Wp];
//   * K3, _banded_spmm_unit_packed_raw: the same on the packed [m, r*F]
//     view, whose wrap tiles are those rows rotated by +F and -F along
//     columns (wrap_lo, wrap_hi).
// ops/banded.py stages those same tiles as pre and post of a one-shard
// ring, so the circulant sum is the shard's sum below with no row taken
// mod m.  All compute, for 0 <= i < m,
//   out[i, c] = sum_k w[i, k] * src(i + o_k, c)        (w = 1: unit weights)
// with src(q) = pre[q + Wp] for q < 0, x[q] for 0 <= q < m and
// post[q - m] for q >= m: pre and post are the [Wp, L] tiles the caller
// staged from the ring neighbours, |o_k| <= Wp.  No rotation here: in the
// packed layout the sender of a tile across the global wrap has already
// rotated its lane groups.  Sums are float32 in offset order from 0 with
// separate multiply and add roundings (no FMA contraction); unit weights
// add the value itself; the output has x's dtype, rounded once.  That is
// the arithmetic of the plain PyTorch versions (ops/halo.py
// halo_banded_spmm_plain, ops/banded.py banded_spmm_unit_plain) and of the
// earlier bodies (csrc/banded_window.cu, in its halo mode for K5 and K6),
// so all agree bit for bit.
//
// Bound on this card: bytes.  One launch reads the shard and its two tiles
// once (and the [m, D] weights) and writes the shard once:
// 2*m*L*el + 2*Wp*L*el (+ m*D*4) bytes against m*L*D adds (2*m*L*D
// operations weighted).  At the packed halo trainer's shard (m = 312,576,
// L = 128, bf16) that is ~160 MB, ~0.048 ms at 3.35 TB/s, while the adds
// need ~5 us at 67 TFLOP/s.  K2 and K3 on one card: the function reads x
// once and writes it once, 2*m*L*el bytes (the tiles are x's own rows;
// staging K3's two rotated tiles adds 4*Wp*L*el), against m*L*D adds.  At
// the packed giant trainer's 10,002,432 x 16 bf16 (m = 1,250,304, L = 128)
// that is 640 MB, 0.191 ms at 3.35 TB/s; its adds need 0.019 ms.
//
// Design: K4's chunked stream (csrc/banded_stream.cu) in a halo mode.  The
// earlier body staged a [rows + 2*Wp, cols] window per tile (x read 1.5-5
// times), one 2-byte or 4-byte element a thread with an integer divide
// each, and summed only after the whole window had landed.  Here a block
// owns one column tile of fc columns and a strip of S consecutive output
// rows, and stages the strip's window of R = S + 2*Wp rows in chunks of C
// rows: chunk 0's window first, then each chunk's C new rows behind it.
// Strip-local row t is source row q = s0 - Wp + t and lives in slot t:
// the window holds the whole strip, so no slot is reused (K4's ring walks
// 1,024-row strips and reuses slots mod 2*C + 2*Wp; here short strips won,
// PERF.md).  Each segment comes from pre, x or post by the rule above, one
// cp.async per row segment.  Rows are never taken mod m: the
// tiles take the place of the circulant wrap.  While chunk j is summed,
// chunk j + 1's rows and [C, D] weights are on their way.  Each strip
// reads its rows (S + 2*Wp) / S times, the re-read ones mostly from L2.
//
// A thread owns VEC = 16 / el adjacent columns of one row: one 16-byte
// copy per row segment, 16-byte shared loads and one 16-byte store of VEC
// outputs (8 bfloat16 values, each rounded once with round-to-nearest-even,
// or 4 floats), summed in VEC float accumulators.  So the kernel takes only
// shards whose rows are whole 16-byte pieces (L*el % 16 == 0) with x, pre,
// post and out 16-byte aligned; the entry point refuses anything else, and
// ops/halo.py and ops/banded.py send other arrays to the earlier body,
// which beat a scalar path of this kernel at F = 3 (PERF.md).  Weights are
// copied in 16-byte pieces where their chunk is aligned, else in 4-byte
// pieces.  A sweep on the card fixed the geometry (PERF.md): short strips
// of two chunks keep many blocks in flight, and their re-read rows come
// from L2.  No TMA or wgmma: there is no matrix product here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define HSTREAM_MAX_OFFSETS 32
#define HSTREAM_THREADS 256

struct HStreamOffsets {
  int n;
  int o[HSTREAM_MAX_OFFSETS];
};

__device__ __forceinline__ void hstream_cp16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void hstream_cp4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void hstream_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void hstream_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// VEC values of a window row segment, widened to float.
__device__ __forceinline__ void hstream_get(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = a.z;
  v[3] = a.w;
}
__device__ __forceinline__ void hstream_get(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 a = *reinterpret_cast<const uint4*>(p);
  const unsigned u[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
  for (int e = 0; e < 4; ++e) {   // the lower address holds the lower half
    v[2 * e] = __uint_as_float(u[e] << 16);
    v[2 * e + 1] = __uint_as_float(u[e] & 0xffff0000u);
  }
}

// VEC sums stored in the output's dtype, each rounded once.
__device__ __forceinline__ void hstream_put(float* p, const float (&a)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(a[0], a[1], a[2], a[3]);
}
__device__ __forceinline__ void hstream_put(__nv_bfloat16* p, const float (&a)[8]) {
  unsigned u[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const __nv_bfloat162 h = __floats2bfloat162_rn(a[2 * e], a[2 * e + 1]);
    u[e] = *reinterpret_cast<const unsigned*>(&h);
  }
  *reinterpret_cast<uint4*>(p) = make_uint4(u[0], u[1], u[2], u[3]);
}

// Bytes of the strip's window, rounded up so that the two weight buffers
// after it start 16-byte aligned.  ops/halo_stream.py halo_stream_smem_bytes
// computes the same sum.
static size_t hstream_smem_bytes(int window_rows, int fc, size_t elsize, int chunk,
                                 int D) {
  return ((size_t)window_rows * fc * elsize + 15) / 16 * 16 + (size_t)2 * chunk * D * 4;
}

template <typename T, bool WEIGHTED>
__global__ void __launch_bounds__(HSTREAM_THREADS)
halo_stream_kernel(const T* __restrict__ x, const T* __restrict__ pre,
                   const T* __restrict__ post, const float* __restrict__ w,
                   T* __restrict__ out, int m, int L, int Wp, int chunk, int strip,
                   int fc, HStreamOffsets offs) {
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char hstream_smem[];
  const int D = offs.n;
  T* window = reinterpret_cast<T*>(hstream_smem);    // strip + 2 * Wp rows
  float* wbuf = reinterpret_cast<float*>(
      hstream_smem + ((size_t)(strip + 2 * Wp) * fc * sizeof(T) + 15) / 16 * 16);

  const int s0 = blockIdx.x * strip;
  const int rows_here = min(strip, m - s0);
  const int c0 = blockIdx.y * fc;
  const int cols = min(fc, L - c0);
  const int need = rows_here + 2 * Wp;            // strip-local rows read
  const int n_chunks = (rows_here + chunk - 1) / chunk;

  // Each thread keeps one column group and one row phase for the whole run.
  const int groups = fc / VEC;
  const int row_step = HSTREAM_THREADS / groups;
  const int my_row = threadIdx.x / groups;
  const int col = (threadIdx.x - my_row * groups) * VEC;
  const bool active = my_row < row_step && col < cols;

  // Strip-local rows [t_lo, min(t_hi, need)) into their slots, each from
  // the tile or the shard that holds its source row.
  auto load_rows = [&](int t_lo, int t_hi) {
    if (!active) return;
    t_hi = min(t_hi, need);
    for (int t = t_lo + my_row; t < t_hi; t += row_step) {
      const int q = s0 - Wp + t;
      const T* row = q < 0    ? pre + (int64_t)(q + Wp) * L
                     : q >= m ? post + (int64_t)(q - m) * L
                              : x + (int64_t)q * L;
      const T* src = row + c0 + col;
      hstream_cp16(window + (size_t)t * fc + col, src);
    }
  };
  // Chunk j's weights: one contiguous run of rows * D floats.
  auto load_weights = [&](int j) {
    const int r = s0 + j * chunk;
    const int count = min(chunk, m - r) * D;
    const float* src = w + (int64_t)r * D;
    float* dst = wbuf + (size_t)(j & 1) * chunk * D;
    if ((((uintptr_t)src) & 15) == 0 && count % 4 == 0) {
      for (int e = threadIdx.x * 4; e < count; e += HSTREAM_THREADS * 4) {
        hstream_cp16(dst + e, src + e);
      }
    } else {
      for (int e = threadIdx.x; e < count; e += HSTREAM_THREADS) {
        hstream_cp4(dst + e, src + e);
      }
    }
  };

  // Prologue: chunk 0's whole window and weights, one commit group.
  load_rows(0, chunk + 2 * Wp);
  if (WEIGHTED) load_weights(0);
  hstream_commit();

  for (int j = 0; j < n_chunks; ++j) {
    if (j + 1 < n_chunks) {
      // Slots no chunk has read; the weight buffer held chunk j - 1's
      // weights, done at the last barrier.
      load_rows((j + 1) * chunk + 2 * Wp, (j + 2) * chunk + 2 * Wp);
      if (WEIGHTED) load_weights(j + 1);
    }
    hstream_commit();
    hstream_wait<1>();                            // chunk j's group has landed
    __syncthreads();

    const int r = s0 + j * chunk;
    const int rows = min(chunk, m - r);
    const float* wc = wbuf + (size_t)(j & 1) * chunk * D;
    if (active) {
      for (int i = my_row; i < rows; i += row_step) {
        float acc[VEC];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
#pragma unroll 8
        for (int k = 0; k < D; ++k) {
          float v[VEC];
          hstream_get(window + (size_t)(j * chunk + Wp + i + offs.o[k]) * fc + col, v);
          if (WEIGHTED) {
            const float wk = wc[i * D + k];
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[e] = __fadd_rn(acc[e], __fmul_rn(wk, v[e]));
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) acc[e] = __fadd_rn(acc[e], v[e]);
          }
        }
        hstream_put(out + (int64_t)(r + i) * L + c0 + col, acc);
      }
    }
    __syncthreads();                              // chunk j's weights are free
  }
  hstream_wait<0>();
}

template <typename T, bool WEIGHTED>
static int hstream_launch_t(const void* x, const void* pre, const void* post,
                            const float* w, void* out, int m, int L, int Wp,
                            int chunk, int strip, int fc, size_t smem,
                            const HStreamOffsets& offs, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        halo_stream_kernel<T, WEIGHTED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((m + strip - 1) / strip, (L + fc - 1) / fc);
  halo_stream_kernel<T, WEIGHTED><<<grid, HSTREAM_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(pre),
      static_cast<const T*>(post), w, static_cast<T*>(out), m, L, Wp, chunk, strip,
      fc, offs);
  return (int)cudaGetLastError();
}

template <typename T>
static int hstream_dispatch(const void* x, const void* pre, const void* post,
                            const float* w, void* out, int m, int L, int Wp,
                            int chunk, int strip, int fc, size_t smem,
                            const HStreamOffsets& offs, cudaStream_t stream) {
  if (w != nullptr) {
    return hstream_launch_t<T, true>(x, pre, post, w, out, m, L, Wp, chunk, strip, fc,
                                     smem, offs, stream);
  }
  return hstream_launch_t<T, false>(x, pre, post, w, out, m, L, Wp, chunk, strip, fc,
                                    smem, offs, stream);
}

// Plain C entry point of K2, K3, K5 and K6, bound with ctypes.  x and out are one
// shard [m, L], pre and post its staged [Wp, L] tiles, all contiguous on
// the device and of one dtype (0 = float32, 1 = bfloat16); w is a float32
// [m, n_offsets] weight table, or null for unit weights.  The geometry
// (chunk, strip, fc) and smem_bytes come from ops/halo_stream.py
// halo_stream_shape; smem_bytes must equal what the kernel uses.  L times
// the element size must be a multiple of 16 and x, pre, post and out
// 16-byte aligned.  m may be as small as one row: every row beyond the
// shard comes from a tile.  Returns the cudaError_t of the launch (0 on
// success).
extern "C" int halo_stream_launch(const void* x, const void* pre, const void* post,
                                  const void* w, void* out, int m, int L,
                                  const int* offsets, int n_offsets, int Wp,
                                  int dtype, int chunk, int strip, int fc,
                                  int smem_bytes, void* stream) {
  if (n_offsets < 1 || n_offsets > HSTREAM_MAX_OFFSETS || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  HStreamOffsets offs;
  offs.n = n_offsets;
  for (int k = 0; k < n_offsets; ++k) {
    if (offsets[k] > Wp || offsets[k] < -Wp) return (int)cudaErrorInvalidValue;
    offs.o[k] = offsets[k];
  }
  const size_t elsize = dtype == 0 ? 4 : 2;
  const int vec = (int)(16 / elsize);
  if (m < 1 || L < 1 || Wp < 0 || chunk < 4 ||
      chunk % 4 || strip < chunk || strip % chunk || fc < 1 || fc % vec ||
      fc / vec > HSTREAM_THREADS ||
      (size_t)smem_bytes !=
          hstream_smem_bytes(strip + 2 * Wp, fc, elsize, chunk, w ? n_offsets : 0)) {
    return (int)cudaErrorInvalidValue;
  }
  if ((L * elsize) % 16 ||
      (((uintptr_t)x | (uintptr_t)pre | (uintptr_t)post | (uintptr_t)out) & 15)) {
    return (int)cudaErrorInvalidValue;
  }
  const float* wf = static_cast<const float*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)smem_bytes;
  if (dtype == 0) {
    return hstream_dispatch<float>(x, pre, post, wf, out, m, L, Wp, chunk, strip, fc,
                                   smem, offs, s);
  }
  return hstream_dispatch<__nv_bfloat16>(x, pre, post, wf, out, m, L, Wp, chunk, strip,
                                         fc, smem, offs, s);
}
