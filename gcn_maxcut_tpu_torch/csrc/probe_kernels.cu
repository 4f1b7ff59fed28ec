// The SpMM design probes' kernels, for Hopper (sm_90a).
//
// The JAX package's experiments/ hold five TPU probes of the two
// aggregation kernels' designs: P1-P4 compute K1's function (a windowed
// block-ELL gather-sum) from different operand layouts, P5 computes K4's
// (a weighted banded sum) with different ways of delivering the weights.
// Three of them need a kernel of their own here; P3 runs on K1's kernel
// (csrc/block_ell_window.cu, its 128-row slices are P3's design) and P5's
// row-major variants on K4's (csrc/banded_window.cu).  Each kernel below
// sums in float32 in its plain version's order, with separate multiply and
// add roundings (ops/probe_kernels.py), so results agree with it bit for
// bit.  No TMA or wgmma: there is no matrix product here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define PROBE_THREADS 1024
#define PROBE_UNROLL 4
#define PROBE_PANEL 128
#define PROBE_MAX_OFFSETS 32
#define PROBE_BANDED_THREADS 256

__device__ __forceinline__ float probe_to_f32(float v) { return v; }
__device__ __forceinline__ float probe_to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Stage rows [first, first + rows) of the [n, F] array x, columns
// [c0, c0 + cols), into win[t * fc + cl], taking each row mod n (one wrap:
// the caller keeps first >= -n and first + rows <= 2n).  PROBE_UNROLL loads
// are in flight per thread before they are stored.
template <typename T>
__device__ __forceinline__ void probe_stage(T* win, const T* __restrict__ x,
                                            int first, int rows, int n, int F,
                                            int c0, int cols, int fc) {
  const int staged = rows * cols;
  for (int base = threadIdx.x; base < staged;
       base += PROBE_UNROLL * blockDim.x) {
    T v[PROBE_UNROLL];
    int dst[PROBE_UNROLL];
#pragma unroll
    for (int u = 0; u < PROBE_UNROLL; ++u) {
      const int idx = base + u * blockDim.x;
      dst[u] = -1;
      if (idx < staged) {
        const int t = idx / cols;
        const int cl = idx - t * cols;
        int q = first + t;
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
    for (int u = 0; u < PROBE_UNROLL; ++u) {
      if (dst[u] >= 0) win[dst[u]] = v[u];
    }
  }
}

// ---------------------------------------------------------------------------
// window_gather (P1, P2)
//
// Replaces experiments/gather_probe.py::_kernel (pallas_call in
// proto_block_ell) and experiments/gather_probe2.py::_kernel (pallas_call in
// proto).  It computes
//   out[i, c] = sum_j w[i, j] * xpad[bi*B + lidx[i, j], c],   bi = i / B,
// over slots with 0 <= lidx < B + 2*Wp, where xpad is x with Wp zero rows
// before and after (no wrap: the probes clip their graphs).  The local
// index is relative to the receiver's B-row block window, so a row may read
// anywhere in it.  x is float32, or bfloat16 stored and summed in float32:
// the TPU's "default" precision truncated x to bf16 inside the MXU, which
// here is a bf16 array and half the bytes.
//
// Bound on this card: bytes.  The function reads xpad once ((n + 2*Wp)*F
// elements), the [n, d] int32 + float32 tables once, and writes y once
// (n*F*4 bytes), against 2*n*d*F operations.  At the probes' n = 99,840,
// F = 128, d = 8, f32: ~109 MB at Wp = 256 (~0.033 ms at 3.35 TB/s) to
// ~110 MB at Wp = 1024; bf16 x takes ~26 MB off; at d = 16 the tables add
// 6.4 MB.  The operations need ~3-6 us at 67 TFLOP/s.
//
// Design: one block per (B-row block, column tile of Fc columns).  It stages
// the block's whole [B + 2*Wp, Fc] window in shared memory with coalesced
// loads, then each thread sums its (row, column) outputs over the row's
// slots in slot order.  Neighbouring threads take neighbouring columns of
// one row, so the table entry is a broadcast load.  Fc is the caller's,
// from the shared-memory budget; every window row is read from device
// memory once per block, so the whole window costs (B + 2*Wp) / B reads of
// x (3x at B = Wp = 512, against 9x for P3's 128-row slices at that Wp).
template <typename T>
__global__ void __launch_bounds__(PROBE_THREADS)
window_gather_kernel(const T* __restrict__ xpad, const int* __restrict__ lidx,
                     const float* __restrict__ w, float* __restrict__ out,
                     int n_pad_rows, int F, int d, int B, int Wp, int fc) {
  extern __shared__ __align__(16) unsigned char probe_smem[];
  T* win = reinterpret_cast<T*>(probe_smem);

  const int row0 = blockIdx.x * B;
  const int c0 = blockIdx.y * fc;
  const int cols = min(fc, F - c0);
  const int win_rows = B + 2 * Wp;

  probe_stage<T>(win, xpad, row0, win_rows, n_pad_rows, F, c0, cols, fc);
  __syncthreads();

  for (int idx = threadIdx.x; idx < B * cols; idx += blockDim.x) {
    const int i = idx / cols;
    const int cl = idx - i * cols;
    const int64_t gi = (int64_t)row0 + i;
    const int* lrow = lidx + gi * d;
    const float* wrow = w + gi * d;
    float acc = 0.0f;
    for (int j = 0; j < d; ++j) {
      const int l = __ldg(lrow + j);
      if ((unsigned)l < (unsigned)win_rows) {
        acc = __fadd_rn(acc, __fmul_rn(__ldg(wrow + j),
                                       probe_to_f32(win[l * fc + cl])));
      }
    }
    out[gi * F + c0 + cl] = acc;
  }
}

// ---------------------------------------------------------------------------
// panel_ell_spmm (P4)
//
// Replaces experiments/panel_ell_probe.py::_panel_kernel (pallas_call in
// panel_spmm).  With the block's window xwin_i[t] = x[(bi*B - Wp + t) mod n],
// t in [0, B + 2*Wp), cut into 128-row panels, it computes
//   out[i, c] = sum_s wgt[i, s] * xwin_i[(s / W_P)*128 + idx[i, s], c]
// over the slots s in [0, n_panels*W_P) with 0 <= idx < 128 (idx = -1 marks
// an empty slot).  The tables are build_panel_tables' as they are.
//
// Bound on this card: bytes.  x read once and y written once (2*n*F*4) plus
// the [n, n_panels*W_P] int32 + float32 tables (n*slots*8), against
// 2*n*(filled slots)*F operations.  At n = 100,352, F = 128, W = 255 and
// W_P = 4 (6 panels, 24 slots): ~122 MB, ~0.036 ms; at W = 511 and W_P = 4
// (12 panels, 48 slots) ~141 MB.  The table is 3-6x K1's: the bucketing that
// cut the TPU's one-hot build costs bytes here.
//
// Design: as window_gather, on the wrapped window (the probe's in-window
// rule is block-relative, so a 128-row slice does not cover a row), and a
// thread walks all of its row's slots, skipping the empty ones.
__global__ void __launch_bounds__(PROBE_THREADS)
panel_ell_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                 const float* __restrict__ wgt, float* __restrict__ out, int n,
                 int F, int slots, int W_P, int B, int Wp, int fc) {
  extern __shared__ __align__(16) unsigned char probe_smem[];
  float* win = reinterpret_cast<float*>(probe_smem);

  const int row0 = blockIdx.x * B;
  const int c0 = blockIdx.y * fc;
  const int cols = min(fc, F - c0);

  probe_stage<float>(win, x, row0 - Wp, B + 2 * Wp, n, F, c0, cols, fc);
  __syncthreads();

  for (int o = threadIdx.x; o < B * cols; o += blockDim.x) {
    const int i = o / cols;
    const int cl = o - i * cols;
    const int64_t gi = (int64_t)row0 + i;
    const int* irow = idx + gi * slots;
    const float* wrow = wgt + gi * slots;
    float acc = 0.0f;
    for (int s = 0; s < slots; ++s) {
      const int k = __ldg(irow + s);
      if ((unsigned)k < (unsigned)PROBE_PANEL) {
        const int t = (s / W_P) * PROBE_PANEL + k;
        acc = __fadd_rn(acc, __fmul_rn(__ldg(wrow + s), win[t * fc + cl]));
      }
    }
    out[gi * F + c0 + cl] = acc;
  }
}

// ---------------------------------------------------------------------------
// banded_spmm_cols (P5a)
//
// Replaces experiments/weighted_probe.py::_kernel in its "cols" variant (the
// pallas_call in weighted_variant that takes the weights as D separate
// column arrays).  It computes K4's function
//   out[i, c] = sum_k wc[k, i] * x[(i + o_k) mod n, c]
// with the weights in column-major [D, n] layout.
//
// Bound on this card: bytes.  2*n*F*4 + n*D*4, against 2*n*D*F operations:
// at n = 131,072, F = 128, D = 8, ~138 MB, ~0.041 ms at 3.35 TB/s; the
// operations ~4 us at 67 TFLOP/s.
//
// Design: K4's tiling (ops/banded.py tile_shape, the caller's), so the two
// differ in the weights' layout alone.  A block stages its [rows + 2*Wp,
// cols] window (wrap rows included) and its [D, rows] weights in shared
// memory; in this layout each offset's weights are one contiguous run of
// rows, a coalesced load, where K4 reads [rows, D] rows of D floats.  Each
// thread then sums the D shifted rows of its columns in offset order.
struct ProbeOffsets {
  int n;
  int o[PROBE_MAX_OFFSETS];
};

__host__ __device__ __forceinline__ size_t probe_window_bytes(int tile_rows,
                                                              int Wp,
                                                              int tile_cols) {
  return ((size_t)(tile_rows + 2 * Wp) * tile_cols * sizeof(float) + 15) /
         16 * 16;
}

__global__ void __launch_bounds__(PROBE_BANDED_THREADS)
banded_cols_kernel(const float* __restrict__ x, const float* __restrict__ wc,
                   float* __restrict__ out, int n, int F, int Wp,
                   int tile_rows, int tile_cols, ProbeOffsets offs) {
  extern __shared__ __align__(16) unsigned char probe_smem[];
  float* win = reinterpret_cast<float*>(probe_smem);
  float* wtile = reinterpret_cast<float*>(
      probe_smem + probe_window_bytes(tile_rows, Wp, tile_cols));

  const int r0 = blockIdx.x * tile_rows;
  const int c0 = blockIdx.y * tile_cols;
  const int rows = min(tile_rows, n - r0);
  const int cols = min(tile_cols, F - c0);

  for (int idx = threadIdx.x; idx < offs.n * rows; idx += blockDim.x) {
    const int k = idx / rows;
    const int i = idx - k * rows;
    wtile[k * tile_rows + i] = wc[(int64_t)k * n + r0 + i];
  }
  probe_stage<float>(win, x, r0 - Wp, rows + 2 * Wp, n, F, c0, cols,
                     tile_cols);
  __syncthreads();

  for (int idx = threadIdx.x; idx < rows * cols; idx += blockDim.x) {
    const int i = idx / cols;
    const int cl = idx - i * cols;
    float acc = 0.0f;
    for (int k = 0; k < offs.n; ++k) {
      const float v = win[(i + Wp + offs.o[k]) * tile_cols + cl];
      acc = __fadd_rn(acc, __fmul_rn(wtile[k * tile_rows + i], v));
    }
    out[(int64_t)(r0 + i) * F + c0 + cl] = acc;
  }
}

// ---------------------------------------------------------------------------
// Plain C entry points, bound with ctypes.  Every array is contiguous on the
// device; each returns the cudaError_t of its launch (0 on success).

static int probe_set_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// xpad [n_rows + 2*Wp, F] (dtype 0 = float32, 1 = bfloat16), lidx int32 and
// w float32 [n_rows, d], out float32 [n_rows, F]; B divides n_rows.
extern "C" int window_gather_launch(const void* xpad, const void* lidx,
                                    const void* w, void* out, int n_rows,
                                    int F, int d, int B, int Wp, int fc,
                                    int dtype, void* stream) {
  if (n_rows < 1 || F < 1 || d < 1 || B < 1 || Wp < 0 || fc < 1 ||
      n_rows % B != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int rows = n_rows + 2 * Wp;
  dim3 grid(n_rows / B, (F + fc - 1) / fc);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* li = static_cast<const int*>(lidx);
  const float* wf = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  if (dtype == 0) {
    const size_t smem = (size_t)(B + 2 * Wp) * fc * sizeof(float);
    int err = probe_set_smem((const void*)window_gather_kernel<float>, smem);
    if (err) return err;
    window_gather_kernel<float><<<grid, PROBE_THREADS, smem, s>>>(
        static_cast<const float*>(xpad), li, wf, o, rows, F, d, B, Wp, fc);
  } else if (dtype == 1) {
    const size_t smem = (size_t)(B + 2 * Wp) * fc * sizeof(__nv_bfloat16);
    int err = probe_set_smem(
        (const void*)window_gather_kernel<__nv_bfloat16>, smem);
    if (err) return err;
    window_gather_kernel<__nv_bfloat16><<<grid, PROBE_THREADS, smem, s>>>(
        static_cast<const __nv_bfloat16*>(xpad), li, wf, o, rows, F, d, B, Wp,
        fc);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x and out float32 [n, F]; idx int32 and wgt float32 [n, slots] with
// slots = ((B + 2*Wp) / 128) * W_P; B divides n, B + 2*Wp <= n.
extern "C" int panel_ell_launch(const void* x, const void* idx,
                                const void* wgt, void* out, int n, int F,
                                int slots, int W_P, int B, int Wp, int fc,
                                void* stream) {
  if (n < 1 || F < 1 || W_P < 1 || B < 1 || Wp < 0 || fc < 1 ||
      n % B != 0 || B + 2 * Wp > n || (B + 2 * Wp) % PROBE_PANEL != 0 ||
      slots != (B + 2 * Wp) / PROBE_PANEL * W_P) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = (size_t)(B + 2 * Wp) * fc * sizeof(float);
  int err = probe_set_smem((const void*)panel_ell_kernel, smem);
  if (err) return err;
  dim3 grid(n / B, (F + fc - 1) / fc);
  panel_ell_kernel<<<grid, PROBE_THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(idx),
      static_cast<const float*>(wgt), static_cast<float*>(out), n, F, slots,
      W_P, B, Wp, fc);
  return (int)cudaGetLastError();
}

// x and out float32 [n, F], wc float32 [n_offsets, n]; |o_k| <= Wp,
// 2*Wp <= n, tile_cols <= F.
extern "C" int banded_cols_launch(const void* x, const void* wc, void* out,
                                  int n, int F, const int* offsets,
                                  int n_offsets, int Wp, int tile_rows,
                                  int tile_cols, void* stream) {
  if (n < 1 || F < 1 || Wp < 0 || 2 * Wp > n || tile_rows < 1 ||
      tile_cols < 1 || n_offsets < 1 || n_offsets > PROBE_MAX_OFFSETS) {
    return (int)cudaErrorInvalidValue;
  }
  ProbeOffsets offs;
  offs.n = n_offsets;
  for (int k = 0; k < n_offsets; ++k) {
    if (offsets[k] > Wp || offsets[k] < -Wp) return (int)cudaErrorInvalidValue;
    offs.o[k] = offsets[k];
  }
  const size_t smem = probe_window_bytes(tile_rows, Wp, tile_cols) +
                      (size_t)tile_rows * n_offsets * sizeof(float);
  int err = probe_set_smem((const void*)banded_cols_kernel, smem);
  if (err) return err;
  dim3 grid((n + tile_rows - 1) / tile_rows, (F + tile_cols - 1) / tile_cols);
  banded_cols_kernel<<<grid, PROBE_BANDED_THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(wc),
      static_cast<float*>(out), n, F, Wp, tile_rows, tile_cols, offs);
  return (int)cudaGetLastError();
}
