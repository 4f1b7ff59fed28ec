// The SpMM design probes' kernels, for Hopper (sm_90a).
//
// The JAX package's experiments/ hold five TPU probes of the two
// aggregation kernels' designs: P1-P4 compute K1's function (a windowed
// block-ELL gather-sum) from different operand layouts, P5 computes K4's
// (a weighted banded sum) with different ways of delivering the weights.
// P1/P2 (window_warp_gather) and P4 (panel_ell_gather) are warp gathers
// here, sharing one ballot walk (probe_ballot_sum); P3 has its own source
// (csrc/subblock_stream.cu) and P5 runs on K4's ring (csrc/banded_stream.cu,
// P5a in its column-weight mode).  banded_cols_kernel, P5a's earlier
// staging body, takes P5a's rows that are not whole 16-byte pieces.  Each
// kernel below sums in float32 in its plain version's order, with separate
// multiply and add roundings (ops/probe_kernels.py), so results agree with
// it bit for bit.  No TMA or wgmma: there is no matrix product here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
__device__ __forceinline__ void probe_stage(float* win, const float* __restrict__ x,
                                            int first, int rows, int n, int F,
                                            int c0, int cols, int fc) {
  const int staged = rows * cols;
  for (int base = threadIdx.x; base < staged;
       base += PROBE_UNROLL * blockDim.x) {
    float v[PROBE_UNROLL];
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
// The warp gathers' walk (panel_ell_gather, window_warp_gather)
//
// One warp owns one receiver row; each lane holds one slot of a 32-slot
// pass: its source row `src` and weight `ws`, and the ballot `mask` of the
// lanes whose slot is summed.  The warp walks the set bits in ascending
// order, which is slot order, taking each slot's row and weight from its
// lane by __shfl_sync; PROBE_GATHER_UNROLL slots are taken together, so
// their row loads are in flight at once, and are summed after in slot
// order.  Every lane loads VEC adjacent columns from `col` of each row,
// widened to float32: 16 bytes of float32 or 8 bytes of bfloat16 at
// VEC = 4.  Empty slots cost no load and no add.
#define PROBE_GATHER_THREADS 256
#define PROBE_GATHER_UNROLL 4

template <typename T, int VEC>
__device__ __forceinline__ void probe_load_row(const T* __restrict__ p, bool on,
                                               float (&v)[VEC]) {
  if constexpr (VEC == 4 && sizeof(T) == 4) {
    float4 f = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (on) f = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = f.x;
    v[1] = f.y;
    v[2] = f.z;
    v[3] = f.w;
  } else if constexpr (VEC == 4) {
    uint2 raw = make_uint2(0u, 0u);
    if (on) raw = __ldg(reinterpret_cast<const uint2*>(p));
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    v[0] = lo.x;
    v[1] = lo.y;
    v[2] = hi.x;
    v[3] = hi.y;
  } else {
    v[0] = on ? probe_to_f32(__ldg(p)) : 0.0f;
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void probe_ballot_sum(unsigned mask, int src, float ws,
                                                 const T* __restrict__ x, int F,
                                                 int col, bool active,
                                                 float (&acc)[VEC]) {
  const unsigned full = 0xffffffffu;
  while (mask) {                                  // warp-uniform
    int rows[PROBE_GATHER_UNROLL];
    float wk[PROBE_GATHER_UNROLL];
    bool take[PROBE_GATHER_UNROLL];
#pragma unroll
    for (int u = 0; u < PROBE_GATHER_UNROLL; ++u) {
      take[u] = mask != 0;
      const int from = take[u] ? __ffs(mask) - 1 : 0;
      mask &= mask - 1;
      rows[u] = __shfl_sync(full, src, from);
      wk[u] = __shfl_sync(full, ws, from);
    }
    float v[PROBE_GATHER_UNROLL][VEC];
#pragma unroll
    for (int u = 0; u < PROBE_GATHER_UNROLL; ++u) {
      probe_load_row<T, VEC>(x + (int64_t)rows[u] * F + col, take[u] && active, v[u]);
    }
#pragma unroll
    for (int u = 0; u < PROBE_GATHER_UNROLL; ++u) {
      if (take[u]) {
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          acc[e] = __fadd_rn(acc[e], __fmul_rn(wk[u], v[u][e]));
        }
      }
    }
  }
}

// One warp computes row i of out [n, F]: for each chunk of 32*VEC columns,
// the row's `slots` slots in passes of 32, lane j taking slot p0 + j;
// slot(s, src, ws) says whether slot s is summed and, if so, sets its
// source row and weight.  Then the ballot walk above, and one store.
template <typename T, int VEC, typename Slot>
__device__ __forceinline__ void probe_warp_gather_row(const T* __restrict__ x,
                                                      float* __restrict__ out,
                                                      int64_t i, int F, int slots,
                                                      Slot slot) {
  const int lane = threadIdx.x & 31;
  for (int c0 = 0; c0 < F; c0 += 32 * VEC) {
    const int col = c0 + lane * VEC;
    const bool active = col < F;
    float acc[VEC];
#pragma unroll
    for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
    for (int p0 = 0; p0 < slots; p0 += 32) {
      const int s = p0 + lane;
      int src = 0;
      float ws = 0.0f;
      const bool on = s < slots && slot(s, src, ws);
      probe_ballot_sum<T, VEC>(__ballot_sync(0xffffffffu, on), src, ws, x, F, col, active,
                               acc);
    }
    if (active) {
      float* dst = out + i * F + col;
      if constexpr (VEC == 4) {
        *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
      } else {
        dst[0] = acc[0];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// window_warp_gather (P1, P2)
//
// Replaces experiments/gather_probe.py::_kernel (pallas_call in
// proto_block_ell) and experiments/gather_probe2.py::_kernel (pallas_call in
// proto).  It computes
//   out[i, c] = sum_j w[i, j] * xpad[bi*B + lidx[i, j], c],   bi = i / B,
// over the slots with 0 <= lidx < B + 2*Wp, in slot order, where xpad is x
// with Wp zero rows before and after (no wrap: the probes clip their
// graphs).  The local index is relative to the receiver's B-row block
// window, so a row may read anywhere in it.  x is float32, or bfloat16
// stored and summed in float32: the TPU's "default" precision truncated x
// to bf16 inside the MXU, which here is a bf16 array and half the bytes.
//
// Bound on this card: bytes.  The function reads xpad once, the [n, d]
// int32 + float32 tables once and writes y once: (n + 2*Wp)*F*el + n*F*4 +
// n*d*8 bytes, against 2*n*d*F operations (~3-6 us at 67 TFLOP/s).  At the
// probes' n = 99,840, F = 128, d = 8: 0.0325 ms in float32 at Wp = 256,
// 0.0248 in bf16; 0.0344 at d = 16 (3.35 TB/s).
//
// Design.  Nothing is staged: staging the block's window would read its
// rows (B + 2*Wp) / B times (2-3x) in column tiles that each re-read the
// table, and the sums would wait on the staging.  At the probes' sizes x
// is 51 MB in float32 (about the 50 MB L2) and 26 MB in bf16, and every sender lies
// within +-Wp of its receiver, so a gather reads x from device memory about
// once and its d-fold reuse from L2, as K1's gather and P4's do.  One warp
// owns one receiver row; its lanes load the row's d slots once, 32 a pass
// in coalesced 4-byte loads, and the ballot walk above sums the in-window
// slots.  At F = 128 and VEC = 4 one pass of the warp reads the whole row
// (512 bytes in float32, 256 in bf16); no column tiles, so the table is
// read once.  VEC = 1 takes F % 4 != 0 and misaligned operands, walking
// rows wider than 32 columns in chunks of 32, each re-reading the table
// (from L1).
template <typename T, int VEC>
__global__ void __launch_bounds__(PROBE_GATHER_THREADS)
window_warp_gather_kernel(const T* __restrict__ xpad, const int* __restrict__ lidx,
                          const float* __restrict__ w, float* __restrict__ out,
                          int n, int F, int d, int B, int Wp) {
  const int i = blockIdx.x * (PROBE_GATHER_THREADS / 32) + (threadIdx.x >> 5);
  if (i >= n) return;                             // the whole warp
  const int row0 = i / B * B;
  const int win_rows = B + 2 * Wp;
  const int* lrow = lidx + (int64_t)i * d;
  const float* wrow = w + (int64_t)i * d;
  // a slot is summed if its window row lies in the window
  probe_warp_gather_row<T, VEC>(xpad, out, i, F, d, [&](int s, int& src, float& ws) {
    const int l = __ldg(lrow + s);
    if ((unsigned)l >= (unsigned)win_rows) return false;
    src = row0 + l;
    ws = __ldg(wrow + s);
    return true;
  });
}

// ---------------------------------------------------------------------------
// panel_ell_gather (P4)
//
// Replaces experiments/panel_ell_probe.py::_panel_kernel (pallas_call in
// panel_spmm).  With the block's window xwin_i[t] = x[(bi*B - Wp + t) mod n],
// t in [0, B + 2*Wp), cut into 128-row panels, it computes
//   out[i, c] = sum_s wgt[i, s] * x[(bi*B - Wp + (s / W_P)*128 + idx[i, s]) mod n, c]
// over the slots s in [0, n_panels*W_P) with 0 <= idx < 128 (idx = -1 marks
// an empty slot), in slot order.  The tables are build_panel_tables' as
// they are.
//
// Bound on this card: bytes.  x read once and y written once (2*n*F*4) plus
// the [n, n_panels*W_P] int32 + float32 tables (n*slots*8), against
// 2*n*(filled slots)*F operations.  At n = 100,352, F = 128 that is 0.0364,
// 0.0393 and 0.0422 ms at 24, 36 and 48 slots (3.35 TB/s).  The table is
// 3-6x K1's: the bucketing that cut the TPU's one-hot build costs bytes
// here.
//
// Design.  Nothing is staged: at the probe's size x (51 MB) is about the
// size of the 50 MB L2, and K1's gather (csrc/block_ell_gather.cu) beat a
// staged ring there.  One warp owns one receiver row.  Its lanes load the
// row's slot table once, for all of F, 32 slots a pass in coalesced 4-byte
// loads (lane j takes slot p0 + j), and each lane turns its slot into a
// source row; the ballot walk above sums the filled slots.  Empty slots
// (2/3 to 5/6 of build_panel_tables' slots at d = 8) cost no load of x and
// no add.  At F = 128 and VEC = 4 the warp reads the 512-byte row in one
// coalesced pass.  VEC = 1 takes rows that are not whole 16-byte pieces or
// misaligned operands; rows wider than 32*VEC columns are walked in chunks
// of that width, each re-reading the table (from L1).
template <int VEC>
__global__ void __launch_bounds__(PROBE_GATHER_THREADS)
panel_ell_gather_kernel(const float* __restrict__ x, const int* __restrict__ idx,
                        const float* __restrict__ wgt, float* __restrict__ out,
                        int n, int F, int slots, int W_P, int B, int Wp) {
  const int i = blockIdx.x * (PROBE_GATHER_THREADS / 32) + (threadIdx.x >> 5);
  if (i >= n) return;                             // the whole warp
  const int first = i / B * B - Wp;
  const int* irow = idx + (int64_t)i * slots;
  const float* wrow = wgt + (int64_t)i * slots;
  // a slot is summed if filled; its source row is taken mod n (one wrap)
  probe_warp_gather_row<float, VEC>(x, out, i, F, slots, [&](int s, int& src, float& ws) {
    const int k = __ldg(irow + s);
    if ((unsigned)k >= (unsigned)PROBE_PANEL) return false;
    int q = first + s / W_P * PROBE_PANEL + k;
    if (q < 0) {
      q += n;
    } else if (q >= n) {
      q -= n;
    }
    src = q;
    ws = __ldg(wrow + s);
    return true;
  });
}

// ---------------------------------------------------------------------------
// banded_spmm_cols (P5a): the earlier body
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
// This is P5a's earlier body.  P5a runs K4's ring in its column-weight
// mode (csrc/banded_stream.cu banded_stream_cols_launch); this body takes
// the rows that are not whole 16-byte pieces and misaligned operands
// (ops/probe_kernels.py _banded_cols_window_launch).
// Design: K4's earlier tiling (ops/banded.py tile_shape, the caller's), so the two
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
  probe_stage(win, x, r0 - Wp, rows + 2 * Wp, n, F, c0, cols, tile_cols);
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
// w float32 [n_rows, d], out float32 [n_rows, F]; B divides n_rows.  vec 4
// needs F % 4 == 0, xpad aligned to 4 elements (16 bytes in float32, 8 in
// bfloat16) and out 16-byte aligned, else vec 1.  One warp a row.
extern "C" int window_warp_gather_launch(const void* xpad, const void* lidx,
                                         const void* w, void* out, int n_rows,
                                         int F, int d, int B, int Wp, int vec,
                                         int dtype, void* stream) {
  const int el = dtype == 1 ? 2 : 4;
  if (n_rows < 1 || F < 1 || d < 1 || B < 1 || Wp < 0 || n_rows % B != 0 ||
      (dtype != 0 && dtype != 1) || (vec != 1 && vec != 4) ||
      (vec == 4 && (F % 4 || ((uintptr_t)xpad & (4 * el - 1)) ||
                    ((uintptr_t)out & 15)))) {
    return (int)cudaErrorInvalidValue;
  }
  const int rows_per_block = PROBE_GATHER_THREADS / 32;
  const int blocks = (n_rows + rows_per_block - 1) / rows_per_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* li = static_cast<const int*>(lidx);
  const float* wf = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  if (dtype == 0) {
    const float* xf = static_cast<const float*>(xpad);
    if (vec == 4) {
      window_warp_gather_kernel<float, 4><<<blocks, PROBE_GATHER_THREADS, 0, s>>>(
          xf, li, wf, o, n_rows, F, d, B, Wp);
    } else {
      window_warp_gather_kernel<float, 1><<<blocks, PROBE_GATHER_THREADS, 0, s>>>(
          xf, li, wf, o, n_rows, F, d, B, Wp);
    }
  } else {
    const __nv_bfloat16* xb = static_cast<const __nv_bfloat16*>(xpad);
    if (vec == 4) {
      window_warp_gather_kernel<__nv_bfloat16, 4><<<blocks, PROBE_GATHER_THREADS, 0, s>>>(
          xb, li, wf, o, n_rows, F, d, B, Wp);
    } else {
      window_warp_gather_kernel<__nv_bfloat16, 1><<<blocks, PROBE_GATHER_THREADS, 0, s>>>(
          xb, li, wf, o, n_rows, F, d, B, Wp);
    }
  }
  return (int)cudaGetLastError();
}

// x and out float32 [n, F]; idx int32 and wgt float32 [n, slots] with
// slots = ((B + 2*Wp) / 128) * W_P; B divides n, B + 2*Wp <= n.  vec 4
// needs F % 4 == 0 and 16-byte aligned x and out, else vec 1.  One warp a
// row.
extern "C" int panel_ell_gather_launch(const void* x, const void* idx,
                                       const void* wgt, void* out, int n,
                                       int F, int slots, int W_P, int B,
                                       int Wp, int vec, void* stream) {
  if (n < 1 || F < 1 || W_P < 1 || B < 1 || Wp < 0 || n % B != 0 ||
      B + 2 * Wp > n || (B + 2 * Wp) % PROBE_PANEL != 0 ||
      slots != (B + 2 * Wp) / PROBE_PANEL * W_P || (vec != 1 && vec != 4) ||
      (vec == 4 && (F % 4 || (((uintptr_t)x | (uintptr_t)out) & 15)))) {
    return (int)cudaErrorInvalidValue;
  }
  const int rows_per_block = PROBE_GATHER_THREADS / 32;
  const int blocks = (n + rows_per_block - 1) / rows_per_block;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const int* ii = static_cast<const int*>(idx);
  const float* wf = static_cast<const float*>(wgt);
  float* of = static_cast<float*>(out);
  if (vec == 4) {
    panel_ell_gather_kernel<4><<<blocks, PROBE_GATHER_THREADS, 0, s>>>(
        xf, ii, wf, of, n, F, slots, W_P, B, Wp);
  } else {
    panel_ell_gather_kernel<1><<<blocks, PROBE_GATHER_THREADS, 0, s>>>(
        xf, ii, wf, of, n, F, slots, W_P, B, Wp);
  }
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
