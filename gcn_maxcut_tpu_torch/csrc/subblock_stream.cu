// P3's sub-blocked SpMM streamed through a shared-memory ring, for Hopper
// (sm_90a).
//
// Replaces experiments/subblock_probe.py::_sub_kernel (pallas_call in
// sub_spmm).  With R0-row sub-blocks (R0 = 128, or B when 128 does not
// divide B; ops/block_ell.py sub_block_rows) it computes
//   out[i, c] = sum_j w[i, j] * x[sidx[i, j], c]      (j = 0 .. d-1)
// over the slots whose sender lies in row i's sub-block slice, the rows
// [k*R0 - Wp, k*R0 + R0 + Wp) taken mod n for i in sub-block k, in slot
// order.  Other slots are skipped, as the TPU's one-hot matched nothing
// for them.
//
// Bound on this card: bytes.  The function reads x once, the [n, d] int32
// + float32 table once and writes y once: 2*n*F*4 + n*d*8 bytes, against
// 2*n*d*F float operations.  At the probe's n = 100,352, F = 128, d = 8
// that is ~109 MB, ~0.033 ms at 3.35 TB/s.
//
// Design.  Staging each sub-block's R0 + 2*Wp slice on its own would read
// x (R0 + 2*Wp) / R0 times, 5x at Wp = 256 and 9x at Wp = 512, and the
// sums would wait on it.  So this is K4's ring (csrc/banded_stream.cu)
// with a table lookup in place of fixed
// offsets.  A block owns one column tile of fc columns and a strip of S
// consecutive sub-blocks.  Shared memory holds a ring of R >= 2*R0 + 2*Wp
// source rows: the current sub-block's slice and the next sub-block's R0
// new rows, in flight behind it.  Strip-local row t (source row
// s0 - Wp + t, taken mod n) lives in ring slot t mod R; each row piece is
// its own cp.async copy, so the wrap at row n - 1 -> 0 needs no tile.
// Sub-block k reads only its slice from the ring, as P3's design says;
// consecutive slices share their rows instead of being staged again, so x
// is read (S*R0 + 2*Wp) / (S*R0) times.  Each sub-block's [R0, d] table
// slice rides beside the ring in two buffers, like K4's weights.
//
// What holds it back is the sums, not device memory: each output row reads
// d ring rows from shared memory, the sums take 56-62% of a sub-block's
// time and the wait for its copies 27-30% (tools/trace_subblock_stream.py,
// PERF.md), and a ring with two sub-blocks in flight gained nothing.  So
// the sums do as little as they can a slot.  When a sub-block's table has
// landed, the block turns each (sender id, weight) into a (ring slot,
// weight) pair, the slot -1 outside the slice, so a slot costs one 8-byte
// shared load and no mod or slice test (which every column group of a row
// would otherwise redo); the sum is branch-free, so the loads of later
// slots can be issued early; a block has up to SSTREAM_MAX_THREADS
// threads, one a (row, column group), so that one block an SM (ring and
// tables take 184-216 KiB at the probe's shapes) still has 16 warps; and
// with a 32- or 64-column tile each 16-byte shared load of a quarter warp
// reads one row's 128 consecutive bytes, free of bank conflicts.  The
// geometry is ops/probe_kernels.py subblock_stream_shape's, chosen by
// tools/sweep_subblock_stream.py.
//
// A thread owns VEC adjacent columns of one row: VEC = 4 (16-byte copies,
// shared loads and stores) when F % 4 == 0 and x and out are 16-byte
// aligned, else VEC = 1 (4-byte copies), in the same kernel.  Sums are
// float32 in slot order from 0 with separate multiply and add roundings:
// the order and the arithmetic of the plain PyTorch version
// (ops/probe_kernels.py subblock_spmm_plain), so results agree with it bit
// for bit.  No TMA or wgmma: there is no matrix product here.

#include <cuda_runtime.h>
#include <stdint.h>

#define SSTREAM_MAX_THREADS 512

__device__ __forceinline__ void sstream_cp16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void sstream_cp4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void sstream_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void sstream_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Bytes of one table array of a sub-block (r0 * d 4-byte values), rounded
// up to 16 so that every array starts 16-byte aligned.
__host__ __device__ __forceinline__ size_t sstream_table_bytes(int r0, int d) {
  return ((size_t)r0 * d * 4 + 15) / 16 * 16;
}
__host__ __device__ __forceinline__ size_t sstream_ring_bytes(int ring_rows, int fc) {
  return ((size_t)ring_rows * fc * 4 + 15) / 16 * 16;
}
// The ring, two buffers of a sub-block's sender ids and weights, and the
// sub-block's (slot, weight) pairs.  ops/probe_kernels.py
// subblock_stream_smem_bytes computes the same sum.
static size_t sstream_smem_bytes(int ring_rows, int fc, int r0, int d) {
  return sstream_ring_bytes(ring_rows, fc) + 6 * sstream_table_bytes(r0, d);
}

// One block an SM of the most threads: ptxas may give a thread the
// registers it needs (capped for more blocks, a variant spilled).
template <int VEC>
__global__ void __launch_bounds__(SSTREAM_MAX_THREADS, 1)
subblock_stream_kernel(const float* __restrict__ x, const int* __restrict__ sidx,
                       const float* __restrict__ w, float* __restrict__ out,
                       int n, int F, int d, int Wp, int r0, int strip, int fc,
                       int ring_rows) {
  extern __shared__ __align__(16) unsigned char sstream_smem[];
  float* ring = reinterpret_cast<float*>(sstream_smem);
  unsigned char* tables = sstream_smem + sstream_ring_bytes(ring_rows, fc);
  const size_t tb = sstream_table_bytes(r0, d);
  int2* pairs = reinterpret_cast<int2*>(tables + 4 * tb);

  const int sub0 = blockIdx.x * strip;            // the strip's first sub-block
  const int subs = min(strip, n / r0 - sub0);
  const int s0 = sub0 * r0;                       // its first row
  const int c0 = blockIdx.y * fc;
  const int cols = min(fc, F - c0);
  const int slice_rows = r0 + 2 * Wp;
  const int need = subs * r0 + 2 * Wp;            // strip-local rows read

  // Each thread keeps one column group and one row phase for the whole run.
  const int threads = blockDim.x;
  const int groups = fc / VEC;
  const int row_step = threads / groups;
  const int my_row = threadIdx.x / groups;
  const int col = (threadIdx.x - my_row * groups) * VEC;
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
      float* dst = ring + (size_t)(t % ring_rows) * fc + col;
      const float* src = x + (int64_t)q * F + c0 + col;
      if constexpr (VEC == 4) {
        sstream_cp16(dst, src);
      } else {
        sstream_cp4(dst, src);
      }
    }
  };
  // Sub-block j's table slice: r0 * d sender ids and r0 * d weights, each
  // one contiguous run, into buffer j & 1.
  auto load_table = [&](int j) {
    const int64_t e0 = (int64_t)(s0 + j * r0) * d;
    const int count = r0 * d;
    const int* si = sidx + e0;
    const float* sw = w + e0;
    unsigned char* buf = tables + (size_t)(j & 1) * 2 * tb;
    int* di = reinterpret_cast<int*>(buf);
    float* dw = reinterpret_cast<float*>(buf + tb);
    if (((((uintptr_t)si) | ((uintptr_t)sw)) & 15) == 0 && count % 4 == 0) {
      for (int e = threadIdx.x * 4; e < count; e += threads * 4) {
        sstream_cp16(di + e, si + e);
        sstream_cp16(dw + e, sw + e);
      }
    } else {
      for (int e = threadIdx.x; e < count; e += threads) {
        sstream_cp4(di + e, si + e);
        sstream_cp4(dw + e, sw + e);
      }
    }
  };

  // Prologue: sub-block 0's whole slice and table, one commit group.
  load_rows(0, slice_rows);
  load_table(0);
  sstream_commit();

  int base = 0;                                   // ring slot of t = j * r0
  for (int j = 0; j < subs; ++j) {
    if (j + 1 < subs) {
      // These slots held sub-block j - 1's first rows, done at the last
      // barrier; the table buffer was sub-block j - 1's.
      load_rows((j + 1) * r0 + 2 * Wp, (j + 2) * r0 + 2 * Wp);
      load_table(j + 1);
    }
    sstream_commit();
    sstream_wait<1>();                            // sub-block j's group has landed
    __syncthreads();

    // Each (sender id, weight) becomes a (ring slot, weight) pair, the slot
    // -1 outside the slice, read by the sums as one 8-byte load.
    const int row0 = s0 + j * r0;
    const unsigned char* buf = tables + (size_t)(j & 1) * 2 * tb;
    const int* ti = reinterpret_cast<const int*>(buf);
    const float* tw = reinterpret_cast<const float*>(buf + tb);
    for (int e = threadIdx.x; e < r0 * d; e += threads) {
      // the sender's row in this sub-block's slice, from its id mod n
      int l = ti[e] - row0 + Wp;
      if (l < 0) {
        l += n;
      } else if (l >= n) {
        l -= n;
      }
      int slot = base + l;
      if (slot >= ring_rows) slot -= ring_rows;
      pairs[e] = make_int2((unsigned)l < (unsigned)slice_rows ? slot : -1,
                           __float_as_int(tw[e]));
    }
    __syncthreads();

    if (active) {
      for (int i = my_row; i < r0; i += row_step) {
        float acc[VEC];
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[v] = 0.0f;
        // Branch-free, so that the loads of later slots can be issued
        // early: a slot outside the slice reads ring row 0 and keeps acc.
#pragma unroll 4
        for (int jj = 0; jj < d; ++jj) {
          const int2 e = pairs[i * d + jj];
          const bool in = e.x >= 0;
          const float wk = __int_as_float(e.y);
          const float* v = ring + (size_t)(in ? e.x : 0) * fc + col;
          if constexpr (VEC == 4) {
            const float4 f = *reinterpret_cast<const float4*>(v);
            acc[0] = in ? __fadd_rn(acc[0], __fmul_rn(wk, f.x)) : acc[0];
            acc[1] = in ? __fadd_rn(acc[1], __fmul_rn(wk, f.y)) : acc[1];
            acc[2] = in ? __fadd_rn(acc[2], __fmul_rn(wk, f.z)) : acc[2];
            acc[3] = in ? __fadd_rn(acc[3], __fmul_rn(wk, f.w)) : acc[3];
          } else {
            acc[0] = in ? __fadd_rn(acc[0], __fmul_rn(wk, v[0])) : acc[0];
          }
        }
        float* dst = out + (int64_t)(row0 + i) * F + c0 + col;
        if constexpr (VEC == 4) {
          *reinterpret_cast<float4*>(dst) = make_float4(acc[0], acc[1], acc[2], acc[3]);
        } else {
          dst[0] = acc[0];
        }
      }
    }
    base += r0;
    if (base >= ring_rows) base -= ring_rows;
    __syncthreads();                              // sub-block j's slots are free
  }
  sstream_wait<0>();
}

typedef void (*SStreamKernel)(const float*, const int*, const float*, float*, int, int,
                              int, int, int, int, int, int);

// The kernel for vec 1 or 4, else null.
static SStreamKernel sstream_kernel(int vec) {
  if (vec == 1) return subblock_stream_kernel<1>;
  if (vec == 4) return subblock_stream_kernel<4>;
  return nullptr;
}

// The kernel may take smem_bytes of dynamic shared memory, and its SMs
// keep their whole shared memory (not L1) so that as many blocks fit as
// subblock_stream_shape counts.
static int sstream_attributes(SStreamKernel kernel, int smem_bytes) {
  cudaError_t err = cudaFuncSetAttribute((const void*)kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute((const void*)kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  }
  return (int)err;
}

// Plain C entry point, bound with ctypes.  x and out float32 [n, F], sidx
// int32 and w float32 [n, d], all contiguous on the device; r0 divides n
// and r0 + 2*Wp <= n.  vec 4 needs F % 4 == 0 and 16-byte aligned x and
// out.  The geometry (strip: sub-blocks a strip; fc: columns a tile;
// ring_rows; threads: a block's, a multiple of 32) and smem_bytes come from
// ops/probe_kernels.py subblock_stream_shape; smem_bytes must equal what
// the kernel uses.  Returns the cudaError_t of
// the launch (0 on success).
extern "C" int subblock_stream_launch(const void* x, const void* sidx,
                                      const void* w, void* out, int n, int F,
                                      int d, int Wp, int r0, int vec, int strip,
                                      int fc, int ring_rows, int threads,
                                      int smem_bytes, void* stream) {
  const SStreamKernel kernel = sstream_kernel(vec);
  if (kernel == nullptr || n < 1 || F < 1 || d < 1 || Wp < 0 || r0 < 1 || n % r0 ||
      r0 + 2 * Wp > n || strip < 1 || fc < vec || threads < 32 ||
      threads > SSTREAM_MAX_THREADS || threads % 32 || fc % vec || fc / vec > threads ||
      ring_rows < 2 * r0 + 2 * Wp ||
      (size_t)smem_bytes != sstream_smem_bytes(ring_rows, fc, r0, d) ||
      (vec == 4 && (F % 4 || (((uintptr_t)x | (uintptr_t)out) & 15)))) {
    return (int)cudaErrorInvalidValue;
  }
  const int err = sstream_attributes(kernel, smem_bytes);
  if (err) return err;
  dim3 grid((n / r0 + strip - 1) / strip, (F + fc - 1) / fc);
  kernel<<<grid, threads, smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const int*>(sidx),
      static_cast<const float*>(w), static_cast<float*>(out), n, F, d, Wp, r0, strip, fc,
      ring_rows);
  return (int)cudaGetLastError();
}

// Blocks of the kernel (vec, threads as for the launch) with smem_bytes of
// dynamic shared memory that one SM of the current device holds at once,
// into *blocks; returns the cudaError_t (0 on success).
extern "C" int subblock_stream_blocks_per_sm(int vec, int threads, int smem_bytes,
                                             int* blocks) {
  const SStreamKernel kernel = sstream_kernel(vec);
  if (kernel == nullptr) return (int)cudaErrorInvalidValue;
  const int err = sstream_attributes(kernel, smem_bytes);
  if (err) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads,
                                                            smem_bytes);
}
