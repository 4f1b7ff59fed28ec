// The packed giant trainer's head and cut loss, for Hopper (sm_90a): one
// pass from K3's output of the second layer to the one-hot that K3 reads
// for the loss, a pass for the loss's dot, and one pass back to the
// cotangent that K3's adjoint reads for the second layer.
//
// Replaces no TPU kernel.  The JAX package writes the head as array code
// that XLA fuses (gcn_maxcut_tpu/bench/giant_demo.py:304-326).  The port ran
// it as PyTorch: some twenty passes over [n, 16] float32 arrays forward
// (casts, scaling, bias, masked max, exp, row sum, division, the pin's cat,
// a second max, the straight-through one-hot, the dot) and about as many
// backward, with two 16-lane row reductions each way.
//
// Function (ops/group_head.py group_head_cut_plain is its plain version).
// z [n, 16] is K3's output of the second layer, in the streams' dtype
// (bfloat16 or float32), b2 [16] float32, inv_d = 1/d, k <= 16 classes, and
// the first k rows are the terminals.  For every row:
//   h  = float(z) * inv_d + b2
//   m  = max over lanes of (h on lanes c < k, h + -1e9 on the others)
//   e  = exp(h - m) on lanes c < k, 0 on the others
//   p  = e / (sum of e)
//   S  = 1 on the lanes c < k where p equals the row's largest p (ties set
//        several lanes), else 0; terminal row i < k: 1 on lane i alone.
// group_head_kernel writes S, exactly 0 or 1, in z's dtype, for K3.  The
// row sum runs in torch.sum's order for a 16-wide row on the card (lanes
// folded by 8, 4, 2, 1, as ATen's shuffles down fold them), and every
// operation is rounded on its own (the intrinsics are never contracted into
// FMAs; expf is the accurate one), so p is the composition's bit for bit
// and S is exactly what onehot.to(dtype) gave.  A row whose softmax is not
// finite sets no lane, as the composition's straight-through max does; a
// padding lane whose exp would overflow gives 0 here, where the
// composition's exp(.) * 0 gives NaN.
//
// cut_dot_kernel sums <S, Y> over every element, Y = K3(S) in the same
// dtype.  S is 0 or 1 and Y a count of neighbours, so every product is a
// small integer: the products are summed as 64-bit integers, exactly and
// in any order, and converted to float32 once.
//
// group_head_backward_kernel, from the loss's cotangent g (a float32 on the
// device), Y and At = K3's adjoint of S (the same launch the composition
// made on g*S: A^T(g*S) = g*(A^T S) bit for bit when g is a power of two,
// as the loss's 1/2 is), per row:
//   G   = g*Y + g*At              (pin and straight-through pass G to p)
//   g_h = p * (G - <G, p>) on lanes c < k, <G, p> summed over c < k in
//         lane order; 0 on the others
//   dz  = g_h * inv_d, rounded once to z's dtype
// and b2's gradient, the sum of g_h over all rows: each thread sums its
// rows in order, each block its threads in a fixed tree into one row of
// `partials`, and the block that finishes last (a ticket: a zeroed counter
// of the blocks done) sums the blocks' rows in block order.  No float
// atomics: for one n on one card the sums run in one order on every call.
//
// Bound on this card: bytes.  At the giant's n = 10,002,432 with bfloat16
// streams: the forward reads z and writes S (640 MB), the dot reads S and Y
// (640 MB), the backward reads z, Y, At and writes dz (1.28 GB): 2.56 GB,
// 0.76 ms at 3.35 TB/s.  The design gives each thread whole 16-lane rows,
// loaded and stored as 16-byte pieces (2 a bfloat16 row, 4 a float32 one),
// so each row's softmax stays in registers; the 16 expf of a row cost far
// less than its bytes.  The dot and the backward stride over the rows with
// the grid the caller gives (ops/group_head.py: at most 8 blocks an SM,
// one wave at full occupancy), so their partial sums are few.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#define GH_LANES 16
#define GH_THREADS 256
#define GH_WARPS (GH_THREADS / 32)

// A row of 16 values, widened to float.
__device__ __forceinline__ void gh_load(const float* p, float (&v)[GH_LANES]) {
  const float4* q = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float4 a = q[i];
    v[4 * i] = a.x;
    v[4 * i + 1] = a.y;
    v[4 * i + 2] = a.z;
    v[4 * i + 3] = a.w;
  }
}
__device__ __forceinline__ void gh_load(const __nv_bfloat16* p, float (&v)[GH_LANES]) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const uint4 a = q[i];
    const unsigned u[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {   // the lower address holds the lower half
      v[8 * i + 2 * e] = __uint_as_float(u[e] << 16);
      v[8 * i + 2 * e + 1] = __uint_as_float(u[e] & 0xffff0000u);
    }
  }
}

// A row stored in the output's dtype, each value rounded once.
__device__ __forceinline__ void gh_store(float* p, const float (&v)[GH_LANES]) {
  float4* q = reinterpret_cast<float4*>(p);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    q[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2], v[4 * i + 3]);
  }
}
__device__ __forceinline__ void gh_store(__nv_bfloat16* p, const float (&v)[GH_LANES]) {
  uint4* q = reinterpret_cast<uint4*>(p);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    unsigned u[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[8 * i + 2 * e], v[8 * i + 2 * e + 1]);
      u[e] = *reinterpret_cast<const unsigned*>(&h);
    }
    q[i] = make_uint4(u[0], u[1], u[2], u[3]);
  }
}

// torch.amax's max: a NaN wins.
__device__ __forceinline__ float gh_max(float a, float b) { return (b > a || b != b) ? b : a; }

// The row's softmax p over lanes c < k, 0 on the others (see the top).
__device__ __forceinline__ void gh_probs(const float (&z)[GH_LANES], const float (&b2)[GH_LANES],
                                         float inv_d, int k, float (&p)[GH_LANES]) {
  float h[GH_LANES];
  float m = 0.0f;
#pragma unroll
  for (int c = 0; c < GH_LANES; ++c) {
    h[c] = __fadd_rn(__fmul_rn(z[c], inv_d), b2[c]);
    const float v = c < k ? h[c] : __fadd_rn(h[c], -1e9f);
    m = c == 0 ? v : gh_max(m, v);
  }
  float e[GH_LANES], t[GH_LANES];
#pragma unroll
  for (int c = 0; c < GH_LANES; ++c) {
    e[c] = c < k ? expf(__fsub_rn(h[c], m)) : 0.0f;
    t[c] = e[c];
  }
#pragma unroll
  for (int w = GH_LANES / 2; w > 0; w >>= 1) {
#pragma unroll
    for (int c = 0; c < w; ++c) t[c] = __fadd_rn(t[c], t[c + w]);
  }
#pragma unroll
  for (int c = 0; c < GH_LANES; ++c) p[c] = c < k ? __fdiv_rn(e[c], t[0]) : 0.0f;
}

__device__ __forceinline__ void gh_bias(const float* b2, float (&b)[GH_LANES]) {
#pragma unroll
  for (int c = 0; c < GH_LANES; ++c) b[c] = __ldg(b2 + c);
}

// The forward: a thread a row.
template <typename T>
__global__ void __launch_bounds__(GH_THREADS)
    group_head_kernel(const T* __restrict__ z, const float* __restrict__ b2, T* __restrict__ s,
                      long long n, int k, float inv_d) {
  const long long row = (long long)blockIdx.x * GH_THREADS + threadIdx.x;
  if (row >= n) return;
  float out[GH_LANES];
  if (row < k) {
#pragma unroll
    for (int c = 0; c < GH_LANES; ++c) out[c] = c == row ? 1.0f : 0.0f;
  } else {
    float b[GH_LANES], v[GH_LANES], p[GH_LANES];
    gh_bias(b2, b);
    gh_load(z + row * GH_LANES, v);
    gh_probs(v, b, inv_d, k, p);
    float top = p[0];
#pragma unroll
    for (int c = 1; c < GH_LANES; ++c) top = gh_max(top, p[c]);
#pragma unroll
    for (int c = 0; c < GH_LANES; ++c) out[c] = (c < k && p[c] >= top) ? 1.0f : 0.0f;
  }
  gh_store(s + row * GH_LANES, out);
}

// The dot, grid-strided over the rows; the last block to finish
// writes the total.
template <typename T>
__global__ void __launch_bounds__(GH_THREADS)
    cut_dot_kernel(const T* __restrict__ s, const T* __restrict__ y, long long n,
                   long long* __restrict__ partials, unsigned* __restrict__ ticket,
                   float* __restrict__ out) {
  __shared__ long long red[GH_WARPS];
  __shared__ bool last;
  long long acc = 0;
  for (long long row = (long long)blockIdx.x * GH_THREADS + threadIdx.x; row < n;
       row += (long long)gridDim.x * GH_THREADS) {
    float a[GH_LANES], b[GH_LANES];
    gh_load(s + row * GH_LANES, a);
    gh_load(y + row * GH_LANES, b);
    int t = 0;
#pragma unroll
    for (int c = 0; c < GH_LANES; ++c) t += __float2int_rn(__fmul_rn(a[c], b[c]));
    acc += t;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long v = 0;
    for (int w = 0; w < GH_WARPS; ++w) v += red[w];
    partials[blockIdx.x] = v;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  long long v = 0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += GH_THREADS) v += __ldcg(partials + b);
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    long long total = 0;
    for (int w = 0; w < GH_WARPS; ++w) total += red[w];
    *out = __ll2float_rn(total);
  }
}

// The backward, grid-strided over the rows; the last block to
// finish writes b2's gradient.
template <typename T>
__global__ void __launch_bounds__(GH_THREADS)
    group_head_backward_kernel(const T* __restrict__ z, const float* __restrict__ b2,
                               const T* __restrict__ y, const T* __restrict__ at,
                               const float* __restrict__ g, T* __restrict__ dz,
                               float* __restrict__ partials, unsigned* __restrict__ ticket,
                               float* __restrict__ db2, long long n, int k, float inv_d) {
  __shared__ float red[GH_WARPS][GH_LANES];
  __shared__ float fold[GH_THREADS / GH_LANES][GH_LANES];
  __shared__ bool last;
  float b[GH_LANES], acc[GH_LANES];
  gh_bias(b2, b);
#pragma unroll
  for (int c = 0; c < GH_LANES; ++c) acc[c] = 0.0f;
  const float gs = __ldg(g);
  for (long long row = (long long)blockIdx.x * GH_THREADS + threadIdx.x; row < n;
       row += (long long)gridDim.x * GH_THREADS) {
    float v[GH_LANES], p[GH_LANES], G[GH_LANES], a[GH_LANES];
    gh_load(z + row * GH_LANES, v);
    gh_probs(v, b, inv_d, k, p);
    gh_load(y + row * GH_LANES, G);
    gh_load(at + row * GH_LANES, a);
    float dot = 0.0f;
#pragma unroll
    for (int c = 0; c < GH_LANES; ++c) {
      G[c] = __fadd_rn(__fmul_rn(gs, G[c]), __fmul_rn(gs, a[c]));
      if (c < k) dot = __fadd_rn(dot, __fmul_rn(G[c], p[c]));
    }
#pragma unroll
    for (int c = 0; c < GH_LANES; ++c) {
      const float gh = c < k ? __fmul_rn(p[c], __fsub_rn(G[c], dot)) : 0.0f;
      acc[c] = __fadd_rn(acc[c], gh);
      v[c] = __fmul_rn(gh, inv_d);
    }
    gh_store(dz + row * GH_LANES, v);
  }
  // the block's sum of each lane: shuffles down within a warp, then the
  // warps in order
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < GH_LANES; ++c) {
    float v = acc[c];
    for (int off = 16; off > 0; off >>= 1) v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, off));
    if (lane == 0) red[warp][c] = v;
  }
  __syncthreads();
  if (threadIdx.x < GH_LANES) {
    float v = 0.0f;
    for (int w = 0; w < GH_WARPS; ++w) v = __fadd_rn(v, red[w][threadIdx.x]);
    partials[(long long)blockIdx.x * GH_LANES + threadIdx.x] = v;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // the last block: thread (j, c) sums lane c of blocks j, j + 16, ... in
  // order, then lane c's 16 sums are added in order
  const int c = threadIdx.x % GH_LANES, j = threadIdx.x / GH_LANES;
  float v = 0.0f;
  for (int blk = j; blk < (int)gridDim.x; blk += GH_THREADS / GH_LANES) {
    v = __fadd_rn(v, __ldcg(partials + (long long)blk * GH_LANES + c));
  }
  fold[j][c] = v;
  __syncthreads();
  if (threadIdx.x < GH_LANES) {
    float total = 0.0f;
    for (int i = 0; i < GH_THREADS / GH_LANES; ++i) total = __fadd_rn(total, fold[i][threadIdx.x]);
    db2[threadIdx.x] = threadIdx.x < k ? total : 0.0f;
  }
}

static bool gh_aligned(const void* a, const void* b, const void* c = nullptr,
                       const void* d = nullptr, const void* e = nullptr) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(c) | reinterpret_cast<uintptr_t>(d) |
           reinterpret_cast<uintptr_t>(e)) & 15) == 0;
}

// The forward on `stream`: S [n, 16] from z [n, 16] (dtype 0 = float32,
// 1 = bfloat16, both contiguous and 16-byte aligned) and b2 float32 [16],
// for k classes (1..16), the first k rows pinned.  Returns the launch's
// CUDA error (0 when it was accepted).
extern "C" int group_head_launch(const void* z, const void* b2, void* s, long long n, int k,
                                 float inv_d, int dtype, void* stream) {
  if (n < 1 || k < 1 || k > GH_LANES || (dtype != 0 && dtype != 1) || b2 == nullptr ||
      !gh_aligned(z, s)) {
    return (int)cudaErrorInvalidValue;
  }
  const unsigned blocks = (unsigned)((n + GH_THREADS - 1) / GH_THREADS);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    group_head_kernel<float><<<blocks, GH_THREADS, 0, st>>>(
        static_cast<const float*>(z), static_cast<const float*>(b2), static_cast<float*>(s), n,
        k, inv_d);
  } else {
    group_head_kernel<__nv_bfloat16><<<blocks, GH_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(z), static_cast<const float*>(b2),
        static_cast<__nv_bfloat16*>(s), n, k, inv_d);
  }
  return (int)cudaGetLastError();
}

// The dot on `stream`, `grid` blocks: out float32 [1] = <S, Y> over n rows
// of 16 (dtype as above, contiguous and aligned); partials int64 [grid]
// scratch; ticket a zeroed uint32 [1].  Returns the launch's CUDA error.
extern "C" int cut_dot_launch(const void* s, const void* y, long long n, void* partials,
                              int grid, void* ticket, void* out, int dtype, void* stream) {
  if (n < 1 || grid < 1 || (dtype != 0 && dtype != 1) || partials == nullptr ||
      ticket == nullptr || out == nullptr || !gh_aligned(s, y)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    cut_dot_kernel<float><<<grid, GH_THREADS, 0, st>>>(
        static_cast<const float*>(s), static_cast<const float*>(y), n,
        static_cast<long long*>(partials), static_cast<unsigned*>(ticket),
        static_cast<float*>(out));
  } else {
    cut_dot_kernel<__nv_bfloat16><<<grid, GH_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(s), static_cast<const __nv_bfloat16*>(y), n,
        static_cast<long long*>(partials), static_cast<unsigned*>(ticket),
        static_cast<float*>(out));
  }
  return (int)cudaGetLastError();
}

// The backward on `stream`, `grid` blocks: dz [n, 16] (z's dtype) and db2
// float32 [16] from z, b2, Y and At (z's dtype, contiguous and aligned) and
// g float32 [1], for k classes; partials float32 [grid, 16] scratch, ticket
// as for the dot.  Returns the launch's CUDA error.
extern "C" int group_head_backward_launch(const void* z, const void* b2, const void* y,
                                          const void* at, const void* g, void* dz,
                                          void* partials, int grid, void* ticket,
                                          void* db2, long long n, int k, float inv_d, int dtype,
                                          void* stream) {
  if (n < 1 || k < 1 || k > GH_LANES || grid < 1 || (dtype != 0 && dtype != 1) ||
      b2 == nullptr || g == nullptr || partials == nullptr || ticket == nullptr ||
      db2 == nullptr || !gh_aligned(z, y, at, dz)) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    group_head_backward_kernel<float><<<grid, GH_THREADS, 0, st>>>(
        static_cast<const float*>(z), static_cast<const float*>(b2),
        static_cast<const float*>(y), static_cast<const float*>(at),
        static_cast<const float*>(g), static_cast<float*>(dz), static_cast<float*>(partials),
        static_cast<unsigned*>(ticket), static_cast<float*>(db2), n, k, inv_d);
  } else {
    group_head_backward_kernel<__nv_bfloat16><<<grid, GH_THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(z), static_cast<const float*>(b2),
        static_cast<const __nv_bfloat16*>(y), static_cast<const __nv_bfloat16*>(at),
        static_cast<const float*>(g), static_cast<__nv_bfloat16*>(dz),
        static_cast<float*>(partials), static_cast<unsigned*>(ticket),
        static_cast<float*>(db2), n, k, inv_d);
  }
  return (int)cudaGetLastError();
}
