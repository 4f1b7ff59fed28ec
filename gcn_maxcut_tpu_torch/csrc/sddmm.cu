// The cut loss's SDDMM, e[i] = <x[s_i], y[r_i]> * mask_i over the padded
// directed edge list, and its backward, for Hopper (sm_90a).
//
// Replaces no TPU kernel.  The JAX package writes the op as two gathers and
// a row sum (gcn_maxcut_tpu/ops/segment.py sddmm), which XLA fuses, and
// differentiates the gathers into scatter-adds.  The port ran the same
// PyTorch: each gather's backward is index_put_(accumulate=True), a stable
// radix sort of the [e_pad] indices, a zeroed output and a kernel that
// walks every run of equal indices one element after another.  Every padded
// edge slot points at node n_pad - 1 (core/graph.py), so each call walked a
// run of up to ~1,100 padding slots whose gradient is exactly zero.
//
// Function (ops/segment.py sddmm_plain is its plain version).  Forward: for
// every edge slot i < e_pad,
//   e[i] = (sum over c of x[s_i, c] * y[r_i, c]) * mask_i,
// the sum over c in torch.sum's order on the card for rows narrower than
// 128 (ATen's Reduce.cuh: w = min(largest power of two <= k, 32) lanes a
// row; lane l adds its products l, l + w, l + 2w, ... into four
// accumulators, the m-th into accumulator m mod 4, combines them in order,
// then the lanes are summed by shuffles down at offsets w/2, ..., 1).
// Backward, from de [e_pad], for each node u and class c:
//   dx[u, c] = sum over real edges i with s_i = u, ascending i,
//              of (de_i * mask_i) * y[r_i, c]
//   dy[u, c] = sum over real edges i with r_i = u, ascending i,
//              of (de_i * mask_i) * x[s_i, c]
// each summed from 0.  That is the order of the plain backward's stable
// sort, whose accumulate adds the runs of equal indices from 0 in edge
// order.  The real edges of u as a receiver are row_ptr[u] ..
// min(row_ptr[u + 1], n_edges) (receivers are sorted); as a sender, the ids
// sender_order[sender_ptr[u] .. sender_ptr[u + 1]] (ascending, real edges
// only).  The padded slots, from n_edges on, add only (de * 0) * v = +-0,
// which changes no sum other than a zero's sign, so no thread walks them.
// When x and y are one tensor (every cut loss) the gradient is dx + dy,
// written once.  Every product and sum is rounded on its own, as the plain
// version's separate kernels round them (the intrinsics are never
// contracted into FMAs): the results are the plain op's bit for bit, zeros
// up to their sign.
//
// Bound on this card: latency.  At the recipe's shapes (n_pad 504,
// e_pad 4,096, k = 3) a forward and a backward read and write some 176 KB,
// 0.05 us at 3.35 TB/s; what a launch costs is a few dependent loads a thread
// (table, index, row) and the launch itself.  The design gives the forward
// w lanes an edge and the backward one thread a (node, class) pair, which
// owns its output and sums its own edges: no sort, no zeroed output, no
// atomics, and one launch each way.

#include <cuda_runtime.h>

#define SDDMM_THREADS 256
#define SDDMM_BACKWARD_THREADS 128

// The forward.  Lanes of one edge are adjacent in a warp; every lane of the
// warp reaches the shuffles, including lanes past the last edge.
__global__ void __launch_bounds__(SDDMM_THREADS)
    sddmm_forward_kernel(const float* __restrict__ x, const float* __restrict__ y,
                         const int* __restrict__ senders, const int* __restrict__ receivers,
                         const float* __restrict__ edge_mask, float* __restrict__ out,
                         int e_pad, int k, int w) {
  const long long t = (long long)blockIdx.x * SDDMM_THREADS + threadIdx.x;
  const long long i = t / w;
  const int lane = (int)(t - i * w);
  float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
  if (i < e_pad) {
    const float* xr = x + (long long)senders[i] * k;
    const float* yr = y + (long long)receivers[i] * k;
    int m = 0;
    for (int c = lane; c < k; c += w, ++m) {
      const float p = __fmul_rn(xr[c], yr[c]);
      switch (m & 3) {
        case 0: a0 = __fadd_rn(a0, p); break;
        case 1: a1 = __fadd_rn(a1, p); break;
        case 2: a2 = __fadd_rn(a2, p); break;
        default: a3 = __fadd_rn(a3, p);
      }
    }
  }
  float v = __fadd_rn(__fadd_rn(__fadd_rn(a0, a1), a2), a3);
  for (int offset = w >> 1; offset > 0; offset >>= 1) {
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, offset, w));
  }
  if (i < e_pad && lane == 0) out[i] = __fmul_rn(v, edge_mask[i]);
}

// The backward: thread t = u * k + c owns dx[u, c] and dy[u, c].  dx (and
// y) or dy (and x) is null when that gradient is not wanted; `same` (dy
// null) writes dx + dy into dx.
__global__ void __launch_bounds__(SDDMM_BACKWARD_THREADS)
    sddmm_backward_kernel(const float* __restrict__ de, const float* __restrict__ edge_mask,
                          const float* __restrict__ x, const float* __restrict__ y,
                          const int* __restrict__ senders, const int* __restrict__ receivers,
                          const int* __restrict__ row_ptr, const int* __restrict__ sender_order,
                          const int* __restrict__ sender_ptr, const int* __restrict__ n_edges,
                          float* __restrict__ dx, float* __restrict__ dy, int n_pad, int k,
                          int same) {
  const long long t = (long long)blockIdx.x * SDDMM_BACKWARD_THREADS + threadIdx.x;
  if (t >= (long long)n_pad * k) return;
  const int u = (int)(t / k), c = (int)(t - (long long)u * k);
  float gx = 0.0f, gy = 0.0f;
  if (dx != nullptr) {
    const int end = sender_ptr[u + 1];
#pragma unroll 4
    for (int j = sender_ptr[u]; j < end; ++j) {
      const int i = sender_order[j];
      const float g = __fmul_rn(de[i], edge_mask[i]);
      gx = __fadd_rn(gx, __fmul_rn(g, y[(long long)receivers[i] * k + c]));
    }
  }
  if (dy != nullptr || same) {
    const int end = min(row_ptr[u + 1], *n_edges);
#pragma unroll 4
    for (int i = row_ptr[u]; i < end; ++i) {
      const float g = __fmul_rn(de[i], edge_mask[i]);
      gy = __fadd_rn(gy, __fmul_rn(g, x[(long long)senders[i] * k + c]));
    }
  }
  if (same) {
    dx[t] = __fadd_rn(gx, gy);
    return;
  }
  if (dx != nullptr) dx[t] = gx;
  if (dy != nullptr) dy[t] = gy;
}

// The forward on `stream`: e [e_pad] from x, y float32 [n_pad, k] and the
// graph's senders, receivers (int32) and edge_mask (float32) [e_pad], all
// contiguous on the device.  Returns the launch's CUDA error (0 when it was
// accepted).
extern "C" int sddmm_forward_launch(const void* x, const void* y, const void* senders,
                                    const void* receivers, const void* edge_mask, void* out,
                                    int e_pad, int k, void* stream) {
  if (e_pad < 1 || k < 1) return (int)cudaErrorInvalidValue;
  int w = 1;
  while (2 * w <= k && w < 32) w *= 2;
  const long long threads = (long long)e_pad * w;
  const unsigned blocks = (unsigned)((threads + SDDMM_THREADS - 1) / SDDMM_THREADS);
  sddmm_forward_kernel<<<blocks, SDDMM_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const int*>(senders), static_cast<const int*>(receivers),
      static_cast<const float*>(edge_mask), static_cast<float*>(out), e_pad, k, w);
  return (int)cudaGetLastError();
}

// The backward on `stream`: dx (needs y) and dy (needs x), float32 [n_pad,
// k], from de and edge_mask float32 [e_pad], senders and receivers int32
// [e_pad], row_ptr and sender_ptr int32 [n_pad + 1], sender_order int32
// [e_pad] and n_edges int32 [1], all on the device.  dx or dy may be null;
// `same` (x and y one tensor, dy null) writes dx + dy into dx.  Returns the
// launch's CUDA error.
extern "C" int sddmm_backward_launch(const void* de, const void* edge_mask, const void* x,
                                     const void* y, const void* senders, const void* receivers,
                                     const void* row_ptr, const void* sender_order,
                                     const void* sender_ptr, const void* n_edges, void* dx,
                                     void* dy, int n_pad, int k, int same, void* stream) {
  if (n_pad < 1 || k < 1 || (dx == nullptr && dy == nullptr) ||
      (dx != nullptr && y == nullptr) || (dy != nullptr && x == nullptr) ||
      (same && (dx == nullptr || dy != nullptr || x == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  const long long threads = (long long)n_pad * k;
  const unsigned blocks =
      (unsigned)((threads + SDDMM_BACKWARD_THREADS - 1) / SDDMM_BACKWARD_THREADS);
  sddmm_backward_kernel<<<blocks, SDDMM_BACKWARD_THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(de), static_cast<const float*>(edge_mask),
      static_cast<const float*>(x), static_cast<const float*>(y),
      static_cast<const int*>(senders), static_cast<const int*>(receivers),
      static_cast<const int*>(row_ptr), static_cast<const int*>(sender_order),
      static_cast<const int*>(sender_ptr), static_cast<const int*>(n_edges),
      static_cast<float*>(dx), static_cast<float*>(dy), n_pad, k, same);
  return (int)cudaGetLastError();
}
