// The greedy-flip climb of baselines/local_search.greedy_flip_local_search,
// for Hopper (sm_90a): one block climbs one start to its local optimum.
//
// Replaces no TPU kernel.  The JAX package runs the climb as a vmapped
// lax.while_loop (gcn_maxcut_tpu/baselines/local_search.py
// greedy_flip_local_search), one XLA loop over all starts.  The port ran
// it as a lockstep step of some 20-45 small PyTorch kernels, captured once
// a padded shape and replayed in blocks of 16 with a host read after each
// block.  This kernel holds a start's whole climb on chip, so that no
// launch, capture or host read comes between its steps.
//
// Function (ops/climb.py greedy_climb_plain is its plain version).  For
// each start s, with W[i, c] = sum of w_e * mask_e over node i's in-edges
// e = row_ptr[i] .. row_ptr[i + 1] whose sender is in class c, summed in
// CSR order from 0, each step moves the first best strictly improving
// node: among legal moves (id >= num_fixed, node_mask > 0, c != asn[i]),
// the highest gain W[i, asn[i]] - W[i, c], on a tie the lowest flat index
// i * k + c (torch.argmax's rule); the move is made only when its gain is
// > 1e-6, else the start is done.  At most max_steps moves.  The lockstep
// loop of the plain step gives each start exactly min(moves to its local
// optimum, max_steps) moves, because a start with no improving move stays
// where it is: so climbing each start alone gives the same assignment.
//
// Exactness.  After a move of node m only the W rows of m's out-neighbours
// change; on a symmetric graph (the only graphs this kernel takes) they are
// the senders of m's in-edges.  Each such row is recomputed from scratch in
// CSR order with separate multiply and add roundings (no FMA contraction),
// not updated by +-w, so every W equals, bit for bit, the sum the plain
// step's COO index_add takes in edge order (edges are sorted by receiver),
// for any weights.  Edge slots from n_edges on are padding (w = mask = 0,
// core/graph.py), whose +0 terms change no sum, so loops stop at n_edges.
// A class outside [0, k) counts in no W column and leaves its node
// unmovable (the plain step's one_hot raises on it instead).
//
// Bound on this card: latency.  A climb is a chain of dependent steps,
// each a block-wide reduction over n_pad * k gains in shared memory (three
// barriers a step), with one block a start (the decode climbs 4 starts on
// 132 SMs).  Bytes and operations are negligible: at n_pad = 1000, k = 3 a
// step reads 16 KB of shared memory and a few hundred bytes of L1.  The
// design keeps asn int32 [n_pad] and W float32 [n_pad, k] of the start in
// dynamic shared memory for the whole climb, recomputes after a move only
// the d * k entries of W that changed (about d^2 loads), and reduces
// (gain, index) with warp shuffles, then in one warp.

#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

#define CLIMB_THREADS 512
#define CLIMB_WARPS (CLIMB_THREADS / 32)
#define CLIMB_SMEM_MAX 232448

// Bytes of dynamic shared memory of a block: W, asn, and the reduction's
// per-warp (gain, index) pairs and the step's decision.
static size_t climb_smem_bytes(int n_pad, int k) {
  return (size_t)n_pad * (size_t)(k + 1) * 4 + (size_t)(2 * CLIMB_WARPS + 1) * 4;
}

// (ga, ia) comes before (gb, ib): a higher gain, or the same gain at a
// lower flat index.
__device__ __forceinline__ bool climb_before(float ga, int ia, float gb, int ib) {
  return ga > gb || (ga == gb && ia < ib);
}

__device__ __forceinline__ void climb_warp_best(float& g, int& i) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float og = __shfl_down_sync(0xffffffffu, g, off);
    const int oi = __shfl_down_sync(0xffffffffu, i, off);
    if (climb_before(og, oi, g, i)) {
      g = og;
      i = oi;
    }
  }
}

// W[j, c], from scratch in CSR order: the initial W and, after a move,
// each changed entry.
__device__ __forceinline__ float climb_row_sum(const int* __restrict__ senders,
                                               const float* __restrict__ weights,
                                               const float* __restrict__ edge_mask,
                                               const int* __restrict__ row_ptr,
                                               const int* asn, int j, int c, int n_edges) {
  float acc = 0.0f;
  const int end = min(row_ptr[j + 1], n_edges);
  for (int e = row_ptr[j]; e < end; ++e) {
    if (asn[senders[e]] == c) acc = __fadd_rn(acc, __fmul_rn(weights[e], edge_mask[e]));
  }
  return acc;
}

__global__ void __launch_bounds__(CLIMB_THREADS)
climb_kernel(const int* __restrict__ senders, const float* __restrict__ weights,
             const float* __restrict__ edge_mask, const int* __restrict__ row_ptr,
             const float* __restrict__ node_mask, const int* __restrict__ n_edges_ptr,
             const long long* __restrict__ asn_in, long long* __restrict__ asn_out,
             int* __restrict__ moves_out, int n_pad, int k, int num_fixed, int max_steps) {
  extern __shared__ __align__(16) unsigned char climb_smem[];
  float* W = reinterpret_cast<float*>(climb_smem);                 // [n_pad, k]
  int* asn = reinterpret_cast<int*>(W + (size_t)n_pad * k);        // [n_pad]
  float* red_g = reinterpret_cast<float*>(asn + n_pad);           // [CLIMB_WARPS]
  int* red_i = reinterpret_cast<int*>(red_g + CLIMB_WARPS);       // [CLIMB_WARPS]
  int* moved = red_i + CLIMB_WARPS;       // the node this step moved, or -1

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n_edges = *n_edges_ptr;
  const long long* a_in = asn_in + (size_t)blockIdx.x * n_pad;
  for (int i = tid; i < n_pad; i += CLIMB_THREADS) asn[i] = (int)a_in[i];
  __syncthreads();
  for (int t = tid; t < n_pad * k; t += CLIMB_THREADS) {
    W[t] = climb_row_sum(senders, weights, edge_mask, row_ptr, asn, t / k, t % k, n_edges);
  }
  __syncthreads();

  int moves = 0;
  for (; moves < max_steps; ++moves) {
    // Each thread's first best over its nodes, in ascending flat order.
    float bg = -INFINITY;
    int bi = INT_MAX;
    for (int i = tid; i < n_pad; i += CLIMB_THREADS) {
      const int a = asn[i];
      if (i < num_fixed || !(node_mask[i] > 0.0f) || a < 0 || a >= k) continue;
      const float* wi = W + (size_t)i * k;
      const float wa = wi[a];
      for (int c = 0; c < k; ++c) {
        if (c == a) continue;
        const float gain = __fsub_rn(wa, wi[c]);
        if (gain > bg) {
          bg = gain;
          bi = i * k + c;
        }
      }
    }
    climb_warp_best(bg, bi);
    if (lane == 0) {
      red_g[warp] = bg;
      red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
      bg = lane < CLIMB_WARPS ? red_g[lane] : -INFINITY;
      bi = lane < CLIMB_WARPS ? red_i[lane] : INT_MAX;
      climb_warp_best(bg, bi);
      if (lane == 0) {
        int m = -1;
        if (bg > 1e-6f) {
          m = bi / k;
          asn[m] = bi - m * k;
        }
        *moved = m;
      }
    }
    __syncthreads();
    const int m = *moved;
    if (m < 0) break;
    // The rows of m's neighbours, a thread an (in-edge, class) pair.  A
    // neighbour listed twice is written twice with the same sums.
    const int p0 = row_ptr[m];
    const int pairs = (min(row_ptr[m + 1], n_edges) - p0) * k;
    for (int t = tid; t < pairs; t += CLIMB_THREADS) {
      const int j = senders[p0 + t / k], c = t % k;
      W[(size_t)j * k + c] =
          climb_row_sum(senders, weights, edge_mask, row_ptr, asn, j, c, n_edges);
    }
    __syncthreads();
  }

  long long* a_out = asn_out + (size_t)blockIdx.x * n_pad;
  for (int i = tid; i < n_pad; i += CLIMB_THREADS) a_out[i] = (long long)asn[i];
  if (tid == 0) moves_out[blockIdx.x] = moves;
}

// Climbs `starts` assignments asn_in [starts, n_pad] (int64) of one graph
// into asn_out (int64, same shape) and each start's move count
// moves_out [starts] (int32), on `stream`.  senders int32, weights and
// edge_mask float32 [e_pad]; row_ptr int32 [n_pad + 1]; node_mask float32
// [n_pad]; n_edges int32 [1], on the device.  Returns the launch's CUDA
// error (0 when it was accepted).
extern "C" int climb_launch(const void* senders, const void* weights, const void* edge_mask,
                            const void* row_ptr, const void* node_mask, const void* n_edges,
                            const void* asn_in, void* asn_out, void* moves_out, int starts,
                            int n_pad, int k, int num_fixed, int max_steps, int smem_bytes,
                            void* stream) {
  if (starts < 1 || n_pad < 1 || k < 1 || max_steps < 0 ||
      (size_t)smem_bytes != climb_smem_bytes(n_pad, k) || smem_bytes > CLIMB_SMEM_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  if (smem_bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        climb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
    if (err != cudaSuccess) return (int)err;
  }
  climb_kernel<<<starts, CLIMB_THREADS, (size_t)smem_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(senders), static_cast<const float*>(weights),
      static_cast<const float*>(edge_mask), static_cast<const int*>(row_ptr),
      static_cast<const float*>(node_mask), static_cast<const int*>(n_edges),
      static_cast<const long long*>(asn_in), static_cast<long long*>(asn_out),
      static_cast<int*>(moves_out), n_pad, k, num_fixed, max_steps);
  return (int)cudaGetLastError();
}
