// Adam's update of every leaf on one card, for Hopper (sm_90a): one pass
// over p, g, mu and nu, driven by a table of leaves in the kernel's
// arguments.
//
// Replaces no TPU kernel.  The JAX package calls optax.adam
// (gcn_maxcut_tpu/train/loop.py:100, bench/giant_demo.py:83 and :261,
// parallel/giant.py:413), which XLA fuses into a loop a leaf.  The port ran
// train/optim.py's step as some 14-15 PyTorch elementwise kernels a leaf,
// each reading and writing whole leaves: about 128 bytes an element, and
// three small kernels a step for the count and the scalar table.
//
// Function (ops/adam.py step_plain is its plain version, on the card's
// arithmetic: the reciprocal bias corrections).  For every element of every
// leaf, with the count c read from the device, t = min(c, last), and
// neg_lr = tables[0][t], bc1 = tables[1][t], bc2 = tables[2][t]:
//   mu  = mu_stored*b1 + g*(1-b1)             (float32 mu_stored), or
//   mu  = g*(1-b1) + bf16(float(mu_stored)*b1)   (bfloat16 mu_stored)
//   nu  = nu*b2 + (g*g)*(1-b2)
//   p  += ((mu*bc1) / (sqrt(nu*bc2) + eps)) * neg_lr
//   mu_stored = mu (float32) or bf16(mu), rounded to nearest even.
// Every product, sum, quotient and root is rounded on its own, as the plain
// step's separate kernels round them: the intrinsics below are never
// contracted into FMAs, so the update is the plain step's bit for bit
// (PyTorch on the card multiplies a bfloat16 tensor by a Python number in
// float32 and rounds the product to bfloat16).  When `nonfinite` is given,
// any gradient element that is not finite sets it (it is never cleared
// here).  The count is incremented after the update by a one-thread
// launch, so every block reads it first.
//
// Bound on this card: bytes.  Each element reads g, p, nu (float32) and mu
// and writes p, nu and mu once: 24 bytes with a bfloat16 mu, 28 with a
// float32 one; at 3.35 TB/s the giant's 320,077,824-element embedding takes
// 2.29 ms.  The design streams each leaf once in 16-byte vectors (4
// elements a thread a step; 8 bytes of a bfloat16 mu) where the four
// pointers allow it, else element by element; blocks take equal ranges of
// elements (tiles) whatever leaf they lie in, so one huge leaf fills the
// card, and the grid is about one wave of resident blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#define ADAM_THREADS 256
#define ADAM_VEC 4
#define ADAM_MAX_LEAVES 64
#define ADAM_MAX_DEVICES 64

// The leaves of one launch; leaf i covers tiles tile0[i] .. tile0[i + 1] - 1
// of `tile` elements each (the last one shorter).
struct AdamTable {
  float* p[ADAM_MAX_LEAVES];
  const float* g[ADAM_MAX_LEAVES];
  void* mu[ADAM_MAX_LEAVES];
  float* nu[ADAM_MAX_LEAVES];
  long long n[ADAM_MAX_LEAVES];
  int tile0[ADAM_MAX_LEAVES + 1];
  int leaves;
  long long tile;
};

struct AdamConsts {
  float b1, omb1, b2, omb2, eps;
};

template <typename M>
struct AdamMu;

template <>
struct AdamMu<float> {
  __device__ __forceinline__ static float next(float stored, float g, const AdamConsts& k) {
    return __fadd_rn(__fmul_rn(stored, k.b1), __fmul_rn(g, k.omb1));
  }
  __device__ __forceinline__ static float store(float mu) { return mu; }
};

template <>
struct AdamMu<__nv_bfloat16> {
  __device__ __forceinline__ static float next(__nv_bfloat16 stored, float g,
                                               const AdamConsts& k) {
    const __nv_bfloat16 decayed =
        __float2bfloat16(__fmul_rn(__bfloat162float(stored), k.b1));
    return __fadd_rn(__fmul_rn(g, k.omb1), __bfloat162float(decayed));
  }
  __device__ __forceinline__ static __nv_bfloat16 store(float mu) {
    return __float2bfloat16(mu);
  }
};

// One element: updates p, mu and nu in registers; returns whether g is finite.
template <typename M>
__device__ __forceinline__ bool adam_element(float& p, float g, M& mu, float& nu,
                                             const AdamConsts& k, float neg_lr, float bc1,
                                             float bc2) {
  const float m = AdamMu<M>::next(mu, g, k);
  nu = __fadd_rn(__fmul_rn(nu, k.b2), __fmul_rn(__fmul_rn(g, g), k.omb2));
  const float update =
      __fdiv_rn(__fmul_rn(m, bc1), __fadd_rn(__fsqrt_rn(__fmul_rn(nu, bc2)), k.eps));
  p = __fadd_rn(p, __fmul_rn(update, neg_lr));
  mu = AdamMu<M>::store(m);
  return isfinite(g);
}

// ADAM_VEC elements of mu in one load: 16 bytes of float32, 8 of bfloat16.
template <typename M>
struct AdamVec;
template <>
struct AdamVec<float> {
  using type = float4;
};
template <>
struct AdamVec<__nv_bfloat16> {
  using type = uint2;
};

template <typename M>
__global__ void __launch_bounds__(ADAM_THREADS)
    adam_kernel(const AdamTable table, const long long* __restrict__ count,
                const float* __restrict__ tables, int last, const AdamConsts k,
                bool* __restrict__ nonfinite) {
  int leaf = 0;
  while ((int)blockIdx.x >= table.tile0[leaf + 1]) ++leaf;
  const long long c = *count;
  const int t = c < 0 ? 0 : (c > last ? last : (int)c);
  const float neg_lr = tables[t], bc1 = tables[last + 1 + t], bc2 = tables[2 * (last + 1) + t];

  float* __restrict__ p = table.p[leaf];
  const float* __restrict__ g = table.g[leaf];
  M* __restrict__ mu = static_cast<M*>(table.mu[leaf]);
  float* __restrict__ nu = table.nu[leaf];
  const long long start = (long long)(blockIdx.x - table.tile0[leaf]) * table.tile;
  const long long end = min(start + table.tile, table.n[leaf]);
  const bool vec = ((reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(g) |
                     reinterpret_cast<uintptr_t>(nu)) % 16 == 0) &&
                   reinterpret_cast<uintptr_t>(mu) % (ADAM_VEC * sizeof(M)) == 0;
  bool finite = true;
  long long scalar_from = start;
  if (vec) {
    using MV = typename AdamVec<M>::type;
    const long long vec_end = start + ((end - start) / ADAM_VEC) * ADAM_VEC;
    for (long long e = start + (long long)threadIdx.x * ADAM_VEC; e < vec_end;
         e += (long long)ADAM_THREADS * ADAM_VEC) {
      float4 p4 = *reinterpret_cast<const float4*>(p + e);
      const float4 g4 = *reinterpret_cast<const float4*>(g + e);
      float4 n4 = *reinterpret_cast<const float4*>(nu + e);
      MV mv = *reinterpret_cast<const MV*>(mu + e);
      M* m4 = reinterpret_cast<M*>(&mv);
      finite &= adam_element(p4.x, g4.x, m4[0], n4.x, k, neg_lr, bc1, bc2);
      finite &= adam_element(p4.y, g4.y, m4[1], n4.y, k, neg_lr, bc1, bc2);
      finite &= adam_element(p4.z, g4.z, m4[2], n4.z, k, neg_lr, bc1, bc2);
      finite &= adam_element(p4.w, g4.w, m4[3], n4.w, k, neg_lr, bc1, bc2);
      *reinterpret_cast<float4*>(p + e) = p4;
      *reinterpret_cast<float4*>(nu + e) = n4;
      *reinterpret_cast<MV*>(mu + e) = mv;
    }
    scalar_from = vec_end;
  }
  for (long long e = scalar_from + threadIdx.x; e < end; e += ADAM_THREADS) {
    float pe = p[e], ne = nu[e];
    M me = mu[e];
    finite &= adam_element(pe, g[e], me, ne, k, neg_lr, bc1, bc2);
    p[e] = pe;
    nu[e] = ne;
    mu[e] = me;
  }
  if (nonfinite != nullptr) {
    if (__syncthreads_or(!finite) && threadIdx.x == 0) *nonfinite = true;
  }
}

__global__ void adam_count_kernel(long long* count) { *count += 1; }

// Resident blocks of the kernel on the current device, one wave (cached by
// device and mu dtype; the first call comes before any capture).
static int adam_wave(bool bf16, int* blocks) {
  static int cache[ADAM_MAX_DEVICES][2];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < ADAM_MAX_DEVICES && cache[dev][bf16] > 0) {
    *blocks = cache[dev][bf16];
    return 0;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &per_sm, adam_kernel<__nv_bfloat16>, ADAM_THREADS, 0)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, adam_kernel<float>,
                                                             ADAM_THREADS, 0);
  if (err != cudaSuccess) return (int)err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < ADAM_MAX_DEVICES) cache[dev][bf16] = *blocks;
  return 0;
}

// Updates `leaves` leaves in place, then adds 1 to the count when
// `increment` is set, on `stream` of the current device.  `ptrs` (host)
// holds each leaf's p, g, mu and nu device pointers, `numel` (host) its
// element count; p, g, nu are float32, mu float32 (mu_bf16 = 0) or
// bfloat16 (1), each contiguous.  count: int64 [1]; tables: float32
// [3, last + 1] (-lr, then the reciprocal bias corrections), on the device;
// nonfinite: bool [1] on the device, or null.  Leaves past ADAM_MAX_LEAVES
// go to further launches, all before the count's.  Returns the first CUDA
// error (0 when every launch was accepted).
extern "C" int adam_launch(const uint64_t* ptrs, const long long* numel, int leaves, int mu_bf16,
                           void* count, const void* tables, int last, float b1, float omb1,
                           float b2, float omb2, float eps, void* nonfinite,
                           int increment, void* stream) {
  if (leaves < 0 || last < 0 || count == nullptr || tables == nullptr) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long total = 0;
  for (int i = 0; i < leaves; ++i) {
    if (numel[i] < 0) return (int)cudaErrorInvalidValue;
    total += numel[i];
  }
  int wave = 0;
  int err = adam_wave(mu_bf16 != 0, &wave);
  if (err != 0) return err;
  // a tile: a whole number of vector steps of the block, about total / wave
  const long long step = (long long)ADAM_THREADS * ADAM_VEC;
  long long tile = (total + wave - 1) / wave;
  tile = ((tile + step - 1) / step) * step;
  if (tile < step) tile = step;
  const AdamConsts k{b1, omb1, b2, omb2, eps};
  for (int first = 0; first < leaves; first += ADAM_MAX_LEAVES) {
    AdamTable table{};
    table.leaves = leaves - first < ADAM_MAX_LEAVES ? leaves - first : ADAM_MAX_LEAVES;
    table.tile = tile;
    long long tiles = 0;
    for (int i = 0; i < table.leaves; ++i) {
      const uint64_t* q = ptrs + 4 * (size_t)(first + i);
      table.p[i] = reinterpret_cast<float*>(q[0]);
      table.g[i] = reinterpret_cast<const float*>(q[1]);
      table.mu[i] = reinterpret_cast<void*>(q[2]);
      table.nu[i] = reinterpret_cast<float*>(q[3]);
      table.n[i] = numel[first + i];
      table.tile0[i] = (int)tiles;
      tiles += (numel[first + i] + tile - 1) / tile;
      if (tiles > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    }
    table.tile0[table.leaves] = (int)tiles;
    if (tiles == 0) continue;
    if (mu_bf16) {
      adam_kernel<__nv_bfloat16><<<(unsigned)tiles, ADAM_THREADS, 0, s>>>(
          table, static_cast<const long long*>(count), static_cast<const float*>(tables), last,
          k, static_cast<bool*>(nonfinite));
    } else {
      adam_kernel<float><<<(unsigned)tiles, ADAM_THREADS, 0, s>>>(
          table, static_cast<const long long*>(count), static_cast<const float*>(tables), last,
          k, static_cast<bool*>(nonfinite));
    }
    err = (int)cudaGetLastError();
    if (err != 0) return err;
  }
  if (increment) {
    adam_count_kernel<<<1, 1, 0, s>>>(static_cast<long long*>(count));
    err = (int)cudaGetLastError();
  }
  return err;
}
