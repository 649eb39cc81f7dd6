// Fused reparameterization + KL, forward and backward, for sm_90a.
//
// Replaces vaegan_tpu/ops/pallas_fused.py::_reparam_fwd_kernel (launched from
// _reparam_fwd, noise from _normal_from_bits) and ::_reparam_bwd_kernel (launched from
// _reparam_bwd).
//
//   forward:  eps ~ N(0, 1) drawn in the kernel,  z = mu + exp(lv / 2) * eps,
//             kl = -0.5 * sum(1 + lv - mu^2 - exp(lv))
//   backward: the same eps replayed,  dmu = gz + gkl * mu,
//             dlv = gz * 0.5 * exp(lv / 2) * eps - 0.5 * gkl * (1 - exp(lv))
//
// mu, lv, z, gz, dmu and dlv are NHWC buffers of n elements, f32 or bf16; the math runs
// in f32 and the KL is an f32 scalar. gkl is a device f32 scalar, or null for 0 (the KL
// output unused, as on the training step, where the loss recomputes the KL).
//
// Noise: Box-Muller over two 24-bit uniforms, the TPU kernel's rule:
//   u1 = ((b1 >> 8) + 1) / 2^24 in (0, 1],  u2 = (b2 >> 8) / 2^24 in [0, 1),
//   eps = sqrt(-2 log u1) * cos(2 pi u2),
// with (b1, b2) words of Philox4x32-10 stream 1 (philox.cuh): element e takes words
// (2 (e % 2), 2 (e % 2) + 1) of counter (e / 2, 1). The noise is a pure function of
// (seed, element index), so the backward replays it bit for bit and the plain PyTorch
// version in vaegan_tpu_torch/ops/fused.py computes the same words. The element index is
// the flat position's place in a larger tensor, base + (e / L) G + e % L (philox.cuh's
// StripeMap): a parallel process passes the place of its rows (and of its H stripe) in
// the global latent and draws its part of the one-process step's noise (base 0, L = G on
// one process). base is a multiple of 4 and, where L < G, L and G are even, so the two
// elements of a Box-Muller pair are one image's. Each kernel comes in two instances,
// STRIPED or not (philox.cuh): the contiguous one draws at base + e as the data-parallel
// kernel did, with no division in its loop.
//
// What bounds it: memory and instruction count, about equally. The forward reads mu and
// lv and writes z (12 bytes an element in f32); per element it also runs half a
// Philox4x32-10 call (ten rounds of 32-bit multiplies), an accurate logf and cosf, a
// sqrtf and two expf: on the order of a hundred and more instructions, whose
// time on 132 SMs x 128 lanes is close to the bytes' time (chip_smoke.py counts them
// from the compiled code). The backward reads three arrays and writes two.
//
// What the design does about it: each thread owns 4 consecutive elements (both Philox
// calls of its group before the transcendentals, for independent work), with vector
// loads when aligned; the loop over whole aligned groups is one body without branches
// of its own (the tail runs after it); the grid is the number of blocks that fit on the
// card at once, so no second wave runs at part occupancy. The KL sum is deterministic
// and takes the same launch: a fixed shared-memory tree per block, then
// grid_reduce.cuh (per cluster in rank order, then the last cluster folds the cluster
// sums in a fixed tree). No float atomics; the TPU's sequential-grid accumulation would
// race as a straight port. (The first design, one partial per block and a one-thread
// kernel that added them, spent 17.6 us of a 45.9 us call in that kernel on an H100
// 80GB HBM3, PERF.md.)

#include "grid_reduce.cuh"
#include "philox.cuh"

namespace {

using namespace vaegan;

constexpr int kThreads = 256;
constexpr float kTwoPow24Inv = 5.9604644775390625e-08f;  // 2^-24
constexpr float kTwoPi = 6.28318548202514648f;           // float32(2 pi)

__device__ __forceinline__ float box_muller(uint32_t b1, uint32_t b2) {
  const float u1 = __fmul_rn(__fadd_rn(__uint2float_rn(b1 >> 8), 1.0f), kTwoPow24Inv);
  const float u2 = __fmul_rn(__uint2float_rn(b2 >> 8), kTwoPow24Inv);
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  return __fmul_rn(r, cosf(__fmul_rn(kTwoPi, u2)));
}

// The noise of local elements base .. base + 3 (base a multiple of 4): two pairs, each
// one counter at its first element's global index / 2.
template <bool STRIPED>
__device__ __forceinline__ void noise4(const StripeMap& map, long long base, uint32_t k0,
                                       uint32_t k1, float (&e)[4]) {
  uint4 a, b;
  if constexpr (STRIPED) {
    a = philox_words(global_index(map, base) >> 1, kStreamReparam, k0, k1);
    b = philox_words(global_index(map, base + 2) >> 1, kStreamReparam, k0, k1);
  } else {
    const long long i = (map.base + base) >> 1;
    a = philox_words(i, kStreamReparam, k0, k1);
    b = philox_words(i + 1, kStreamReparam, k0, k1);
  }
  e[0] = box_muller(a.x, a.y);
  e[1] = box_muller(a.z, a.w);
  e[2] = box_muller(b.x, b.y);
  e[3] = box_muller(b.z, b.w);
}

// Forward: z, and the KL summed over the grid in the same launch (grid_reduce.cuh).
template <typename T, bool STRIPED>
__global__ void __launch_bounds__(kThreads) reparam_fwd_kernel(
    const T* __restrict__ mu, const T* __restrict__ lv, T* __restrict__ z,
    float* __restrict__ rows, unsigned int* ticket, float* __restrict__ kl, long long n,
    uint32_t k0, uint32_t k1, long long gbase, int vec, long long L, long long G) {
  __shared__ float sh[kThreads];
  __shared__ float row[1];
  float acc = 0.f;
  // the 4 elements from `base`; `full`: all in range and aligned for vector access,
  // so the hot loop below has no branch of its own
  auto group = [&](long long base, auto full) {
    constexpr bool kFull = decltype(full)::value;
    float m[4], l[4], e[4];
    if constexpr (kFull) {
      load4(mu + base, m);
      load4(lv + base, l);
    } else {
      load_group(mu, base, n, false, m);
      load_group(lv, base, n, false, l);
    }
    noise4<STRIPED>({gbase, L, G}, base, k0, k1, e);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float eh = expf(__fmul_rn(0.5f, l[j]));
      const float t = __fsub_rn(__fsub_rn(__fadd_rn(1.0f, l[j]), __fmul_rn(m[j], m[j])),
                                expf(l[j]));
      if (kFull || base + j < n) acc = __fadd_rn(acc, t);
      m[j] = __fadd_rn(m[j], __fmul_rn(eh, e[j]));
    }
    if constexpr (kFull) {
      store4(z + base, m);
    } else {
      store_group(z, base, n, false, m);
    }
  };
  const long long stride = (long long)gridDim.x * blockDim.x * 4;
  long long base = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (vec) {
    for (; base + 4 <= n; base += stride) group(base, std::true_type{});
  }
  for (; base < n; base += stride) group(base, std::false_type{});
  const float s = block_sum(acc, sh);
  if (threadIdx.x == 0) row[0] = s;
  grid_reduce(row, 1, rows, ticket, sh, [&](int, float total) { kl[0] = -0.5f * total; });
}

template <typename T, bool STRIPED>
__global__ void __launch_bounds__(kThreads) reparam_bwd_kernel(
    const T* __restrict__ mu, const T* __restrict__ lv, const T* __restrict__ gz,
    const float* __restrict__ gkl_ptr, T* __restrict__ dmu, T* __restrict__ dlv,
    long long n, uint32_t k0, uint32_t k1, long long gbase, int vec, long long L,
    long long G) {
  const float gkl = gkl_ptr ? gkl_ptr[0] : 0.f;
  const long long groups = (n + 3) >> 2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < groups;
       g += stride) {
    const long long base = g << 2;
    float m[4], l[4], gzv[4], e[4];
    load_group(mu, base, n, vec, m);
    load_group(lv, base, n, vec, l);
    load_group(gz, base, n, vec, gzv);
    noise4<STRIPED>({gbase, L, G}, base, k0, k1, e);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float eh = expf(__fmul_rn(0.5f, l[j]));
      const float dm = __fadd_rn(gzv[j], __fmul_rn(gkl, m[j]));
      const float dl = __fadd_rn(
          __fmul_rn(__fmul_rn(__fmul_rn(gzv[j], 0.5f), eh), e[j]),
          __fmul_rn(__fmul_rn(gkl, -0.5f), __fsub_rn(1.0f, expf(l[j]))));
      m[j] = dm;
      l[j] = dl;
    }
    store_group(dmu, base, n, vec, m);
    store_group(dlv, base, n, vec, l);
  }
}

template <typename T>
bool aligned(const void* p) {
  return (uintptr_t)p % (4 * sizeof(T)) == 0;
}

int grid_for(long long n, int max_blocks) {
  long long blocks = ((n + 3) / 4 + kThreads - 1) / kThreads;
  return (int)(blocks < max_blocks ? blocks : max_blocks);
}

constexpr size_t kFwdSmem = 0;  // static shared memory only

template <typename T>
int launch_fwd(const void* mu, const void* lv, void* z, float* rows, unsigned int* ticket,
               float* kl, long long n, unsigned long long seed, StripeMap map, int blocks,
               int cluster, cudaStream_t stream) {
  const int vec = aligned<T>(mu) && aligned<T>(lv) && aligned<T>(z);
  auto kernel = map.L == map.G ? reparam_fwd_kernel<T, false> : reparam_fwd_kernel<T, true>;
  return launch_clustered(kernel, blocks, kThreads, kFwdSmem, cluster, stream,
                          static_cast<const T*>(mu), static_cast<const T*>(lv),
                          static_cast<T*>(z), rows, ticket, kl, n,
                          (uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)(seed >> 32), map.base,
                          vec, map.L, map.G);
}

template <typename T>
int launch_bwd(const void* mu, const void* lv, const void* gz, const float* gkl, void* dmu,
               void* dlv, long long n, unsigned long long seed, StripeMap map, int max_blocks,
               cudaStream_t stream) {
  const int vec = aligned<T>(mu) && aligned<T>(lv) && aligned<T>(gz) && aligned<T>(dmu) &&
                  aligned<T>(dlv);
  auto kernel = map.L == map.G ? reparam_bwd_kernel<T, false> : reparam_bwd_kernel<T, true>;
  kernel<<<grid_for(n, max_blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(mu), static_cast<const T*>(lv), static_cast<const T*>(gz), gkl,
      static_cast<T*>(dmu), static_cast<T*>(dlv), n, (uint32_t)(seed & 0xFFFFFFFFull),
      (uint32_t)(seed >> 32), map.base, vec, map.L, map.G);
  return (int)cudaGetLastError();
}

// The index map (base, L, G) of n elements is valid: base a non-negative multiple of 4,
// and L = G, or L a divisor of n and L, G even with L < G.
bool map_ok(long long n, long long base, long long L, long long G) {
  if (base < 0 || base % 4 != 0 || L <= 0 || G < L) return false;
  return L == G || (n % L == 0 && L % 2 == 0 && G % 2 == 0);
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Launches on `stream`, does not synchronise, allocates nothing; returns the
// cudaGetLastError() code of the launch (0 = success).
//
// Forward, one launch of `blocks` blocks (a multiple of `cluster`, at most 8) of 256
// threads: `rows` holds blocks / cluster floats of scratch, `ticket` one counter that
// is 0 and that no other launch uses meanwhile (grid_reduce.cuh), `kl` one float.
// (base, L, G): the index map of the noise (header comment; L = G = n for the contiguous
// map).
extern "C" int vaegan_reparam_kl_fwd(const void* mu, const void* lv, void* z, float* rows,
                                     unsigned int* ticket, float* kl, long long n, int dtype,
                                     unsigned long long seed, long long base, long long L,
                                     long long G, int blocks, int cluster, void* stream) {
  if (n <= 0 || cluster < 1 || cluster > (int)kClusterMax || blocks <= 0 ||
      blocks % cluster != 0 || !map_ok(n, base, L, G))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const StripeMap map{base, L, G};
  if (dtype == 0)
    return launch_fwd<float>(mu, lv, z, rows, ticket, kl, n, seed, map, blocks, cluster, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(mu, lv, z, rows, ticket, kl, n, seed, map, blocks,
                                     cluster, s);
  return (int)cudaErrorInvalidValue;
}

// How many clusters of the forward kernel fit on the current device at once; minus
// the CUDA error code on failure. striped: the instance of a striped map (L < G).
extern "C" int vaegan_reparam_kl_fwd_max_clusters(int dtype, int striped, int cluster) {
  if (cluster < 1 || cluster > (int)kClusterMax) return -(int)cudaErrorInvalidValue;
  if (dtype == 0)
    return max_active_clusters(striped ? reparam_fwd_kernel<float, true>
                                       : reparam_fwd_kernel<float, false>,
                               kThreads, kFwdSmem, cluster);
  if (dtype == 1)
    return max_active_clusters(striped ? reparam_fwd_kernel<__nv_bfloat16, true>
                                       : reparam_fwd_kernel<__nv_bfloat16, false>,
                               kThreads, kFwdSmem, cluster);
  return -(int)cudaErrorInvalidValue;
}

// gkl: device f32 scalar, or null for a cotangent of 0; (base, L, G) as in the forward.
extern "C" int vaegan_reparam_kl_bwd(const void* mu, const void* lv, const void* gz,
                                     const float* gkl, void* dmu, void* dlv, long long n,
                                     int dtype, unsigned long long seed, long long base,
                                     long long L, long long G, int max_blocks, void* stream) {
  if (n <= 0 || max_blocks <= 0 || !map_ok(n, base, L, G)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const StripeMap map{base, L, G};
  if (dtype == 0)
    return launch_bwd<float>(mu, lv, gz, gkl, dmu, dlv, n, seed, map, max_blocks, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(mu, lv, gz, gkl, dmu, dlv, n, seed, map, max_blocks, s);
  return (int)cudaErrorInvalidValue;
}
