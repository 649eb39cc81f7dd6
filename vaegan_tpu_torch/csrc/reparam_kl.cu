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
// kernel did, with no division in its loop. The backward also comes with a KL cotangent
// and without one (KL), in each.
//
// What bounds it: instruction issue first, then memory. The forward reads mu and lv and
// writes z (12 bytes an element in f32, 6 in bf16); the backward reads mu, lv and gz and
// writes dmu and dlv (20 and 10 bytes). Per element both run half a Philox4x32-10 call
// (ten rounds of 32-bit multiplies), an accurate logf and cosf and a sqrtf (Box-Muller,
// which the rounding rule above pins: no fast intrinsic gives the same bits), and an
// expf or two: well over a hundred instructions, whose issue time on 132 SMs x 128 lanes
// is above the bytes' time in bf16 and close to it in f32 (chip_smoke.py counts them in
// the compiled code).
//
// What the forward's design does about it: each thread owns 4 consecutive elements (both
// Philox calls of its group before the transcendentals, for independent work), with
// vector loads when aligned; the loop over whole aligned groups is one body without
// branches of its own (the tail runs after it); the grid is the number of blocks that fit
// on the card at once, so no second wave runs at part occupancy. The KL sum is
// deterministic and takes the same launch: a fixed shared-memory tree per block, then
// grid_reduce.cuh (per cluster in rank order, then the last cluster folds the cluster
// sums in a fixed tree). No float atomics; the TPU's sequential-grid accumulation would
// race as a straight port. (The first design, one partial per block and a one-thread
// kernel that added them, spent 17.6 us of a 45.9 us call in that kernel on an H100
// 80GB HBM3, PERF.md.)
//
// What the backward's design does about it (PERF.md): every instruction that is
// not the algorithm's is taken out of its loop, and each thread has more independent
// work in flight. A warp owns 256 elements a pass, each thread 8 of them (four
// independent Philox calls) in runs of one 16-byte access: one run in bf16, two in f32,
// placed so that every access of the warp reads 512 consecutive bytes. Whole aligned
// chunks run one body with no branch of its own and the rest after it; the striped
// instance carries its chunk's global index from pass to pass instead of dividing by L;
// without a KL cotangent (the training step's case) an instance leaves out e^lv, which
// changes no bit of dlv except where a thread's elements compute it (grad8). The grid is
// 16 blocks an SM (ops/fused.py): more than fit at once, so blocks of a few passes each
// take the SMs that free up, which ends more evenly than one resident wave.

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

// ---- backward -------------------------------------------------------------------------

constexpr int kSpan = 8;            // elements a thread takes per pass: four Philox counters
constexpr int kChunk = 32 * kSpan;  // elements a warp takes per pass
constexpr int kBwdBlocksPerSM = 3;  // the register budget: at most 85 a thread

// Where a thread's 8 elements lie in its warp's chunk of 256: in runs of one 16-byte
// access (4 f32, 8 bf16), run r of lane t at r 32 kRun + t kRun, so that each 16-byte
// access of the warp reads 512 consecutive bytes. rel(j, lane): element j's place in the
// chunk; a Box-Muller pair (2k, 2k + 1) is two neighbours of one run.
template <typename T>
struct Runs {
  static constexpr int kRun = 16 / (int)sizeof(T);
  static constexpr int kCount = kSpan / kRun;
  static __device__ __forceinline__ int rel(int j, int lane) {
    return (j / kRun) * 32 * kRun + lane * kRun + j % kRun;
  }
};

__device__ __forceinline__ void unpack16(const float* p, float* v) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
}

__device__ __forceinline__ void unpack16(const __nv_bfloat16* p, float* v) {
  const uint4 q = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xFFFF0000u);
  }
}

__device__ __forceinline__ void pack16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void pack16(__nv_bfloat16* p, const float* v) {
  uint32_t w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = bf16_bits(v[2 * k]) | (bf16_bits(v[2 * k + 1]) << 16);
  *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
}

// A thread's 8 elements of the chunk at p (16-byte aligned), widened to f32, and back.
template <typename T>
__device__ __forceinline__ void load8(const T* p, int lane, float (&v)[8]) {
#pragma unroll
  for (int r = 0; r < Runs<T>::kCount; ++r)
    unpack16(p + Runs<T>::rel(r * Runs<T>::kRun, lane), v + r * Runs<T>::kRun);
}

template <typename T>
__device__ __forceinline__ void store8(T* p, int lane, const float (&v)[8]) {
#pragma unroll
  for (int r = 0; r < Runs<T>::kCount; ++r)
    pack16(p + Runs<T>::rel(r * Runs<T>::kRun, lane), v + r * Runs<T>::kRun);
}

// The same for the chunk at element `base` of p, each element on its own, those past n
// skipped.
template <typename T>
__device__ __forceinline__ void load8_masked(const T* p, long long base, long long n, int lane,
                                             float (&v)[8]) {
#pragma unroll
  for (int j = 0; j < kSpan; ++j) {
    const long long e = base + Runs<T>::rel(j, lane);
    v[j] = e < n ? to_f32(p[e]) : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ void store8_masked(T* p, long long base, long long n, int lane,
                                              const float (&v)[8]) {
#pragma unroll
  for (int j = 0; j < kSpan; ++j) {
    const long long e = base + Runs<T>::rel(j, lane);
    if (e < n) from_f32(v[j], p + e);
  }
}

// The noise of 8 elements whose four pairs have the Philox counters c (the four calls
// first, independent of one another, then the transcendentals).
__device__ __forceinline__ void noise8(const long long (&c)[4], uint32_t k0, uint32_t k1,
                                       float (&e)[8]) {
  uint4 w[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = philox_words(c[k], kStreamReparam, k0, k1);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    e[2 * k] = box_muller(w[k].x, w[k].y);
    e[2 * k + 1] = box_muller(w[k].z, w[k].w);
  }
}

// dmu and dlv of 8 elements, in place of m and l: dmu = gz + gkl mu and dlv = a + t,
// a = (gz / 2) e^{lv/2} eps, t = (-gkl / 2)(1 - e^lv), each rounded as written.
// Without a KL cotangent (KL false, gkl = 0) t is (-0)(1 - e^lv): a zero, which leaves a
// as it is unless a is a zero itself (the sum's sign is t's then) or t is a NaN (e^lv
// overflows, or lv is a NaN). Only a thread whose 8 elements hold such a one computes e^lv.
template <bool KL>
__device__ __forceinline__ void grad8(float gkl, float (&m)[8], float (&l)[8],
                                      const float (&g)[8], const float (&e)[8]) {
  float a[8];
  bool plain = true;  // (KL false) every t leaves its a as it is
#pragma unroll
  for (int j = 0; j < kSpan; ++j) {
    a[j] = __fmul_rn(__fmul_rn(__fmul_rn(g[j], 0.5f), expf(__fmul_rn(0.5f, l[j]))), e[j]);
    m[j] = __fadd_rn(g[j], __fmul_rn(gkl, m[j]));
    if constexpr (!KL) plain &= (a[j] != 0.f) & (l[j] <= 88.f);  // e^88 is finite
  }
  if (KL || !plain) {
#pragma unroll
    for (int j = 0; j < kSpan; ++j)
      l[j] = __fadd_rn(a[j], __fmul_rn(__fmul_rn(gkl, -0.5f), __fsub_rn(1.0f, expf(l[j]))));
  } else {
#pragma unroll
    for (int j = 0; j < kSpan; ++j) l[j] = a[j];
  }
}

// Backward: a grid-stride loop over chunks of 256 elements, one a warp. The whole chunks
// (all in range, every pointer 16-byte aligned) run one body with no branch of its own;
// the rest (a ragged end, or every chunk when unaligned) run after it, element by element.
// STRIPED: the loop carries the global index of its chunk's first element and the chunk's
// offset in its image from pass to pass (a pass moves by a fixed number of images and
// elements), so no division runs in it; a chunk that crosses an image's end (only when L
// is not a multiple of 256) maps each pair on its own.
template <typename T, bool STRIPED, bool KL>
__global__ void __launch_bounds__(kThreads, kBwdBlocksPerSM) reparam_bwd_kernel(
    const T* __restrict__ mu, const T* __restrict__ lv, const T* __restrict__ gz,
    const float* __restrict__ gkl_ptr, T* __restrict__ dmu, T* __restrict__ dlv,
    long long n, uint32_t k0, uint32_t k1, long long gbase, int vec, long long L,
    long long G) {
  using R = Runs<T>;
  float gkl = 0.f;
  if constexpr (KL) gkl = gkl_ptr[0];
  const StripeMap map{gbase, L, G};
  const int lane = threadIdx.x % 32;
  const long long warps = (long long)gridDim.x * blockDim.x / 32;
  long long c = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / 32;  // the warp's chunk
  const long long whole = vec ? n / kChunk : 0;
  long long gi = 0, off = 0, gi_step = 0, off_step = 0;
  if constexpr (STRIPED) {
    const long long e = c * kChunk, img = e / L;
    off = e - img * L;
    gi = gbase + img * G + off;
    const long long step = warps * kChunk, img_step = step / L;
    off_step = step - img_step * L;
    gi_step = img_step * G + off_step;
  }
  for (; c < whole; c += warps) {
    const long long base = c * kChunk;
    float m[8], l[8], gv[8], e[8];
    load8(mu + base, lane, m);
    load8(lv + base, lane, l);
    load8(gz + base, lane, gv);
    long long ctr[4];
    if constexpr (STRIPED) {
      if (off + kChunk <= L) {
#pragma unroll
        for (int k = 0; k < 4; ++k) ctr[k] = (gi + R::rel(2 * k, lane)) >> 1;
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) ctr[k] = global_index(map, base + R::rel(2 * k, lane)) >> 1;
      }
      off += off_step;
      gi += gi_step;
      if (off >= L) {
        off -= L;
        gi += G - L;
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) ctr[k] = (gbase + base + R::rel(2 * k, lane)) >> 1;
    }
    noise8(ctr, k0, k1, e);
    grad8<KL>(gkl, m, l, gv, e);
    store8(dmu + base, lane, m);
    store8(dlv + base, lane, l);
  }
  for (; c * kChunk < n; c += warps) {
    const long long base = c * kChunk;
    float m[8], l[8], gv[8], e[8];
    load8_masked(mu, base, n, lane, m);
    load8_masked(lv, base, n, lane, l);
    load8_masked(gz, base, n, lane, gv);
    long long ctr[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const long long i = base + R::rel(2 * k, lane);
      ctr[k] = (STRIPED ? global_index(map, i) : gbase + i) >> 1;
    }
    noise8(ctr, k0, k1, e);
    grad8<KL>(gkl, m, l, gv, e);
    store8_masked(dmu, base, n, lane, m);
    store8_masked(dlv, base, n, lane, l);
  }
}

template <typename T>
bool aligned(const void* p) {
  return (uintptr_t)p % (4 * sizeof(T)) == 0;
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
using BwdKernel = decltype(&reparam_bwd_kernel<T, false, false>);

// The backward's instance for a striped map or not, with a KL cotangent or not.
template <typename T>
BwdKernel<T> bwd_instance(bool striped, bool kl) {
  if (striped) return kl ? reparam_bwd_kernel<T, true, true> : reparam_bwd_kernel<T, true, false>;
  return kl ? reparam_bwd_kernel<T, false, true> : reparam_bwd_kernel<T, false, false>;
}

template <typename T>
int launch_bwd(const void* mu, const void* lv, const void* gz, const float* gkl, void* dmu,
               void* dlv, long long n, unsigned long long seed, StripeMap map, int blocks,
               cudaStream_t stream) {
  const void* ptrs[] = {mu, lv, gz, dmu, dlv};
  int vec = 1;
  for (const void* p : ptrs) vec &= (uintptr_t)p % 16 == 0;
  const BwdKernel<T> kernel = bwd_instance<T>(map.L != map.G, gkl != nullptr);
  kernel<<<blocks, kThreads, 0, stream>>>(
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

// Backward, one launch of `blocks` blocks of 256 threads, each warp 256 elements a pass.
// gkl: device f32 scalar, or null for a cotangent of 0; (base, L, G) as in the forward.
extern "C" int vaegan_reparam_kl_bwd(const void* mu, const void* lv, const void* gz,
                                     const float* gkl, void* dmu, void* dlv, long long n,
                                     int dtype, unsigned long long seed, long long base,
                                     long long L, long long G, int blocks, void* stream) {
  if (n <= 0 || blocks <= 0 || !map_ok(n, base, L, G)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const StripeMap map{base, L, G};
  if (dtype == 0) return launch_bwd<float>(mu, lv, gz, gkl, dmu, dlv, n, seed, map, blocks, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(mu, lv, gz, gkl, dmu, dlv, n, seed, map, blocks, s);
  return (int)cudaErrorInvalidValue;
}

// How many blocks of the backward's instance (striped: for L < G; kl: with a KL
// cotangent) fit on one SM of the current device at once; minus the CUDA error code on
// failure.
extern "C" int vaegan_reparam_kl_bwd_blocks_per_sm(int dtype, int striped, int kl) {
  int n = 0;
  cudaError_t rc = cudaErrorInvalidValue;
  if (dtype == 0)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, bwd_instance<float>(striped, kl), kThreads, 0);
  if (dtype == 1)
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, bwd_instance<__nv_bfloat16>(striped, kl), kThreads, 0);
  if (rc != cudaSuccess) {
    cudaGetLastError();
    return -(int)rc;
  }
  return n;
}
