// Shared device helpers of the port's kernels: Philox4x32-10, f32/bf16 loads and
// stores (one 16-byte or 8-byte access per four values), and a fixed-order block
// reduction.
//
// Random bits. Every random word of the port is Philox4x32-10 (Salmon et al., SC'11)
// keyed on (seed lo, seed hi); the counter's third word names the stream, so one seed
// never gives correlated draws in two streams:
//   stream 0, dropout (bn_act_dropout):   counter (i lo, i hi, 0, 0), i = flat index / 4,
//                                          word index % 4;
//   stream 1, reparam_kl noise:           counter (i lo, i hi, 1, 0), i = flat index / 2,
//                                          words (2 (index % 2), 2 (index % 2) + 1).
// The plain PyTorch versions in vaegan_tpu_torch/ops/fused.py compute the same words.
//
// Index map. The flat index above is the element's place in the GLOBAL tensor of a
// parallel step. A kernel sees its process's part of it, whose images are each a run of
// L consecutive elements of the global tensor's G a image (a stripe of H is L = (H/M)
// W C of G = H W C; L = G when the process holds whole images), the first at `base`:
// local element e is global element base + (e / L) G + e % L (StripeMap). L = G is the
// contiguous map base + e. The kernels that draw take the map's kind as a template
// argument, STRIPED, and the host picks the instance from L < G: the contiguous instance
// computes base + e alone, and only the striped one runs global_index's division.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vaegan {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;

constexpr uint32_t kStreamDropout = 0u;
constexpr uint32_t kStreamReparam = 1u;

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0, uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r > 0) {
      k0 += kPhiloxW0;
      k1 += kPhiloxW1;
    }
    const uint32_t hi0 = __umulhi(kPhiloxM0, c.x);
    const uint32_t lo0 = kPhiloxM0 * c.x;
    const uint32_t hi1 = __umulhi(kPhiloxM1, c.z);
    const uint32_t lo1 = kPhiloxM1 * c.z;
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}

// The four words of counter (i lo, i hi, stream, 0).
__device__ __forceinline__ uint4 philox_words(long long i, uint32_t stream, uint32_t k0,
                                              uint32_t k1) {
  return philox4x32_10(
      make_uint4((uint32_t)i, (uint32_t)((unsigned long long)i >> 32), stream, 0u), k0, k1);
}

// The map from a local flat index to the global one (see the header comment).
struct StripeMap {
  long long base, L, G;
};

// The striped map's global index of local element e (L < G).
__device__ __forceinline__ long long global_index(const StripeMap& s, long long e) {
  long long img;
  if (e < 0x100000000LL && s.L < 0x100000000LL) {
    img = (long long)((unsigned int)e / (unsigned int)s.L);  // 32-bit division when it fits
  } else {
    img = e / s.L;
  }
  return s.base + img * s.G + (e - img * s.L);
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

// Four values as one vector access: raw4<T> holds them as loaded (16 bytes of f32, or
// 8 of bf16), unpack4 widens them to f32 (a bf16 is the high half of its f32).
template <typename T>
struct Raw4;
template <>
struct Raw4<float> {
  using type = float4;
};
template <>
struct Raw4<__nv_bfloat16> {
  using type = uint2;
};
template <typename T>
using raw4 = typename Raw4<T>::type;

__device__ __forceinline__ float4 load_raw4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ uint2 load_raw4(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint2*>(p);
}

__device__ __forceinline__ void unpack4(float4 q, float (&v)[4]) {
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void unpack4(uint2 q, float (&v)[4]) {
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xFFFF0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xFFFF0000u);
}

template <typename T>
__device__ __forceinline__ void load4(const T* p, float (&v)[4]) {
  unpack4(load_raw4(p), v);
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ uint32_t bf16_bits(float v) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(bf16_bits(v[0]) | (bf16_bits(v[1]) << 16),
                                            bf16_bits(v[2]) | (bf16_bits(v[3]) << 16));
}

// Four elements starting at `base` (masked past n; vector access when `vec`).
template <typename T>
__device__ __forceinline__ void load_group(const T* p, long long base, long long n, bool vec,
                                           float (&v)[4]) {
  if (vec && base + 4 <= n) {
    load4(p + base, v);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = base + j < n ? to_f32(p[base + j]) : 0.f;
  }
}

template <typename T>
__device__ __forceinline__ void store_group(T* p, long long base, long long n, bool vec,
                                            const float (&v)[4]) {
  if (vec && base + 4 <= n) {
    store4(p + base, v);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (base + j < n) from_f32(v[j], p + base + j);
    }
  }
}

// Sum of `v` over the block in a fixed order (a shared-memory tree over a
// power-of-two blockDim.x); the result is valid in thread 0. `sh` holds blockDim.x
// floats. No atomics: the same inputs give the same bits on every run.
__device__ __forceinline__ float block_sum(float v, float* sh) {
  sh[threadIdx.x] = v;
  __syncthreads();
  for (unsigned s = blockDim.x / 2; s > 0; s >>= 1) {
    if (threadIdx.x < s) sh[threadIdx.x] += sh[threadIdx.x + s];
    __syncthreads();
  }
  const float r = sh[0];
  __syncthreads();
  return r;
}

}  // namespace vaegan
