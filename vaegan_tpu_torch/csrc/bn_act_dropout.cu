// Fused BatchNorm-normalize + LeakyReLU + inverted dropout, forward, for sm_90a.
//
// Replaces vaegan_tpu/ops/pallas_fused.py::_bn_fwd_kernel (launched from _bn_fwd).
//
//   y = drop_p(leaky_slope(scale * (x - mean) * rsqrt(var + eps) + bias)) / (1 - p)
//
// x is an NHWC activation viewed as a row-major (M = N*H*W, C) matrix, f32 or bf16;
// mean, var, scale and bias are (C,) f32; the math runs in f32 and y has x's type.
//
// What bounds it: memory. Each element is read once and written once with ~6 flops
// (plus one Philox4x32-10 call per 4 elements when p > 0), far below the H100's
// ~300 flops per byte ridge, so the least time is 2 * numel * sizeof(T) / bandwidth.
//
// What the design does about it:
//  - one pass, no intermediate in device memory: the dropout mask is never stored,
//    it is recomputed from (seed, element index) by whoever needs it (the backward
//    kernel of the training path);
//  - each thread owns 4 consecutive elements, loaded and stored as one 16-byte (f32)
//    or 8-byte (bf16) vector when the pointers are aligned, and a grid-stride loop over
//    a grid sized to the SM count keeps every SM streaming;
//  - the per-channel (mean, inv * scale, bias) are computed once per block into shared
//    memory; the channel of an element is its flat index mod C, so any C works
//    (C = 1 and C = 64 are on the serving path; the TPU kernel only took C % 128 == 0);
//  - no padding of M: the ragged tail is masked here (the TPU wrapper padded M to a
//    multiple of its 1024-row block);
//  - random bits come from Philox4x32-10 keyed on (seed lo, seed hi) with counter
//    (g lo, g hi, 0, 0), g = flat element index / 4, word (index % 4): the mask is a
//    pure function of (seed, index), independent of block shape, and the plain PyTorch
//    version in vaegan_tpu_torch/ops/fused.py computes the same bits. The keep rule is
//    the TPU kernel's: keep = float(bits >> 8) >= p * 2^24.
//  - the arithmetic uses the explicitly rounded intrinsics (__fsub_rn, __fmul_rn,
//    __fadd_rn) so no multiply-add is contracted and each step rounds exactly as the
//    plain version's separate tensor ops do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kPhiloxM0 = 0xD2511F53u;
constexpr uint32_t kPhiloxM1 = 0xCD9E8D57u;
constexpr uint32_t kPhiloxW0 = 0x9E3779B9u;
constexpr uint32_t kPhiloxW1 = 0xBB67AE85u;
constexpr int kThreads = 256;

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

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void from_f32(float v, float* out) { *out = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* out) {
  *out = __float2bfloat16_rn(v);
}

__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const __nv_bfloat162* q = reinterpret_cast<const __nv_bfloat162*>(p);
  const __nv_bfloat162 a = q[0];
  const __nv_bfloat162 b = q[1];
  v[0] = __low2float(a);
  v[1] = __high2float(a);
  v[2] = __low2float(b);
  v[3] = __high2float(b);
}

__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
  __nv_bfloat162* q = reinterpret_cast<__nv_bfloat162*>(p);
  q[0] = __floats2bfloat162_rn(v[0], v[1]);
  q[1] = __floats2bfloat162_rn(v[2], v[3]);
}

template <typename T>
__global__ void __launch_bounds__(kThreads) bn_act_dropout_fwd_kernel(
    const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ mean,
    const float* __restrict__ var, const float* __restrict__ scale,
    const float* __restrict__ bias, long long n, int C, float slope, float eps,
    int dropout, float threshold, float keep_scale, uint32_t k0, uint32_t k1, int vec) {
  extern __shared__ float sh[];
  float* s_mean = sh;
  float* s_mul = sh + C;
  float* s_bias = sh + 2 * C;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float inv = rsqrtf(__fadd_rn(var[c], eps));
    s_mean[c] = mean[c];
    s_mul[c] = __fmul_rn(inv, scale[c]);
    s_bias[c] = bias[c];
  }
  __syncthreads();

  const long long groups = (n + 3) >> 2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < groups;
       g += stride) {
    const long long base = g << 2;
    const bool full = vec && base + 4 <= n;
    float v[4];
    if (full) {
      load4(x + base, v);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[j] = base + j < n ? to_f32(x[base + j]) : 0.f;
    }
    uint32_t bits[4] = {0u, 0u, 0u, 0u};
    if (dropout) {
      const uint4 r = philox4x32_10(
          make_uint4((uint32_t)g, (uint32_t)((unsigned long long)g >> 32), 0u, 0u), k0, k1);
      bits[0] = r.x;
      bits[1] = r.y;
      bits[2] = r.z;
      bits[3] = r.w;
    }
    int c = (int)(base % C);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a =
          __fadd_rn(__fmul_rn(__fsub_rn(v[j], s_mean[c]), s_mul[c]), s_bias[c]);
      float l = a > 0.f ? a : __fmul_rn(a, slope);
      if (dropout) {
        l = __uint2float_rn(bits[j] >> 8) >= threshold ? __fmul_rn(l, keep_scale) : 0.f;
      }
      v[j] = l;
      c = c + 1 == C ? 0 : c + 1;
    }
    if (full) {
      store4(y + base, v);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (base + j < n) from_f32(v[j], y + base + j);
      }
    }
  }
}

template <typename T>
int launch(const void* x, void* y, const float* mean, const float* var, const float* scale,
           const float* bias, long long n, int C, float slope, float eps, int dropout,
           float threshold, float keep_scale, unsigned long long seed, int max_blocks,
           cudaStream_t stream) {
  const long long groups = (n + 3) / 4;
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  const size_t align = 4 * sizeof(T);
  const int vec = ((uintptr_t)x % align == 0) && ((uintptr_t)y % align == 0);
  const size_t smem = 3 * (size_t)C * sizeof(float);
  bn_act_dropout_fwd_kernel<T><<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), mean, var, scale, bias, n, C, slope,
      eps, dropout, threshold, keep_scale, (uint32_t)(seed & 0xFFFFFFFFull),
      (uint32_t)(seed >> 32), vec);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// Launches on `stream`, does not synchronise, allocates nothing; returns the
// cudaGetLastError() code of the launch (0 = success).
extern "C" int vaegan_bn_act_dropout_fwd(const void* x, void* y, const float* mean,
                                         const float* var, const float* scale,
                                         const float* bias, long long n, int C, int dtype,
                                         float slope, float eps, int dropout,
                                         float threshold, float keep_scale,
                                         unsigned long long seed, int max_blocks,
                                         void* stream) {
  if (n <= 0) return 0;
  if (C <= 0 || max_blocks <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, y, mean, var, scale, bias, n, C, slope, eps, dropout,
                         threshold, keep_scale, seed, max_blocks, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, y, mean, var, scale, bias, n, C, slope, eps, dropout,
                                 threshold, keep_scale, seed, max_blocks, s);
  return (int)cudaErrorInvalidValue;
}
