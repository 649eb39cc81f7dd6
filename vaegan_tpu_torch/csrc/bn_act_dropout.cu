// Fused BatchNorm-normalize + LeakyReLU + inverted dropout, forward and backward,
// for sm_90a.
//
// Replaces vaegan_tpu/ops/pallas_fused.py::_bn_fwd_kernel (launched from _bn_fwd) and
// ::_bn_bwd_kernel (launched from _bn_bwd_rule).
//
//   forward:  y = drop_p(leaky_slope(scale * (x - mean) * rsqrt(var + eps) + bias)) / (1 - p)
//   backward: ga = leaky'(a) * mask * g / (1 - p),  xhat = (x - mean) * inv,  inv = rsqrt(var + eps)
//             dx = ga * scale * inv,  dscale = sum ga * xhat,  dbias = sum ga,
//             dmean = -inv * scale * sum ga,  dvar = -0.5 * scale * sum(ga * xhat) / (var + eps)
//   (dmean and dvar let autograd continue into the batch statistics, as the TPU kernel's did)
//
// x (and g, y, dx) is an NHWC activation viewed as a row-major (M = N*H*W, C) matrix,
// f32 or bf16; mean, var, scale and bias are (C,) f32; the math runs in f32.
//
// What bounds it: memory. The forward reads x and writes y; the backward reads x and g
// and writes dx, with ~10 flops per element (plus one Philox4x32-10 call per 4 elements
// when p > 0), far below the H100's ~300 flops per byte ridge. The least time is the
// bytes over the bandwidth.
//
// What the design does about it:
//  - one pass over the activation in each direction and no intermediate in device
//    memory: the dropout mask is never stored, the backward recomputes it from
//    (seed, element index) with the forward's Philox words (philox.cuh, stream 0);
//  - each thread owns 4 consecutive elements, loaded and stored as one 16-byte (f32) or
//    8-byte (bf16) vector when aligned; a grid-stride loop over a grid sized to the SM
//    count keeps every SM streaming; the ragged tail is masked (no padding of M).
//    Dropout is a template parameter in both directions. In the backward, the loop
//    over whole aligned groups runs apart from the ragged tail; in f32 it is
//    software-pipelined (the next group's loads are in flight during this group's
//    math), in bf16 unrolled by two without dropout;
//  - the channel of an element is its flat index mod C, so any C works (C = 1 and 64
//    are on the model's path; the TPU kernel took only C % 128 == 0);
//  - the arithmetic uses the explicitly rounded intrinsics (__fsub_rn, __fmul_rn,
//    __fadd_rn) so no multiply-add is contracted: elementwise outputs are bitwise the
//    plain PyTorch version's, and the backward sees the same sign of the LeakyReLU
//    input as the forward did;
//  - the backward's channel sums are deterministic. The TPU accumulated them over a
//    grid that runs in order; CUDA blocks run at once, so each thread keeps its own sums
//    (a block of `threads` threads with `vec` elements each spans a multiple of C
//    elements, so a thread always meets the same channels), the block folds them per
//    channel in shared memory in a fixed tree into one row of 2C sums, and
//    grid_reduce.cuh adds the rows in the same launch: per cluster of blocks through
//    distributed shared memory in rank order, then the last cluster to draw a ticket
//    folds the cluster rows with all its threads in a fixed tree and writes the four
//    gradients. No float atomics and no second kernel: two runs give the same bits.
//    (The first design, partial rows and a second kernel that added them serially per
//    channel, spent 23-26 us of a 48-98 us call in that kernel at the training step's
//    sites on an H100 80GB HBM3, PERF.md.)

#include "grid_reduce.cuh"
#include "philox.cuh"

namespace {

using namespace vaegan;

constexpr int kThreads = 256;

// Forward; DROPOUT applies the mask (p > 0), a template argument so that each instance's
// loop is one path.
template <typename T, bool DROPOUT>
__global__ void __launch_bounds__(kThreads) bn_act_dropout_fwd_kernel(
    const T* __restrict__ x, T* __restrict__ y, const float* __restrict__ mean,
    const float* __restrict__ var, const float* __restrict__ scale,
    const float* __restrict__ bias, long long n, int C, float slope, float eps,
    float threshold, float keep_scale, uint32_t k0, uint32_t k1, int vec) {
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
    float v[4];
    load_group(x, base, n, vec, v);
    uint4 r = make_uint4(0u, 0u, 0u, 0u);
    if constexpr (DROPOUT) r = philox_words(g, kStreamDropout, k0, k1);
    const uint32_t bits[4] = {r.x, r.y, r.z, r.w};
    int c = (int)(base % C);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float a =
          __fadd_rn(__fmul_rn(__fsub_rn(v[j], s_mean[c]), s_mul[c]), s_bias[c]);
      float l = a > 0.f ? a : __fmul_rn(a, slope);
      if constexpr (DROPOUT) {
        l = __uint2float_rn(bits[j] >> 8) >= threshold ? __fmul_rn(l, keep_scale) : 0.f;
      }
      v[j] = l;
      c = c + 1 == C ? 0 : c + 1;
    }
    store_group(y, base, n, vec, v);
  }
}

// Backward: dx, and the four (C,) gradients, whose two channel sums (sum ga and
// sum ga * xhat) are reduced over the grid in the same launch (grid_reduce.cuh). VEC
// elements per thread slot, blockDim.x * VEC a multiple of C; DROPOUT replays the
// forward's mask.
template <typename T, int VEC, bool DROPOUT>
__global__ void __launch_bounds__(VEC == 4 ? kThreads : 1024) bn_act_dropout_bwd_kernel(
    const T* __restrict__ x, const T* __restrict__ g, T* __restrict__ dx,
    float* __restrict__ rows, unsigned int* ticket, const float* __restrict__ mean,
    const float* __restrict__ var, const float* __restrict__ scale,
    const float* __restrict__ bias, float* __restrict__ dscale, float* __restrict__ dbias,
    float* __restrict__ dmean, float* __restrict__ dvar, long long n, int C, float slope,
    float eps, float threshold, float keep_scale, uint32_t k0, uint32_t k1, int vec) {
  extern __shared__ float sh[];
  float* s_mean = sh;
  float* s_mul = sh + C;
  float* s_bias = sh + 2 * C;
  float* s_inv = sh + 3 * C;
  float* s_scale = sh + 4 * C;
  float* row = sh + 5 * C;         // the block's sums: [sum ga (C) | sum ga * xhat (C)]
  const int W = blockDim.x * VEC;  // slots of the block, a multiple of C
  float* red0 = sh + 7 * C;
  float* red1 = red0 + W;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    const float inv = rsqrtf(__fadd_rn(var[c], eps));
    s_mean[c] = mean[c];
    s_mul[c] = __fmul_rn(inv, scale[c]);
    s_bias[c] = bias[c];
    s_inv[c] = inv;
    s_scale[c] = scale[c];
  }
  __syncthreads();

  int ch[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) ch[j] = (int)((threadIdx.x * VEC + j) % C);
  float acc0[VEC], acc1[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) acc0[j] = acc1[j] = 0.f;

  // the math and the store of the VEC elements from `base`, given their x and g;
  // `full`: all of them in range and, for VEC = 4, aligned for one vector store
  auto group = [&](long long base, float (&xv)[VEC], const float (&gv)[VEC], auto full) {
    constexpr bool kFull = decltype(full)::value;
    uint32_t bits[VEC];
    if constexpr (DROPOUT) {
      const uint4 r = philox_words(base >> 2, kStreamDropout, k0, k1);
      if constexpr (VEC == 4) {
        bits[0] = r.x;
        bits[1] = r.y;
        bits[2] = r.z;
        bits[3] = r.w;
      } else {
        const uint32_t w[4] = {r.x, r.y, r.z, r.w};
        bits[0] = w[base & 3];
      }
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int c = ch[j];
      const float d = __fsub_rn(xv[j], s_mean[c]);
      const float a = __fadd_rn(__fmul_rn(d, s_mul[c]), s_bias[c]);
      const float xhat = __fmul_rn(d, s_inv[c]);
      float gl = gv[j];
      if constexpr (DROPOUT) {
        gl = __uint2float_rn(bits[j] >> 8) >= threshold ? __fmul_rn(gl, keep_scale) : 0.f;
      }
      const float ga = a > 0.f ? gl : __fmul_rn(gl, slope);
      xv[j] = __fmul_rn(__fmul_rn(ga, s_scale[c]), s_inv[c]);
      if (kFull || base + j < n) {  // masked tail elements add nothing
        acc0[j] = __fadd_rn(acc0[j], ga);
        acc1[j] = __fadd_rn(acc1[j], __fmul_rn(ga, xhat));
      }
    }
    if constexpr (VEC == 1) {
      from_f32(xv[0], dx + base);
    } else if constexpr (kFull) {
      store4(dx + base, xv);
    } else {
      store_group(dx, base, n, false, xv);
    }
  };

  const long long stride = (long long)gridDim.x * W;
  long long base = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * VEC;
  if constexpr (VEC == 4 && sizeof(T) == 4) {
    // f32, whole aligned groups, software-pipelined: the next group's two vector loads
    // are in flight while this group's math runs (left to itself, the compiler placed
    // them after the Philox rounds and the dropout sites lost 10% on an H100)
    if (vec && base + 4 <= n) {
      raw4<T> xr = load_raw4(x + base), gr = load_raw4(g + base);
      for (;;) {
        const long long next = base + stride;
        const bool more = next + 4 <= n;
        raw4<T> xn, gn;
        if (more) {
          xn = load_raw4(x + next);
          gn = load_raw4(g + next);
        }
        float xv[4], gv[4];
        unpack4(xr, xv);
        unpack4(gr, gv);
        group(base, xv, gv, std::true_type{});
        base = next;
        if (!more) break;
        xr = xn;
        gr = gn;
      }
    }
  } else if constexpr (VEC == 4) {
    // bf16, whole aligned groups: the compiler's own schedule, two passes' loads at
    // once without dropout (with it, Philox's registers would cost a block per SM);
    // the pipelined loop above was slower here on an H100
    if (vec) {
#pragma unroll(DROPOUT ? 1 : 2)
      for (; base + 4 <= n; base += stride) {
        float xv[4], gv[4];
        load4(x + base, xv);
        load4(g + base, gv);
        group(base, xv, gv, std::true_type{});
      }
    }
  }
  if constexpr (VEC == 4) {
    for (; base < n; base += stride) {  // the ragged tail, or unaligned buffers
      float xv[4], gv[4];
      load_group(x, base, n, false, xv);
      load_group(g, base, n, false, gv);
      group(base, xv, gv, std::false_type{});
    }
  } else {
    for (; base < n; base += stride) {
      float xv[1] = {to_f32(x[base])};
      const float gv[1] = {to_f32(g[base])};
      group(base, xv, gv, std::true_type{});
    }
  }

  // fold the slots of each channel: slot s holds channel s % C, k = W / C slots each
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    red0[threadIdx.x * VEC + j] = acc0[j];
    red1[threadIdx.x * VEC + j] = acc1[j];
  }
  __syncthreads();
  int k = W / C;
  while (k % 2 == 0) {
    const int half = (k / 2) * C;
    for (int s = threadIdx.x; s < half; s += blockDim.x) {
      red0[s] = __fadd_rn(red0[s], red0[s + half]);
      red1[s] = __fadd_rn(red1[s], red1[s + half]);
    }
    __syncthreads();
    k /= 2;
  }
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s0 = red0[c], s1 = red1[c];
    for (int m = 1; m < k; ++m) {
      s0 = __fadd_rn(s0, red0[c + m * C]);
      s1 = __fadd_rn(s1, red1[c + m * C]);
    }
    row[c] = s0;
    row[C + c] = s1;
  }

  // over the grid; red0 is free again and serves as the last block's scratch
  grid_reduce(row, 2 * C, rows, ticket, red0, [&](int e, float v) {
    if (e < C) {
      dbias[e] = v;
      dmean[e] = __fmul_rn(__fmul_rn(s_scale[e], v), -s_inv[e]);
    } else {
      const int c = e - C;
      dscale[c] = v;
      dvar[c] = __fdiv_rn(__fmul_rn(__fmul_rn(s_scale[c], v), -0.5f), __fadd_rn(var[c], eps));
    }
  });
}

template <typename T>
int launch_fwd(const void* x, void* y, const float* mean, const float* var,
               const float* scale, const float* bias, long long n, int C, float slope,
               float eps, int dropout, float threshold, float keep_scale,
               unsigned long long seed, int max_blocks, cudaStream_t stream) {
  const long long groups = (n + 3) / 4;
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  const size_t align = 4 * sizeof(T);
  const int vec = ((uintptr_t)x % align == 0) && ((uintptr_t)y % align == 0);
  const size_t smem = 3 * (size_t)C * sizeof(float);
  auto kernel = dropout ? bn_act_dropout_fwd_kernel<T, true> : bn_act_dropout_fwd_kernel<T, false>;
  kernel<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<T*>(y), mean, var, scale, bias, n, C, slope,
      eps, threshold, keep_scale, (uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)(seed >> 32),
      vec);
  return (int)cudaGetLastError();
}

template <typename T>
using BwdKernel = void (*)(const T*, const T*, T*, float*, unsigned int*, const float*,
                           const float*, const float*, const float*, float*, float*, float*,
                           float*, long long, int, float, float, float, float, uint32_t,
                           uint32_t, int);

template <typename T>
BwdKernel<T> bwd_kernel(int vec_elems, int dropout) {
  if (vec_elems == 4)
    return dropout ? bn_act_dropout_bwd_kernel<T, 4, true> : bn_act_dropout_bwd_kernel<T, 4, false>;
  return dropout ? bn_act_dropout_bwd_kernel<T, 1, true> : bn_act_dropout_bwd_kernel<T, 1, false>;
}

size_t bwd_smem(int C, int threads, int vec_elems) {
  return (7 * (size_t)C + 2 * (size_t)threads * vec_elems) * sizeof(float);
}

bool bwd_shape_ok(int C, int threads, int vec_elems, int cluster) {
  return C > 0 && threads > 0 && threads <= 1024 && (vec_elems == 4 || vec_elems == 1) &&
         !(vec_elems == 4 && threads > kThreads) && ((long long)threads * vec_elems) % C == 0 &&
         cluster >= 1 && cluster <= (int)kClusterMax;
}

template <typename T>
int launch_bwd(const void* x, const void* g, void* dx, float* rows, unsigned int* ticket,
               const float* mean, const float* var, const float* scale, const float* bias,
               float* dscale, float* dbias, float* dmean, float* dvar, long long n, int C,
               float slope, float eps, int dropout, float threshold, float keep_scale,
               unsigned long long seed, int threads, int vec_elems, int blocks, int cluster,
               cudaStream_t stream) {
  const size_t align = 4 * sizeof(T);
  const int vec = ((uintptr_t)x % align == 0) && ((uintptr_t)g % align == 0) &&
                  ((uintptr_t)dx % align == 0);
  return launch_clustered(bwd_kernel<T>(vec_elems, dropout), blocks, threads,
                          bwd_smem(C, threads, vec_elems), cluster, stream,
                          static_cast<const T*>(x), static_cast<const T*>(g),
                          static_cast<T*>(dx), rows, ticket, mean, var, scale, bias, dscale,
                          dbias, dmean, dvar, n, C, slope, eps, threshold, keep_scale,
                          (uint32_t)(seed & 0xFFFFFFFFull), (uint32_t)(seed >> 32), vec);
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
    return launch_fwd<float>(x, y, mean, var, scale, bias, n, C, slope, eps, dropout,
                             threshold, keep_scale, seed, max_blocks, s);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(x, y, mean, var, scale, bias, n, C, slope, eps,
                                     dropout, threshold, keep_scale, seed, max_blocks, s);
  return (int)cudaErrorInvalidValue;
}

// One launch. `rows` holds blocks / cluster * 2 * C floats of scratch and `ticket` one
// counter that is 0 and that no other launch uses meanwhile (grid_reduce.cuh); `blocks`
// is a multiple of `cluster` (at most 8). `threads` * `vec_elems` must be a multiple of
// C; `vec_elems` is 4 (threads <= 256) or 1 (threads <= 1024). The wrapper picks them.
extern "C" int vaegan_bn_act_dropout_bwd(
    const void* x, const void* g, void* dx, float* rows, unsigned int* ticket,
    const float* mean, const float* var, const float* scale, const float* bias, float* dscale,
    float* dbias, float* dmean, float* dvar, long long n, int C, int dtype, float slope,
    float eps, int dropout, float threshold, float keep_scale, unsigned long long seed,
    int threads, int vec_elems, int blocks, int cluster, void* stream) {
  if (n <= 0 || !bwd_shape_ok(C, threads, vec_elems, cluster) || blocks <= 0 ||
      blocks % cluster != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_bwd<float>(x, g, dx, rows, ticket, mean, var, scale, bias, dscale, dbias,
                             dmean, dvar, n, C, slope, eps, dropout, threshold, keep_scale,
                             seed, threads, vec_elems, blocks, cluster, s);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, g, dx, rows, ticket, mean, var, scale, bias, dscale,
                                     dbias, dmean, dvar, n, C, slope, eps, dropout, threshold,
                                     keep_scale, seed, threads, vec_elems, blocks, cluster, s);
  return (int)cudaErrorInvalidValue;
}

// How many clusters of the backward kernel for (C, dtype, dropout, threads,
// vec_elems) fit on the current device at once; minus the CUDA error code on failure.
extern "C" int vaegan_bn_act_dropout_bwd_max_clusters(int C, int dtype, int dropout,
                                                      int threads, int vec_elems,
                                                      int cluster) {
  if (!bwd_shape_ok(C, threads, vec_elems, cluster)) return -(int)cudaErrorInvalidValue;
  const size_t smem = bwd_smem(C, threads, vec_elems);
  if (dtype == 0)
    return max_active_clusters(bwd_kernel<float>(vec_elems, dropout), threads, smem, cluster);
  if (dtype == 1)
    return max_active_clusters(bwd_kernel<__nv_bfloat16>(vec_elems, dropout), threads, smem,
                               cluster);
  return -(int)cudaErrorInvalidValue;
}

