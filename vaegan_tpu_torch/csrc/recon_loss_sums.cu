// L1 and squared-error sums of a reconstruction in one pass, for sm_90a.
//
// Replaces vaegan_tpu/ops/pallas_fused.py::_recon_fwd_kernel (launched from _recon_fwd).
//
//   sums = (sum |r - t|, sum (r - t)^2)      over every element of r and t
//
// The training step's G half takes (sums[0] + sums[1]) / numel, the mean-reduced
// L1 + MSE of the notebook. r and t are buffers of n elements in one layout, f32 or
// bf16; the sums are f32. The backward (g0 sign(d) + 2 g1 d) stays plain PyTorch, as
// the TPU package's _recon_bwd is plain jnp.
//
// What bounds it: memory, 2 n element reads and ~5 flops an element. On the training
// step n is 262,144 (2.1 MB in f32), so a launch's latency bounds it in practice.
//
// Design: each thread owns 4 consecutive elements (vector loads when aligned) in a
// grid-stride loop; per-thread f32 sums fold in a fixed shared-memory tree per block
// into one pair of partials per block; a second one-thread kernel adds the pairs in
// block order in double. The TPU accumulated over a sequential grid; CUDA blocks run at
// once, and float atomics would make the loss change from run to run, so none are used:
// the same inputs give the same bits.

#include "philox.cuh"

namespace {

using namespace vaegan;

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads) recon_sums_kernel(
    const T* __restrict__ r, const T* __restrict__ t, float* __restrict__ partial,
    long long n, int vec) {
  __shared__ float sh[kThreads];
  float l1 = 0.f, l2 = 0.f;
  const long long groups = (n + 3) >> 2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long g = (long long)blockIdx.x * blockDim.x + threadIdx.x; g < groups;
       g += stride) {
    const long long base = g << 2;
    float a[4], b[4];
    load_group(r, base, n, vec, a);
    load_group(t, base, n, vec, b);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float d = __fsub_rn(a[j], b[j]);  // masked tail: 0 - 0 adds nothing
      l1 = __fadd_rn(l1, fabsf(d));
      l2 = __fadd_rn(l2, __fmul_rn(d, d));
    }
  }
  const float s1 = block_sum(l1, sh);
  const float s2 = block_sum(l2, sh);
  if (threadIdx.x == 0) {
    partial[2 * blockIdx.x] = s1;
    partial[2 * blockIdx.x + 1] = s2;
  }
}

__global__ void recon_sums_finish_kernel(const float* __restrict__ partial, int blocks,
                                         float* __restrict__ out) {
  double s1 = 0.0, s2 = 0.0;
  for (int b = 0; b < blocks; ++b) {
    s1 += (double)partial[2 * b];
    s2 += (double)partial[2 * b + 1];
  }
  out[0] = (float)s1;
  out[1] = (float)s2;
}

int grid_for(long long n, int max_blocks) {
  long long blocks = ((n + 3) / 4 + kThreads - 1) / kThreads;
  return (int)(blocks < max_blocks ? blocks : max_blocks);
}

template <typename T>
int launch(const void* r, const void* t, float* partial, float* out, long long n,
           int max_blocks, cudaStream_t stream) {
  const size_t align = 4 * sizeof(T);
  const int vec = ((uintptr_t)r % align == 0) && ((uintptr_t)t % align == 0);
  const int blocks = grid_for(n, max_blocks);
  recon_sums_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(r), static_cast<const T*>(t), partial, n, vec);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  recon_sums_finish_kernel<<<1, 1, 0, stream>>>(partial, blocks, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// `partial` holds 2 * min(ceil(n / 1024), max_blocks) floats of scratch; `out` two.
// Launches on `stream`, does not synchronise, allocates nothing; returns the
// cudaGetLastError() code of the launch (0 = success).
extern "C" int vaegan_recon_loss_sums(const void* r, const void* t, float* partial,
                                      float* out, long long n, int dtype, int max_blocks,
                                      void* stream) {
  if (n <= 0 || max_blocks <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(r, t, partial, out, n, max_blocks, s);
  if (dtype == 1) return launch<__nv_bfloat16>(r, t, partial, out, n, max_blocks, s);
  return (int)cudaErrorInvalidValue;
}
