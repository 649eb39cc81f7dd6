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
// step n is 262,144 (2.1 MB in f32: 0.6 us at 3.35 TB/s), so in practice the launch (an
// empty kernel on the same grid takes 2.2 us on an H100 80GB HBM3) and the grid
// reduction's tail set its pace, not the bytes.
//
// Design: one launch. Each thread loads kGroups groups of 4 consecutive elements per
// pass (one 16-byte f32 or 8-byte bf16 access per input and group, all of a pass's loads
// issued before any add; the groups of a block lie kThreads * 4 elements apart, so each
// load of a warp is contiguous) in a grid-stride loop, adding into f32 sums in a fixed
// order; the masked tail adds zeros. The block folds its threads' (l1, l2) in a fixed
// shared-memory tree into a row of 2, and grid_reduce.cuh sums the rows over the grid
// in the same launch: per cluster of blocks in rank order, then the last cluster to
// draw an integer ticket folds the cluster rows and writes both sums. No float atomics,
// so the same inputs give the same bits. This replaces a second, one-thread kernel that
// added one pair of partials per block serially: at the step's n it took 7.5 us against
// the main kernel's 2.7 us on an H100 80GB HBM3 (PERF.md).

#include "grid_reduce.cuh"
#include "philox.cuh"

namespace {

using namespace vaegan;

constexpr int kThreads = 256;
// 4-element groups per thread and pass: on an H100, 2 beat 1 at batch 4 and 16 in both
// types, and 4 was not faster at batch 4 in f32 (PERF.md)
constexpr int kGroups = 2;
constexpr int kSpan = kThreads * 4;         // elements between a thread's groups

template <typename T>
__global__ void __launch_bounds__(kThreads) recon_sums_kernel(
    const T* __restrict__ r, const T* __restrict__ t, float* __restrict__ rows,
    unsigned int* ticket, float* __restrict__ out, long long n, int vec) {
  __shared__ float sh[kThreads];
  __shared__ float row[2];
  float l1 = 0.f, l2 = 0.f;
  auto add = [&](const float (&a)[4], const float (&b)[4]) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float d = __fsub_rn(a[j], b[j]);  // masked tail: 0 - 0 adds nothing
      l1 = __fadd_rn(l1, fabsf(d));
      l2 = __fadd_rn(l2, __fmul_rn(d, d));
    }
  };
  const long long stride = (long long)gridDim.x * kGroups * kSpan;
  long long base = (long long)blockIdx.x * kGroups * kSpan + threadIdx.x * 4;
  if (vec) {  // whole passes: every group in range and aligned
    for (; base + (kGroups - 1) * kSpan + 4 <= n; base += stride) {
      raw4<T> a[kGroups], b[kGroups];
#pragma unroll
      for (int k = 0; k < kGroups; ++k) {
        a[k] = load_raw4(r + base + k * kSpan);
        b[k] = load_raw4(t + base + k * kSpan);
      }
#pragma unroll
      for (int k = 0; k < kGroups; ++k) {
        float av[4], bv[4];
        unpack4(a[k], av);
        unpack4(b[k], bv);
        add(av, bv);
      }
    }
  }
  for (; base < n; base += stride) {  // the ragged last pass, or unaligned buffers
#pragma unroll
    for (int k = 0; k < kGroups; ++k) {
      float av[4], bv[4];
      load_group(r, base + k * kSpan, n, vec, av);
      load_group(t, base + k * kSpan, n, vec, bv);
      add(av, bv);
    }
  }
  const float s1 = block_sum(l1, sh);
  const float s2 = block_sum(l2, sh);
  if (threadIdx.x == 0) {
    row[0] = s1;
    row[1] = s2;
  }
  grid_reduce(row, 2, rows, ticket, sh, [&](int e, float total) { out[e] = total; });
}

// The launch floor: an empty kernel launched as recon_sums_kernel is, for timing.
__global__ void __launch_bounds__(kThreads) recon_floor_kernel() {}

constexpr size_t kSmem = 0;  // static shared memory only

template <typename T>
int launch(const void* r, const void* t, float* rows, unsigned int* ticket, float* out,
           long long n, int blocks, int cluster, cudaStream_t stream) {
  const size_t align = 4 * sizeof(T);
  const int vec = ((uintptr_t)r % align == 0) && ((uintptr_t)t % align == 0);
  return launch_clustered(recon_sums_kernel<T>, blocks, kThreads, kSmem, cluster, stream,
                          static_cast<const T*>(r), static_cast<const T*>(t), rows, ticket,
                          out, n, vec);
}

bool grid_ok(int blocks, int cluster) {
  return cluster >= 1 && cluster <= (int)kClusterMax && blocks > 0 && blocks % cluster == 0;
}

}  // namespace

// Plain C interface, loaded with ctypes. dtype: 0 = float32, 1 = bfloat16.
// One launch of `blocks` blocks (a multiple of `cluster`, at most 8) of 256 threads, each
// thread 8 elements a pass: `rows` holds blocks / cluster * 2 floats of scratch, `ticket`
// one counter that is 0 and that no other launch uses meanwhile (grid_reduce.cuh), `out`
// two floats. Launches on `stream`, does not synchronise, allocates nothing; returns the
// cudaGetLastError() code of the launch (0 = success).
extern "C" int vaegan_recon_loss_sums(const void* r, const void* t, float* rows,
                                      unsigned int* ticket, float* out, long long n, int dtype,
                                      int blocks, int cluster, void* stream) {
  if (n <= 0 || !grid_ok(blocks, cluster)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(r, t, rows, ticket, out, n, blocks, cluster, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(r, t, rows, ticket, out, n, blocks, cluster, s);
  return (int)cudaErrorInvalidValue;
}

// How many clusters of the kernel fit on the current device at once; minus the CUDA
// error code on failure.
extern "C" int vaegan_recon_loss_sums_max_clusters(int dtype, int cluster) {
  if (cluster < 1 || cluster > (int)kClusterMax) return -(int)cudaErrorInvalidValue;
  if (dtype == 0) return max_active_clusters(recon_sums_kernel<float>, kThreads, kSmem, cluster);
  if (dtype == 1)
    return max_active_clusters(recon_sums_kernel<__nv_bfloat16>, kThreads, kSmem, cluster);
  return -(int)cudaErrorInvalidValue;
}

// The same grid as vaegan_recon_loss_sums, launched with an empty kernel: the least any
// one-launch kernel of this shape takes (chip_smoke.py times it beside the kernel).
extern "C" int vaegan_recon_loss_sums_floor(int blocks, int cluster, void* stream) {
  if (!grid_ok(blocks, cluster)) return (int)cudaErrorInvalidValue;
  return launch_clustered(recon_floor_kernel, blocks, kThreads, kSmem, cluster,
                          static_cast<cudaStream_t>(stream));
}
