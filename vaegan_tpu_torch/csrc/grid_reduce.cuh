// Deterministic one-launch grid reduction for sm_90a: block, then cluster, then the
// last cluster to finish.
//
// A kernel that sums values over its whole grid ends with grid_reduce(). Three levels,
// each in a fixed order, so the bits of the result depend on the grid and cluster shape
// only, never on the order in which blocks run:
//  1. block: the caller folds its threads' values into one row of `width` floats in
//     its own shared memory (a fixed tree: vaegan::block_sum, or a per-channel fold);
//  2. cluster: the kernel is launched in thread-block clusters (launch_clustered). After
//     a cluster barrier, block rank 0 adds the rows of ranks 1, 2, ... to its own, in
//     rank order, reading them through distributed shared memory, and writes one row
//     per cluster to global scratch;
//  3. grid: each cluster's rank 0 draws a ticket from a counter in device memory with
//     one integer fetch-add (release: its row before the ticket; acquire: the last
//     one sees every row) and tells its cluster whether it drew the last one. The
//     cluster that did folds the cluster rows, each of its blocks a share of the
//     columns, every thread a column and a group of rows (loads batched, adds in row
//     order), then a fixed tree over the row groups; it hands each element's total to
//     the caller's `fin` and sets the counter back to 0 for the next launch.
// No float atomics: the integer ticket decides only which cluster does the last fold,
// not the order of any addition. One kernel launch, no second finish kernel, and no
// memset of the counter: it is 0 before and after every launch.
//
// Cost: two cluster barriers and one ticket per cluster, and a last fold of
// (clusters x width) floats spread over the last cluster's blocks. The last fold's
// loads go out in batches: added one by one, each waited for its L2 round trip,
// which made the tail grow with the width (measured on an H100, PERF.md).
//
// The counter is shared by the launches that use it, so two such kernels must never
// run at once on one counter (the wrappers in ops/fused.py keep one counter per CUDA
// stream: launches on one stream run one after another).

#pragma once

#include <cooperative_groups.h>
#include <cuda/atomic>
#include <cuda_runtime.h>

#include <type_traits>
#include <utility>

namespace vaegan {

namespace cg = cooperative_groups;

constexpr unsigned kClusterMax = 8;  // the portable cluster size limit

constexpr int kFoldBatch = 16;  // row loads a thread has in flight in fold_rows

// Fold columns [0, cols) of `R` rows (row-major, `stride` floats apart, in global
// memory, written by other blocks of this launch) element by element, and call
// fin(e, total of column e) once per column, from one thread. Row groups of a
// power-of-two count G each add their rows q, q + G, q + 2G, ... in order, loading
// kFoldBatch of them before adding any; then a shared-memory tree folds the G groups.
// `sh` holds blockDim.x floats. Every thread of the block calls it.
template <typename Fin>
__device__ __forceinline__ void fold_rows(const float* rows, int R, int cols, int stride,
                                          float* sh, Fin&& fin) {
  const int T = blockDim.x;
  const int E = cols < T ? cols : T;  // columns per pass
  if (E <= 0) return;
  int G = 1;                          // row groups per column
  while (2 * G * E <= T) G *= 2;
  const int q = threadIdx.x / E;
  const int j = threadIdx.x % E;
  for (int e0 = 0; e0 < cols; e0 += E) {
    const int e = e0 + j;
    if (q < G) {
      float s = 0.f;
      if (e < cols) {
        for (int r0 = q; r0 < R; r0 += kFoldBatch * G) {
          float v[kFoldBatch];
#pragma unroll
          for (int k = 0; k < kFoldBatch; ++k) {
            const int r = r0 + k * G;
            v[k] = r < R ? __ldcg(rows + (size_t)r * stride + e) : 0.f;
          }
#pragma unroll
          for (int k = 0; k < kFoldBatch; ++k) {
            if (r0 + k * G < R) s += v[k];
          }
        }
      }
      sh[threadIdx.x] = s;
    }
    __syncthreads();
    for (int h = G / 2; h > 0; h /= 2) {
      if (q < h) sh[threadIdx.x] += sh[threadIdx.x + h * E];
      __syncthreads();
    }
    if (q == 0 && e < cols) fin(e, sh[threadIdx.x]);
    __syncthreads();
  }
}

// Sum `row` (`width` floats in this block's shared memory, written by the caller)
// over the grid and call fin(e, total of element e) once per element. The kernel runs
// as a 1-D grid of clusters (launch_clustered); `rows` holds gridDim.x / cluster size
// rows of `width` floats of global scratch; `ticket` is a device counter that is 0 at
// launch (and is 0 again when the kernel ends). `sh` holds blockDim.x floats of shared
// memory other than `row`. Every thread of the grid calls it, as the last thing the
// kernel does.
template <typename Fin>
__device__ void grid_reduce(float* row, int width, float* __restrict__ rows,
                            unsigned int* ticket, float* sh, Fin&& fin) {
  __shared__ bool last;
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const unsigned csize = cluster.num_blocks();
  const unsigned clusters = gridDim.x / csize;
  cluster.sync();  // every block's row is written, and visible across the cluster
  if (rank == 0) {
    float* out = rows + (size_t)(blockIdx.x / csize) * width;
    for (int e = threadIdx.x; e < width; e += blockDim.x) {
      float v[kClusterMax];
#pragma unroll
      for (unsigned r = 1; r < kClusterMax; ++r)
        v[r] = r < csize ? cluster.map_shared_rank(row, r)[e] : 0.f;
      float s = row[e];
#pragma unroll
      for (unsigned r = 1; r < kClusterMax; ++r) {
        if (r < csize) s += v[r];
      }
      out[e] = s;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      // release: this cluster's row (written by the whole block, ordered by the
      // barrier above) before its ticket; acquire: the last one sees every row
      cuda::atomic_ref<unsigned int, cuda::thread_scope_device> t(*ticket);
      const bool is_last = t.fetch_add(1u, cuda::memory_order_acq_rel) == clusters - 1;
      if (is_last) t.store(0u, cuda::memory_order_relaxed);  // every ticket is drawn
      for (unsigned r = 0; r < csize; ++r) *cluster.map_shared_rank(&last, r) = is_last;
    }
  }
  cluster.sync();  // each rank knows whether its cluster is the last; rank 0 is done
                   // reading the other ranks' rows, so they may exit
  if (!last) return;
  // the last cluster: rank r folds its share of the columns over every cluster row
  const int share = (width + (int)csize - 1) / (int)csize;
  const int col0 = (int)rank * share;
  const int cols = width - col0 < share ? width - col0 : share;
  fold_rows(rows + col0, (int)clusters, cols, width, sh,
            [&](int e, float total) { fin(col0 + e, total); });
}

inline cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int blocks, int threads,
                                         size_t smem, int cluster, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)blocks, 1, 1);
  cfg.blockDim = dim3((unsigned)threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Launch `kernel` as `blocks` blocks (a multiple of `cluster`) of `threads` threads
// in clusters of `cluster` blocks, with `smem` bytes of dynamic shared memory; returns
// the launch's cudaError_t as an int (0 = success).
template <typename... Params, typename... Args>
int launch_clustered(void (*kernel)(Params...), int blocks, int threads, size_t smem,
                     int cluster, cudaStream_t stream, Args&&... args) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(&attr, blocks, threads, smem, cluster, stream);
  const cudaError_t rc = cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
  const cudaError_t last = cudaGetLastError();
  return (int)(rc != cudaSuccess ? rc : last);
}

// How many clusters of `cluster` blocks of `kernel` fit on the current device at
// once (cudaOccupancyMaxActiveClusters); minus the CUDA error code on failure.
template <typename... Params>
int max_active_clusters(void (*kernel)(Params...), int threads, size_t smem, int cluster) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(&attr, cluster, threads, smem, cluster, 0);
  int n = 0;
  const cudaError_t rc = cudaOccupancyMaxActiveClusters(&n, kernel, &cfg);
  if (rc != cudaSuccess) {
    cudaGetLastError();
    return -(int)rc;
  }
  return n;
}

}  // namespace vaegan
