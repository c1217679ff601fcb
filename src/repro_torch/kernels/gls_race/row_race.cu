// gls_row_race: per-row (min, argmin) of the GLS race table for Hopper,
// each row split over a thread-block cluster.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gls_race/kernel.py:236
// (`gls_row_race` -> `pl.pallas_call` at :268, body `_row_kernel`).
//
// Computes, for every row r of the (B*K, N) race table,
//   score[n] = isfinite(log_q[r, n]) ? log_s[r, n] - log_q[r, n] : +inf
//   rmin[r]  = min_n score[n],  rarg[r] = the LOWEST n attaining it.
// The mask is `isfinite(log_q)`, the semantics of the JAX reference
// (gls_race/ref.py), not the Pallas body's `log_q > -inf`: the two only
// differ on a +inf log_q, which must stay dead on every route.  An
// all-dead row reports (inf, 0).
//
// What bounds it on the card: bytes.  Each element is read once (two f32
// loads) for one subtract, one compare and a select, so the kernel is a
// pure stream of 8 * rows * N bytes.  At the reprefill verifier's shape
// (40 rows of 50,280) one block per row would leave 92 SMs idle, so:
//   * grid (splits, rows), launched as clusters of `splits` blocks
//     (cudaLaunchKernelEx with a cluster dimension).  Block i streams
//     elements [i chunk, (i + 1) chunk) of its row, chunk a multiple of 4
//     (the wrapper's plan, `ops.py::row_race_split_plan`: up to 8 splits,
//     enough blocks to cover the SMs), so the float4 path holds in every
//     block; a block past the row's end reduces nothing;
//   * 256 threads, eight blocks to an SM, each thread with one float4
//     load of each input in flight before its compares, streamed past L1
//     with 256-byte L2 fetches (2, 4 or 8 loads of each input in flight,
//     512 or 128 threads measured no faster: `tools/kernel_variants.py`);
//     the scalar path serves a row length not divisible by 4 or a
//     misaligned row;
//   * the block reduces its slice with the (value, index) rule `better`
//     (warp shuffles, then one warp over the warps) and writes its pair
//     into rank 0's shared memory through distributed shared memory
//     (map_shared_rank); after one cluster barrier rank 0 reduces the
//     pairs with the same rule.  The barrier's first phase, which only
//     says that rank 0 has started, is arrived at before the stream and
//     waited on after it, so the one barrier that blocks is the one that
//     publishes the pairs, and the peers exit without waiting for rank 0
//     (pulling the pairs from the peers cost a second barrier and a
//     remote read round trip: `tools/kernel_variants.py`).
// Exactness: "smaller value, or equal value and smaller index" is
// associative and commutative on pairs, so every split and thread order
// gives the sequential first minimum, bit for bit.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <climits>
#include <cmath>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 1;       // float4 loads of each input per thread
constexpr int kMaxSplits = 8;    // the portable cluster size
constexpr int kMaxGridY = 65535;

// A streamed float4: no L1 allocation, 256-byte L2 fetches.
__device__ __forceinline__ float4 ld_stream(const float4* p) {
  float4 r;
  asm("ld.global.nc.L1::no_allocate.L2::256B.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(r.x), "=f"(r.y), "=f"(r.z), "=f"(r.w)
      : "l"(p));
  return r;
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

__device__ __forceinline__ void consider(float ls, float lq, int idx,
                                         float& bv, int& bi) {
  const float sc = isfinite(lq) ? ls - lq : INFINITY;
  if (better(sc, idx, bv, bi)) {
    bv = sc;
    bi = idx;
  }
}

// The cluster barrier in its two halves: each thread arrives once per
// phase and waits before it arrives again.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire;" ::: "memory");
}

__device__ __forceinline__ void warp_reduce(float& bv, int& bi) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, bv, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gls_row_race_kernel(const float* __restrict__ log_s,
                    const float* __restrict__ log_q,
                    float* __restrict__ rmin, int* __restrict__ rarg,
                    int n, int chunk, int vec4) {
  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x;  // the block's rank in its cluster
  const size_t row = blockIdx.y;
  // The first barrier phase only says that every block of the cluster
  // has started (rank 0's shared memory exists): arrive now, wait after
  // the stream, when it has long completed.
  cluster_arrive_relaxed();
  const float* s = log_s + row * static_cast<size_t>(n);
  const float* q = log_q + row * static_cast<size_t>(n);
  const long long first = static_cast<long long>(split) * chunk;
  const int e0 = first < n ? static_cast<int>(first) : n;
  const int e1 = first + chunk < n ? static_cast<int>(first + chunk) : n;
  float bv = INFINITY;
  int bi = INT_MAX;
  if (vec4) {
    const float4* s4 = reinterpret_cast<const float4*>(s);
    const float4* q4 = reinterpret_cast<const float4*>(q);
    const int j1 = e1 / 4;
    for (int j = e0 / 4 + threadIdx.x; j < j1; j += kThreads * kUnroll) {
      float4 a[kUnroll], c[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int jj = j + u * kThreads;
        a[u] = c[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (jj < j1) {
          a[u] = ld_stream(s4 + jj);
          c[u] = ld_stream(q4 + jj);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int jj = j + u * kThreads;
        if (jj < j1) {
          consider(a[u].x, c[u].x, 4 * jj, bv, bi);
          consider(a[u].y, c[u].y, 4 * jj + 1, bv, bi);
          consider(a[u].z, c[u].z, 4 * jj + 2, bv, bi);
          consider(a[u].w, c[u].w, 4 * jj + 3, bv, bi);
        }
      }
    }
  } else {
    for (int j = e0 + threadIdx.x; j < e1; j += kThreads) {
      consider(__ldg(s + j), __ldg(q + j), j, bv, bi);
    }
  }
  warp_reduce(bv, bi);
  __shared__ float sv[kThreads / 32];
  __shared__ int si[kThreads / 32];
  __shared__ float part_v[kMaxSplits];  // rank 0's: one pair per block
  __shared__ int part_i[kMaxSplits];
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  if (lane == 0) {
    sv[warp] = bv;
    si[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    bv = lane < kThreads / 32 ? sv[lane] : INFINITY;
    bi = lane < kThreads / 32 ? si[lane] : INT_MAX;
    warp_reduce(bv, bi);
  }
  // Each block writes its pair into rank 0's shared memory; after the
  // second phase rank 0 reduces them, and the peers may exit.
  cluster_wait();
  if (threadIdx.x == 0) {
    *cluster.map_shared_rank(&part_v[split], 0) = bv;
    *cluster.map_shared_rank(&part_i[split], 0) = bi;
  }
  cluster_arrive();
  cluster_wait();
  if (split == 0 && warp == 0) {
    bv = lane < static_cast<int>(gridDim.x) ? part_v[lane] : INFINITY;
    bi = lane < static_cast<int>(gridDim.x) ? part_i[lane] : INT_MAX;
    warp_reduce(bv, bi);
    if (lane == 0) {
      rmin[row] = bv;
      // An all-masked row reports (inf, 0), like argmin over +inf.
      rarg[row] = bi == INT_MAX ? 0 : bi;
    }
  }
}

}  // namespace

int gls_row_race_max_splits() { return kMaxSplits; }

cudaError_t launch_gls_row_race(const float* log_s, const float* log_q,
                                float* rmin, int* rarg, int rows, int n,
                                int splits, int chunk, cudaStream_t stream) {
  const int vec4 = (n % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(log_s) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(log_q) % 16 == 0);
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // Rows beyond the grid's y limit go in further launches of the same
  // kind (a row offset keeps a float4 row 16-byte aligned).
  for (int r0 = 0; r0 < rows; r0 += kMaxGridY) {
    const size_t off = static_cast<size_t>(r0) * n;
    cfg.gridDim = dim3(splits, rows - r0 < kMaxGridY ? rows - r0 : kMaxGridY);
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, gls_row_race_kernel, log_s + off, log_q + off, rmin + r0,
        rarg + r0, n, chunk, vec4);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}
