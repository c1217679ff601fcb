// gls_race: the single-step joint GLS race (the paper's Algorithm 1 in
// kernel form) for Hopper, each batch row split over a thread-block
// cluster.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gls_race/kernel.py:369
// (`gls_race` -> `pl.pallas_call` at :397, body `_kernel`).
//
// Computes, for every batch row b of three (B, K, N) tables and the
// (B, K) active mask,
//   x[b, k] = argmin_n (isfinite(log_p) ? log_s - log_p : +inf)[b, k, n]
//   y[b]    = argmin_n min_{k active} (isfinite(log_q) ? log_s - log_q
//                                                       : +inf)[b, k, n]
// with ties to the lower index and 0 for a row with nothing live.  The
// mask is `isfinite`, the semantics of the JAX reference
// (gls_race/ref.py), not the Pallas body's `> -inf`: the two differ
// only on a +inf log-probability, which must stay dead on every route.
// y is one (score, n) minimum over all active (k, n): the smallest
// score at the lowest n, which is "min over k, then argmin over n".
//
// What bounds it on the card: bytes.  Each element of log_s and log_p is
// read once, and of log_q once where its draft is active (the target
// race skips an inactive draft's row), for two subtracts and two
// compares.  One block per batch row (the first design) left 112 of the
// 132 SMs idle at the serving race shape (20, 8, 49152) and streamed at
// ~1.1 TB/s, so:
//   * grid (ceil(K / kc), B), launched as clusters of one row's blocks
//     (cudaLaunchKernelEx with a cluster dimension); the wrapper's plan
//     (`ops.py::joint_race_split_plan`) gives block r of a row the
//     drafts [r kc, (r + 1) kc) over the whole vocabulary: at K = 8 one
//     draft a block, 160 blocks at the serve shape;
//   * 512 threads a block, each with two streamed float4 loads of each
//     input in flight (L1 no-allocate, 256-byte L2 fetches); the scalar
//     path serves a row length not divisible by 4 or a misaligned table;
//   * for each draft the block reduces the draft's (score, n) pair with
//     the rule `better` (warp shuffles, then one warp over the warps) and
//     writes x itself; every thread carries its target pair across the
//     block's drafts;
//   * the blocks' target pairs go into rank 0's shared memory through
//     distributed shared memory (map_shared_rank); after one cluster
//     barrier rank 0 reduces them with the same rule and writes y.  The
//     barrier's first phase, which only says that rank 0 has started, is
//     arrived at before the stream and waited on after it, so only the
//     publishing barrier blocks, and the peers exit without waiting for
//     rank 0.
// Exactness: "smaller value, or equal value and smaller index" is
// associative and commutative on pairs, so every split and thread order
// gives the sequential first minimum, bit for bit.
//
// `gls_race_floor_kernel` is the floor of this design, for measurement
// only (`chip_smoke.py` times it beside the kernel): the same grid,
// clusters and loads with no compares or reductions.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <climits>
#include <cmath>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 2;       // float4 loads of each input per thread
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

__device__ __forceinline__ void take(float v, int i, float& bv, int& bi) {
  if (better(v, i, bv, bi)) {
    bv = v;
    bi = i;
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
    take(__shfl_down_sync(0xffffffffu, bv, off),
         __shfl_down_sync(0xffffffffu, bi, off), bv, bi);
  }
}

// Block-wide (value, index) minimum; the result is valid in thread 0.
__device__ void block_reduce(float& bv, int& bi, float* sv, int* si) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  warp_reduce(bv, bi);
  __syncthreads();  // sv/si may still be read by the previous reduction
  if (lane == 0) {
    sv[warp] = bv;
    si[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    bv = lane < kWarps ? sv[lane] : INFINITY;
    bi = lane < kWarps ? si[lane] : INT_MAX;
    warp_reduce(bv, bi);
  }
}

__device__ __forceinline__ void consider(float ls, float lp, float lq, int n,
                                         bool act, float& dv, int& di,
                                         float& tv, int& ti) {
  take(isfinite(lp) ? ls - lp : INFINITY, n, dv, di);
  if (act) take(isfinite(lq) ? ls - lq : INFINITY, n, tv, ti);
}

// One draft's rows of n elements: its draft pair (dv, di) and, where the
// draft is active, the thread's target pair (tv, ti).
__device__ __forceinline__ void stream_draft(const float* s, const float* p,
                                             const float* q, bool act, int n,
                                             int vec4, float& dv, int& di,
                                             float& tv, int& ti) {
  if (vec4) {
    const float4* s4 = reinterpret_cast<const float4*>(s);
    const float4* p4 = reinterpret_cast<const float4*>(p);
    const float4* q4 = reinterpret_cast<const float4*>(q);
    const int j1 = n / 4;
    for (int j = threadIdx.x; j < j1; j += kThreads * kUnroll) {
      float4 a[kUnroll], c[kUnroll], e[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int jj = j + u * kThreads;
        a[u] = c[u] = e[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (jj < j1) {
          a[u] = ld_stream(s4 + jj);
          c[u] = ld_stream(p4 + jj);
          if (act) e[u] = ld_stream(q4 + jj);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int jj = j + u * kThreads;
        if (jj < j1) {
          consider(a[u].x, c[u].x, e[u].x, 4 * jj, act, dv, di, tv, ti);
          consider(a[u].y, c[u].y, e[u].y, 4 * jj + 1, act, dv, di, tv, ti);
          consider(a[u].z, c[u].z, e[u].z, 4 * jj + 2, act, dv, di, tv, ti);
          consider(a[u].w, c[u].w, e[u].w, 4 * jj + 3, act, dv, di, tv, ti);
        }
      }
    }
  } else {
    for (int j = threadIdx.x; j < n; j += kThreads) {
      consider(__ldg(s + j), __ldg(p + j), act ? __ldg(q + j) : 0.f, j, act,
               dv, di, tv, ti);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
gls_race_kernel(const float* __restrict__ log_s,
                const float* __restrict__ log_p,
                const float* __restrict__ log_q,
                const bool* __restrict__ active, int* __restrict__ x,
                int* __restrict__ y, int k_drafts, int n, int kc, int vec4) {
  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x;  // the block's rank in its cluster
  const int splits = gridDim.x;
  const size_t b = blockIdx.y;
  // The first barrier phase only says that every block of the cluster
  // has started (rank 0's shared memory exists): arrive now, wait after
  // the stream.
  if (splits > 1) cluster_arrive_relaxed();
  __shared__ float sv[kWarps];
  __shared__ int si[kWarps];
  __shared__ float part_tv[kMaxSplits];  // rank 0's
  __shared__ int part_ti[kMaxSplits];
  const int k_begin = split * kc;
  const int k_end = min(k_drafts, k_begin + kc);
  float tv = INFINITY;
  int ti = INT_MAX;
  for (int k = k_begin; k < k_end; ++k) {
    const size_t off = (b * k_drafts + k) * static_cast<size_t>(n);
    float dv = INFINITY;
    int di = INT_MAX;
    stream_draft(log_s + off, log_p + off, log_q + off,
                 active[b * k_drafts + k], n, vec4, dv, di, tv, ti);
    block_reduce(dv, di, sv, si);
    // A row whose every score is +inf keeps its first index: argmin 0.
    if (threadIdx.x == 0) x[b * k_drafts + k] = di == INT_MAX ? 0 : di;
  }
  block_reduce(tv, ti, sv, si);
  if (splits == 1) {
    if (threadIdx.x == 0) y[b] = ti == INT_MAX ? 0 : ti;
    return;
  }
  // Each block writes its target pair into rank 0's shared memory; after
  // the second phase rank 0 reduces them, and the peers may exit.
  cluster_wait();
  if (threadIdx.x == 0) {
    *cluster.map_shared_rank(&part_tv[split], 0) = tv;
    *cluster.map_shared_rank(&part_ti[split], 0) = ti;
  }
  cluster_arrive();
  cluster_wait();
  const int lane = threadIdx.x % 32;
  if (split == 0 && threadIdx.x < 32) {
    tv = lane < splits ? part_tv[lane] : INFINITY;
    ti = lane < splits ? part_ti[lane] : INT_MAX;
    warp_reduce(tv, ti);
    if (lane == 0) y[b] = ti == INT_MAX ? 0 : ti;
  }
}

// The floor of the design above: its grid, clusters and loads (every
// draft's log_s and log_p, log_q where active, by the same streamed
// float4 loads), folded by xor to keep them, with no compares or block
// reductions; one cluster barrier; x and y written as zeros.  Not a
// race: its output is not checked.
__global__ void __launch_bounds__(kThreads)
gls_race_floor_kernel(const float* __restrict__ log_s,
                      const float* __restrict__ log_p,
                      const float* __restrict__ log_q,
                      const bool* __restrict__ active, int* __restrict__ x,
                      int* __restrict__ y, int k_drafts, int n, int kc,
                      int vec4) {
  const int split = blockIdx.x, splits = gridDim.x;
  const size_t b = blockIdx.y;
  if (splits > 1) cluster_arrive_relaxed();
  const int k_begin = split * kc;
  const int k_end = min(k_drafts, k_begin + kc);
  uint32_t acc = 0;
  for (int k = k_begin; k < k_end; ++k) {
    const size_t off = (b * k_drafts + k) * static_cast<size_t>(n);
    const bool act = active[b * k_drafts + k];
    const float4* s4 = reinterpret_cast<const float4*>(log_s + off);
    const float4* p4 = reinterpret_cast<const float4*>(log_p + off);
    const float4* q4 = reinterpret_cast<const float4*>(log_q + off);
    const int j1 = vec4 ? n / 4 : 0;
    for (int j = threadIdx.x; j < j1; j += kThreads * kUnroll) {
      float4 a[kUnroll], c[kUnroll], e[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int jj = j + u * kThreads;
        a[u] = c[u] = e[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (jj < j1) {
          a[u] = ld_stream(s4 + jj);
          c[u] = ld_stream(p4 + jj);
          if (act) e[u] = ld_stream(q4 + jj);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        acc ^= __float_as_uint(a[u].x) ^ __float_as_uint(c[u].x) ^
               __float_as_uint(e[u].x);
        acc ^= __float_as_uint(a[u].y) ^ __float_as_uint(c[u].y) ^
               __float_as_uint(e[u].y);
        acc ^= __float_as_uint(a[u].z) ^ __float_as_uint(c[u].z) ^
               __float_as_uint(e[u].z);
        acc ^= __float_as_uint(a[u].w) ^ __float_as_uint(c[u].w) ^
               __float_as_uint(e[u].w);
      }
    }
    if (threadIdx.x == 0) x[b * k_drafts + k] = 0;
  }
  // Never true for these tables; keeps the loads.
  if (acc == 0x7f7f7f7fu && vec4 == 7) y[b] = static_cast<int>(acc);
  if (splits > 1) {
    cluster_wait();
    cluster_arrive();
    cluster_wait();
  }
  if (split == 0 && threadIdx.x == 0) y[b] = 0;
}

using JointKernel = void (*)(const float*, const float*, const float*,
                             const bool*, int*, int*, int, int, int, int);

// Launches `kernel` over grid (ceil(K / kc), batch) in clusters of one
// row's blocks; rows beyond the grid's y limit go in further launches
// (a row offset keeps a float4 row 16-byte aligned).
cudaError_t launch_joint(JointKernel kernel, const float* log_s,
                         const float* log_p, const float* log_q,
                         const bool* active, int* x, int* y, int batch,
                         int k_drafts, int n, int kc, cudaStream_t stream) {
  const int vec4 = (n % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(log_s) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(log_p) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(log_q) % 16 == 0);
  const int splits = (k_drafts + kc - 1) / kc;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kThreads);
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = splits > 1 ? 1 : 0;
  for (int r0 = 0; r0 < batch; r0 += kMaxGridY) {
    const size_t off = static_cast<size_t>(r0) * k_drafts * n;
    const size_t koff = static_cast<size_t>(r0) * k_drafts;
    cfg.gridDim =
        dim3(splits, batch - r0 < kMaxGridY ? batch - r0 : kMaxGridY);
    const cudaError_t err = cudaLaunchKernelEx(
        &cfg, kernel, log_s + off, log_p + off, log_q + off, active + koff,
        x + koff, y + r0, k_drafts, n, kc, vec4);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

}  // namespace

int gls_race_max_splits() { return kMaxSplits; }

cudaError_t launch_gls_race(const float* log_s, const float* log_p,
                            const float* log_q, const bool* active, int* x,
                            int* y, int batch, int k_drafts, int n, int kc,
                            cudaStream_t stream) {
  return launch_joint(gls_race_kernel, log_s, log_p, log_q, active, x, y,
                      batch, k_drafts, n, kc, stream);
}

cudaError_t launch_gls_race_floor(const float* log_s, const float* log_p,
                                  const float* log_q, const bool* active,
                                  int* x, int* y, int batch, int k_drafts,
                                  int n, int kc, cudaStream_t stream) {
  return launch_joint(gls_race_floor_kernel, log_s, log_p, log_q, active, x,
                      y, batch, k_drafts, n, kc, stream);
}
