// gls_race: the single-step joint GLS race (the paper's Algorithm 1 in
// kernel form) for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gls_race/kernel.py
// (`gls_race` -> `pl.pallas_call` with body `_kernel`).
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
// What bounds it on the card: bytes.  Each element of the three tables
// is read once (12 bytes) for two subtracts and two compares.  Design:
// one block per batch row, 1024 threads striding the vocab axis with
// 16-byte loads where rows are 16-byte aligned.  For each draft k the
// block reduces the draft's (score, n) pair; every thread carries its
// running target pair across all k and the block reduces it once at the
// end.  The comparisons on (value, index) pairs are associative, so the
// shuffle tree reproduces the sequential first minimum bit for bit.
#include <cuda_runtime.h>
#include <stdint.h>
#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v < bv || (v == bv && i < bi);
}

__device__ __forceinline__ void take(float v, int i, float& bv, int& bi) {
  if (better(v, i, bv, bi)) {
    bv = v;
    bi = i;
  }
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

__global__ void __launch_bounds__(kThreads)
gls_race_kernel(const float* __restrict__ log_s,
                const float* __restrict__ log_p,
                const float* __restrict__ log_q,
                const bool* __restrict__ active, int* __restrict__ x,
                int* __restrict__ y, int k_drafts, int n, int vec4) {
  __shared__ float sv[kWarps];
  __shared__ int si[kWarps];
  const size_t b = blockIdx.x;
  float tv = INFINITY;
  int ti = INT_MAX;
  for (int k = 0; k < k_drafts; ++k) {
    const size_t off = (b * k_drafts + k) * static_cast<size_t>(n);
    const float* s = log_s + off;
    const float* p = log_p + off;
    const float* q = log_q + off;
    const bool act = active[b * k_drafts + k];
    float dv = INFINITY;
    int di = INT_MAX;
    if (vec4) {
      const float4* s4 = reinterpret_cast<const float4*>(s);
      const float4* p4 = reinterpret_cast<const float4*>(p);
      const float4* q4 = reinterpret_cast<const float4*>(q);
      for (int j = threadIdx.x; j < n / 4; j += kThreads) {
        const float4 a = __ldg(s4 + j);
        const float4 c = __ldg(p4 + j);
        const float4 e = __ldg(q4 + j);
        consider(a.x, c.x, e.x, 4 * j, act, dv, di, tv, ti);
        consider(a.y, c.y, e.y, 4 * j + 1, act, dv, di, tv, ti);
        consider(a.z, c.z, e.z, 4 * j + 2, act, dv, di, tv, ti);
        consider(a.w, c.w, e.w, 4 * j + 3, act, dv, di, tv, ti);
      }
    } else {
      for (int j = threadIdx.x; j < n; j += kThreads) {
        consider(__ldg(s + j), __ldg(p + j), __ldg(q + j), j, act, dv, di,
                 tv, ti);
      }
    }
    block_reduce(dv, di, sv, si);
    // A row whose every score is +inf keeps its first index: argmin 0.
    if (threadIdx.x == 0) x[b * k_drafts + k] = di == INT_MAX ? 0 : di;
  }
  block_reduce(tv, ti, sv, si);
  if (threadIdx.x == 0) y[b] = ti == INT_MAX ? 0 : ti;
}

}  // namespace

void launch_gls_race(const float* log_s, const float* log_p,
                     const float* log_q, const bool* active, int* x, int* y,
                     int batch, int k_drafts, int n, cudaStream_t stream) {
  const int vec4 = (n % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(log_s) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(log_p) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(log_q) % 16 == 0);
  gls_race_kernel<<<batch, kThreads, 0, stream>>>(log_s, log_p, log_q, active,
                                                  x, y, k_drafts, n, vec4);
}
