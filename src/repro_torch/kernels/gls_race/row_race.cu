// gls_row_race: per-row (min, argmin) of the GLS race table for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gls_race/kernel.py
// (`gls_row_race` -> `pl.pallas_call` with body `_row_kernel`).
//
// Computes, for every row r of the (B*K, N) race table,
//   score[n] = isfinite(log_q[r, n]) ? log_s[r, n] - log_q[r, n] : +inf
//   rmin[r]  = min_n score[n],  rarg[r] = the LOWEST n attaining it.
// The mask is `isfinite(log_q)`, the semantics of the JAX reference
// (gls_race/ref.py), not the Pallas body's `log_q > -inf`: the two only
// differ on a +inf log_q, which must stay dead on every route.
//
// What bounds it on the card: bytes.  Each element is read once (two
// f32 loads) for one subtract, one compare and a select, so the kernel
// is a pure stream of 8*B*K*N bytes.  Design: one block per row keeps
// the reduction inside the block (no second pass, no atomics); 1024
// threads stride over N with 16-byte float4 loads where the row is
// 16-byte aligned, so consecutive threads touch consecutive addresses.
// Exactness: every comparison is on (value, index) pairs with the rule
// "smaller value, or equal value and smaller index", which is
// associative, so the warp-shuffle and cross-warp reductions reproduce
// the sequential first-minimum bit for bit whatever the thread order.
#include <cuda_runtime.h>
#include <stdint.h>
#include <climits>
#include <cmath>

namespace {

constexpr int kThreads = 1024;

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
                    int n, int vec4) {
  const size_t row = blockIdx.x;
  const float* s = log_s + row * static_cast<size_t>(n);
  const float* q = log_q + row * static_cast<size_t>(n);
  float bv = INFINITY;
  int bi = INT_MAX;
  if (vec4) {
    const float4* s4 = reinterpret_cast<const float4*>(s);
    const float4* q4 = reinterpret_cast<const float4*>(q);
    for (int j = threadIdx.x; j < n / 4; j += kThreads) {
      const float4 a = __ldg(s4 + j);
      const float4 b = __ldg(q4 + j);
      consider(a.x, b.x, 4 * j, bv, bi);
      consider(a.y, b.y, 4 * j + 1, bv, bi);
      consider(a.z, b.z, 4 * j + 2, bv, bi);
      consider(a.w, b.w, 4 * j + 3, bv, bi);
    }
  } else {
    for (int j = threadIdx.x; j < n; j += kThreads) {
      consider(__ldg(s + j), __ldg(q + j), j, bv, bi);
    }
  }
  warp_reduce(bv, bi);
  __shared__ float sv[kThreads / 32];
  __shared__ int si[kThreads / 32];
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
    if (lane == 0) {
      rmin[row] = bv;
      // An all-masked row reports (inf, 0), like argmin over +inf.
      rarg[row] = bi == INT_MAX ? 0 : bi;
    }
  }
}

}  // namespace

void launch_gls_row_race(const float* log_s, const float* log_q, float* rmin,
                         int* rarg, int rows, int n, cudaStream_t stream) {
  const int vec4 = (n % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(log_s) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(log_q) % 16 == 0);
  gls_row_race_kernel<<<rows, kThreads, 0, stream>>>(log_s, log_q, rmin, rarg,
                                                     n, vec4);
}
