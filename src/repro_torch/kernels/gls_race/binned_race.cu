// gls_binned_race: per-(row, sheet, bin) (min, argmin) of the GLS race
// table for Hopper -- the Wyner-Ziv compression race.
//
// Replaces the Pallas TPU kernel src/repro/kernels/gls_race/kernel.py
// (`gls_binned_race` -> `pl.pallas_call` with body `_binned_kernel`).
//
// Computes, for every row r of the (B*K, N) race table with bin ids
// bins[b, n] in [0, l_max) (b = r / K),
//   score[n]   = isfinite(log_q[r, n]) ? log_s[r, n] - log_q[r, n] : +inf
//   bmin[r, l] = min over {n : bins[b, n] == l} of score[n]
//   barg[r, l] = the LOWEST such n attaining it,
// with (inf, 0) for a bin that holds no atom of finite score.  An atom
// whose bin id lies outside [0, l_max) belongs to no bin.  log_s holds
// race times (never NaN); the mask is the JAX reference's `isfinite`.
//
// What bounds it on the card: bytes.  Each atom is read once per row
// (two f32 loads) plus its bin id, for one subtract, one compare and
// one shared-memory update: a stream of 8*B*K*N + 4*B*N bytes.
// Design: one block per row; the K rows of one batch element are
// neighbours in the grid, so their reads of the same bin-id row meet in
// L2.  Threads stride the atom axis with 16-byte loads where the row
// is 16-byte aligned (scalar loads otherwise).  The l_max accumulators
// live in shared memory as 64-bit keys (ordered score bits << 32 | n):
// the smallest key is the smallest score at the lowest index, which is
// argmin's tie rule, and `atomicMin` on keys gives that result whatever
// the order threads arrive in.  A thread first reads the shared key and
// only issues the atomic when it would lower it, so after the first
// few atoms almost no atomics are issued even at l_max = 2, where every
// thread of the block aims at the same two words.
#include <cuda_runtime.h>
#include <stdint.h>
#include <cmath>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBins = 64;

// float -> uint32 whose unsigned order is the float order (non-NaN);
// -0.0 is first made +0.0 so the two compare equal, as in the reference.
__device__ __forceinline__ uint32_t ordered_bits(float v) {
  const uint32_t u = __float_as_uint(v == 0.0f ? 0.0f : v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float race_score(float ls, float lq) {
  return isfinite(lq) ? ls - lq : INFINITY;
}

__device__ __forceinline__ void consider(float ls, float lq, int bin, int idx,
                                         int l_max,
                                         unsigned long long* keys) {
  if (static_cast<unsigned>(bin) >= static_cast<unsigned>(l_max)) return;
  const unsigned long long key =
      (static_cast<unsigned long long>(ordered_bits(race_score(ls, lq)))
       << 32) | static_cast<unsigned>(idx);
  if (key < keys[bin]) atomicMin(&keys[bin], key);
}

__global__ void __launch_bounds__(kThreads)
gls_binned_race_kernel(const float* __restrict__ log_s,
                       const float* __restrict__ log_q,
                       const int* __restrict__ bins,
                       float* __restrict__ bmin, int* __restrict__ barg,
                       int rows_per_batch, int n, int l_max, int vec4) {
  __shared__ unsigned long long keys[kMaxBins];
  const size_t row = blockIdx.x;
  const float* s = log_s + row * static_cast<size_t>(n);
  const float* q = log_q + row * static_cast<size_t>(n);
  const int* bn = bins + (row / rows_per_batch) * static_cast<size_t>(n);
  // (+inf, 0): an empty bin, and the key no atom of score +inf beats.
  const unsigned long long empty =
      static_cast<unsigned long long>(ordered_bits(INFINITY)) << 32;
  for (int l = threadIdx.x; l < l_max; l += kThreads) keys[l] = empty;
  __syncthreads();
  if (vec4) {
    const float4* s4 = reinterpret_cast<const float4*>(s);
    const float4* q4 = reinterpret_cast<const float4*>(q);
    const int4* b4 = reinterpret_cast<const int4*>(bn);
    for (int j = threadIdx.x; j < n / 4; j += kThreads) {
      const float4 a = __ldg(s4 + j);
      const float4 b = __ldg(q4 + j);
      const int4 c = __ldg(b4 + j);
      consider(a.x, b.x, c.x, 4 * j, l_max, keys);
      consider(a.y, b.y, c.y, 4 * j + 1, l_max, keys);
      consider(a.z, b.z, c.z, 4 * j + 2, l_max, keys);
      consider(a.w, b.w, c.w, 4 * j + 3, l_max, keys);
    }
  } else {
    for (int j = threadIdx.x; j < n; j += kThreads) {
      consider(__ldg(s + j), __ldg(q + j), __ldg(bn + j), j, l_max, keys);
    }
  }
  __syncthreads();
  for (int l = threadIdx.x; l < l_max; l += kThreads) {
    const unsigned long long key = keys[l];
    const int idx = static_cast<int>(key & 0xffffffffull);
    // The score is recomputed at the winning atom rather than decoded
    // from the key, so a -0.0 minimum keeps its sign as in the reference.
    bmin[row * l_max + l] =
        key == empty ? INFINITY : race_score(s[idx], q[idx]);
    barg[row * l_max + l] = idx;
  }
}

}  // namespace

int gls_binned_race_max_bins() { return kMaxBins; }

void launch_gls_binned_race(const float* log_s, const float* log_q,
                            const int* bins, float* bmin, int* barg,
                            int batch, int rows_per_batch, int n, int l_max,
                            cudaStream_t stream) {
  const int vec4 = (n % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(log_s) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(log_q) % 16 == 0) &&
                   (reinterpret_cast<uintptr_t>(bins) % 16 == 0);
  gls_binned_race_kernel<<<batch * rows_per_batch, kThreads, 0, stream>>>(
      log_s, log_q, bins, bmin, barg, rows_per_batch, n, l_max, vec4);
}
