// ssd_chunk: the Mamba-2 SSD intra-chunk computation for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_chunk/kernel.py
// (`ssd_chunk` -> `pl.pallas_call` with body `_kernel`).
//
// For every (batch b, chunk c, head h), with x (Q, P), dt (Q,), a, and
// the chunk's B, C (Q, N) shared by all heads (n_groups = 1):
//   cum     = inclusive cumsum of dt * a           total = cum[Q-1]
//   decay   = exp(cum_i - cum_j) for i >= j, exactly 0 above the diagonal
//   y       = (C B^T (.) decay) (x dt)                       (Q, P)
//   state   = (B (.) exp(total - cum))^T (x dt), stored (P, N)
// exactly what ssd_chunk_ref (src/repro/kernels/ssd_chunk/ref.py)
// computes, up to float32 summation order.  `exp` is never evaluated
// above the diagonal, where cum_i - cum_j > 0 would overflow.
//
// What bounds it on the card: at the served tile (Q 64, P 64, N 128)
// the float32 operations and the bytes (the (P, N) states dominate the
// traffic) are about even.  Design: the Pallas grid recomputes C B^T
// for every head; here one block owns a (b, c) chunk and a group of
// kHeads heads, loads B and C into shared memory once and forms
// C B^T (Q x Q) once for the group.  Per head it stages x dt and the
// decay-weighted W = C B^T (.) decay in shared memory (over C, which is
// dead by then), and every thread accumulates a register tile of y and
// of the state with float32 FMAs from shared memory; no wgmma or TMA
// yet, and no TF32, as the port's precision policy requires.  Shared
// rows are padded so the column reads of each product are free of bank
// conflicts.  About 85 KB of dynamic shared memory per block, above the
// 48 KB static limit, hence cudaFuncSetAttribute before the first
// launch on each device.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;     // chunk length
constexpr int kP = 64;     // SSM head dim
constexpr int kN = 128;    // SSM state
constexpr int kHeads = 8;  // heads per block (C B^T shared by them)
constexpr int kThreads = 256;
constexpr int kBN = kN + 4;   // padded row of B and C (float4 aligned)
constexpr int kWQ = kQ + 1;   // padded row of C B^T and W

// Shared memory layout, in floats.
constexpr int kOffB = 0;                        // B  (Q, kBN)
constexpr int kOffC = kOffB + kQ * kBN;         // C  (Q, kBN); later W, xdt
constexpr int kOffW = kOffC;                    // W  (Q, kWQ)
constexpr int kOffX = kOffW + kQ * kWQ;         // xdt (Q, P)
constexpr int kOffCB = kOffC + kQ * kBN;        // C B^T (Q, kWQ)
constexpr int kOffCum = kOffCB + kQ * kWQ;      // cum (Q)
constexpr int kOffRem = kOffCum + kQ;           // exp(total - cum) (Q)
constexpr int kOffDt = kOffRem + kQ;            // dt (Q)
constexpr int kSmemFloats = kOffDt + kQ;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

static_assert(kOffX + kQ * kP <= kOffCB, "W and xdt must fit over C");
static_assert(kThreads == 256, "the register tiles assume 256 threads");

__global__ void __launch_bounds__(kThreads)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a, const float* __restrict__ b_in,
                 const float* __restrict__ c_in, float* __restrict__ y,
                 float* __restrict__ states, float* __restrict__ total,
                 int n_chunks, int n_heads, int head_groups) {
  extern __shared__ __align__(16) float smem[];
  float* Bs = smem + kOffB;
  float* Cs = smem + kOffC;
  float* Ws = smem + kOffW;
  float* Xs = smem + kOffX;
  float* CBs = smem + kOffCB;
  float* cum = smem + kOffCum;
  float* rem = smem + kOffRem;
  float* dts = smem + kOffDt;

  const int tid = threadIdx.x;
  const int group = blockIdx.x % head_groups;
  const size_t bc = blockIdx.x / head_groups;  // b * n_chunks + c
  const int h0 = group * kHeads;
  const int h1 = min(n_heads, h0 + kHeads);

  // B and C of the chunk, 16-byte loads, into padded rows.
  const float4* b4 = reinterpret_cast<const float4*>(b_in + bc * kQ * kN);
  const float4* c4 = reinterpret_cast<const float4*>(c_in + bc * kQ * kN);
  for (int e = tid; e < kQ * kN / 4; e += kThreads) {
    const int i = e / (kN / 4), n4 = e % (kN / 4);
    *reinterpret_cast<float4*>(Bs + i * kBN + 4 * n4) = __ldg(b4 + e);
    *reinterpret_cast<float4*>(Cs + i * kBN + 4 * n4) = __ldg(c4 + e);
  }
  __syncthreads();

  // C B^T once for the head group: thread (ti, tj) holds rows
  // ti + 16u and columns tj + 16v, u, v < 4.
  {
    const int ti = tid % 16, tj = tid / 16;
    float acc[4][4] = {};
    for (int n = 0; n < kN; n += 4) {
      float4 cv[4], bv[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        cv[u] = *reinterpret_cast<const float4*>(Cs + (ti + 16 * u) * kBN + n);
        bv[u] = *reinterpret_cast<const float4*>(Bs + (tj + 16 * u) * kBN + n);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int v = 0; v < 4; ++v) {
          acc[u][v] = fmaf(cv[u].x, bv[v].x, acc[u][v]);
          acc[u][v] = fmaf(cv[u].y, bv[v].y, acc[u][v]);
          acc[u][v] = fmaf(cv[u].z, bv[v].z, acc[u][v]);
          acc[u][v] = fmaf(cv[u].w, bv[v].w, acc[u][v]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        CBs[(ti + 16 * u) * kWQ + tj + 16 * v] = acc[u][v];
      }
    }
  }
  __syncthreads();  // C is dead from here on: W and xdt reuse its space

  for (int h = h0; h < h1; ++h) {
    const size_t row0 = bc * kQ;  // (b, c, i = 0) in the (B, NC, Q) rows
    if (tid < kQ) dts[tid] = __ldg(dt + (row0 + tid) * n_heads + h);
    __syncthreads();
    if (tid == 0) {
      // The inclusive cumsum, in order, while the other threads stage
      // x dt.  In order, cum_i - cum_j keeps the rounding of the prefix
      // both share, so the decay is as exact as the plain version's; a
      // warp shuffle scan measured twice its error against float64 at
      // the same speed (PERF.md).
      const float ah = __ldg(a + h);
      float s = 0.0f;
      for (int i = 0; i < kQ; ++i) {
        s += dts[i] * ah;
        cum[i] = s;
      }
    }
    // x dt for this head (rows of P contiguous floats).
    for (int e = tid; e < kQ * kP / 4; e += kThreads) {
      const int i = e / (kP / 4), p4 = e % (kP / 4);
      float4 v = __ldg(reinterpret_cast<const float4*>(
          x + ((row0 + i) * n_heads + h) * kP) + p4);
      const float d = dts[i];
      v.x *= d;
      v.y *= d;
      v.z *= d;
      v.w *= d;
      *reinterpret_cast<float4*>(Xs + i * kP + 4 * p4) = v;
    }
    __syncthreads();
    const float tot = cum[kQ - 1];
    if (tid < kQ) rem[tid] = expf(tot - cum[tid]);
    // W = C B^T (.) decay; exp only on and below the diagonal.
    for (int e = tid; e < kQ * kQ; e += kThreads) {
      const int i = e / kQ, j = e % kQ;
      Ws[i * kWQ + j] = i >= j ? CBs[i * kWQ + j] * expf(cum[i] - cum[j])
                               : 0.0f;
    }
    __syncthreads();

    // y (Q, P): thread (ti, tp) holds rows ti + 16u and columns
    // 4 tp .. 4 tp + 3.
    {
      const int ti = tid % 16, tp = tid / 16;
      float acc[4][4] = {};
      for (int j = 0; j < kQ; ++j) {
        const float4 xv = *reinterpret_cast<const float4*>(Xs + j * kP +
                                                           4 * tp);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float w = Ws[(ti + 16 * u) * kWQ + j];
          acc[u][0] = fmaf(w, xv.x, acc[u][0]);
          acc[u][1] = fmaf(w, xv.y, acc[u][1]);
          acc[u][2] = fmaf(w, xv.z, acc[u][2]);
          acc[u][3] = fmaf(w, xv.w, acc[u][3]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = ti + 16 * u;
        *reinterpret_cast<float4*>(y + ((row0 + i) * n_heads + h) * kP +
                                   4 * tp) =
            make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
      }
    }

    // state (P, N): thread (tn, tp) holds rows tp + 16u and columns
    // 4 tn .. 4 tn + 3 and 64 + 4 tn .. 64 + 4 tn + 3.
    {
      const int tn = tid % 16, tp = tid / 16;
      float acc[4][8] = {};
      for (int j = 0; j < kQ; ++j) {
        const float r = rem[j];
        const float4 b0 = *reinterpret_cast<const float4*>(Bs + j * kBN +
                                                           4 * tn);
        const float4 b1 = *reinterpret_cast<const float4*>(Bs + j * kBN +
                                                           64 + 4 * tn);
        const float bw[8] = {b0.x * r, b0.y * r, b0.z * r, b0.w * r,
                             b1.x * r, b1.y * r, b1.z * r, b1.w * r};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const float xv = Xs[j * kP + tp + 16 * u];
#pragma unroll
          for (int v = 0; v < 8; ++v) acc[u][v] = fmaf(bw[v], xv, acc[u][v]);
        }
      }
      float* st = states + (bc * n_heads + h) * static_cast<size_t>(kP * kN);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int p = tp + 16 * u;
        *reinterpret_cast<float4*>(st + p * kN + 4 * tn) =
            make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]);
        *reinterpret_cast<float4*>(st + p * kN + 64 + 4 * tn) =
            make_float4(acc[u][4], acc[u][5], acc[u][6], acc[u][7]);
      }
    }
    if (tid == 0) total[bc * n_heads + h] = tot;
    __syncthreads();  // Xs, Ws, cum, rem are rewritten for the next head
  }
}

}  // namespace

int ssd_chunk_tile_q() { return kQ; }
int ssd_chunk_tile_p() { return kP; }
int ssd_chunk_tile_n() { return kN; }

cudaError_t launch_ssd_chunk(const float* x, const float* dt, const float* a,
                             const float* b_in, const float* c_in, float* y,
                             float* states, float* total, int batch,
                             int n_chunks, int n_heads, cudaStream_t stream) {
  // The dynamic shared memory above 48 KB is granted once per device.
  constexpr int kMaxDevices = 64;
  static bool granted[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices || !granted[device]) {
    err = cudaFuncSetAttribute(ssd_chunk_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(kSmemBytes));
    if (err != cudaSuccess) return err;
    if (device < kMaxDevices) granted[device] = true;
  }
  const int head_groups = (n_heads + kHeads - 1) / kHeads;
  const unsigned blocks = static_cast<unsigned>(batch) * n_chunks *
                          head_groups;
  ssd_chunk_kernel<<<blocks, kThreads, kSmemBytes, stream>>>(
      x, dt, a, b_in, c_in, y, states, total, n_chunks, n_heads,
      head_groups);
  return cudaSuccess;
}
