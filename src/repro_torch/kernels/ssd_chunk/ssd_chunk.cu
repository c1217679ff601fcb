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
// what ssd_chunk_ref (src/repro/kernels/ssd_chunk/ref.py) computes, up
// to rounding (the cumsum and the decay differences are float64 here).
// `exp` is never evaluated above the diagonal, where cum_i - cum_j > 0
// would overflow.
//
// What bounds it on the card: at the served tile (Q 64, P 64, N 128)
// the float32 FMAs (the (P, N) state product is 4/5 of them) and the
// bytes (the (P, N) states are half the traffic) are about even, so the
// design keeps the FMA pipes fed and the stores streaming at once.
//
// One block of 8 warps owns a (b, c) chunk and a group of kHeads (16)
// heads.  At block start B and C arrive by cp.async, C B^T is formed
// once for the group (on and below the diagonal only), and one lane per
// head runs the cumsum of every head of the group in order and in
// float64, then exp(total - cum) dt for all of them.  Per head there are
// no serial phases and one barrier:
//   * each warp forms W = C B^T (.) decay (.) dt for its own rows only
//     -- the 4-row blocks w and 15 - w, so every warp has the same causal
//     work -- in a warp-private buffer, and runs the y product over j <=
//     the block's last row: the causal half, 8 rows x 2 columns per lane;
//   * each warp runs the state product for 16 rows of P against 64
//     columns of N, 8 x 4 per lane, with B weighted by exp(total - cum)
//     dt: per step of j, two broadcast float4 loads of x and one float4
//     of B feed 32 FMAs, and each half-warp writes a 256-byte row of the
//     state (streaming stores: nothing here reads them again);
//   * the next head's x arrives by cp.async in the other half of a
//     double buffer while this head's products run.
// The decay differences cum_i - cum_j and total - cum_j come from the
// float64 cumsum, so the kernel carries none of the float32 prefix
// rounding that dominates the plain version's error against float64;
// the products are float32 FMAs in ascending j.  No wgmma and no TF32,
// as the port's precision policy requires.  106 KB of dynamic shared
// memory and 256 threads per block: two blocks per SM, and the serve
// shape's 256 blocks in one wave.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kQ = 64;      // chunk length
constexpr int kP = 64;      // SSM head dim
constexpr int kN = 128;     // SSM state
constexpr int kHeads = 16;  // heads per block (C B^T shared)
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBN = kN + 4;     // padded row of B and C (float4 aligned)
constexpr int kWQ = kQ + 1;     // padded row of C B^T
constexpr int kRows = 4;        // rows of y in one W block
constexpr int kWarpW = kRows * (kQ + kRows);  // W floats of one warp

// Shared memory layout, in floats.
constexpr int kOffB = 0;                          // B     (Q, kBN)
constexpr int kOffCB = kOffB + kQ * kBN;          // C B^T (Q, kWQ)
constexpr int kOffDt = kOffCB + kQ * kWQ;         // dt    (kHeads, Q)
constexpr int kOffWt = kOffDt + kHeads * kQ;     // exp(total - cum) dt
constexpr int kOffCum = kOffWt + kHeads * kQ;     // cum   (kHeads, Q) f64
constexpr int kOffX = kOffCum + 2 * kHeads * kQ;  // x     (2, Q, P)
constexpr int kOffW = kOffX + 2 * kQ * kP;        // W     (kWarps, kWarpW)
constexpr int kOffC = kOffX;                      // C     (Q, kBN), dead
                                                  // once C B^T is formed
constexpr int kSmemFloats = kOffW + kWarps * kWarpW;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

static_assert(kOffC + kQ * kBN <= kSmemFloats, "C must fit");
static_assert(kOffWt % 4 == 0 && kOffCum % 2 == 0 && kOffX % 4 == 0 && kOffW % 4 == 0 &&
                  kWarpW % 4 == 0,
              "double and float4 alignment");
static_assert(kHeads % kWarps == 0, "the cumsum lanes map heads to warps");
static_assert(kRows * 2 * kWarps == kQ, "two W blocks per warp cover Q");
static_assert(kP == 16 * (kWarps / 2) && kN == 2 * 64,
              "state tile: 16 rows of P x 64 columns of N per warp");
static_assert(kThreads == 256, "the C B^T tiles assume 256 threads");

__device__ __forceinline__ void cp_async16(float* smem_dst,
                                           const float* gmem_src) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem_src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One head's x (Q rows of P floats, H * P apart) into a half of the
// double buffer, by every thread of the block.
__device__ __forceinline__ void copy_x(float* xs, const float* __restrict__ x,
                                       size_t row0, int n_heads, int h) {
  for (int e = threadIdx.x; e < kQ * kP / 4; e += kThreads) {
    const int i = e / (kP / 4), p4 = e % (kP / 4);
    cp_async16(xs + i * kP + 4 * p4, x + ((row0 + i) * n_heads + h) * kP +
                                         4 * p4);
  }
}

__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                 const float* __restrict__ a, const float* __restrict__ b_in,
                 const float* __restrict__ c_in, float* __restrict__ y,
                 float* __restrict__ states, float* __restrict__ total,
                 int n_heads, int head_groups) {
  extern __shared__ __align__(16) float smem[];
  float* Bs = smem + kOffB;
  float* Cs = smem + kOffC;
  float* CBs = smem + kOffCB;
  float* dts = smem + kOffDt;
  float* wts = smem + kOffWt;
  double* cums = reinterpret_cast<double*>(smem + kOffCum);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int group = blockIdx.x % head_groups;
  const size_t bc = blockIdx.x / head_groups;  // b * n_chunks + c
  const int h0 = group * kHeads;
  const int nh = min(kHeads, n_heads - h0);
  const size_t row0 = bc * kQ;  // (b, c, i = 0) in the (B, NC, Q) rows

  // B and C of the chunk into padded rows, the first head's x, and dt of
  // the group's heads.
  const float* bsrc = b_in + bc * kQ * kN;
  const float* csrc = c_in + bc * kQ * kN;
  for (int e = tid; e < kQ * kN / 4; e += kThreads) {
    const int i = e / (kN / 4), n4 = e % (kN / 4);
    cp_async16(Bs + i * kBN + 4 * n4, bsrc + 4 * e);
    cp_async16(Cs + i * kBN + 4 * n4, csrc + 4 * e);
  }
  for (int e = tid; e < kQ * kHeads; e += kThreads) {
    const int i = e / kHeads, hh = e % kHeads;
    dts[hh * kQ + i] =
        hh < nh ? __ldg(dt + (row0 + i) * n_heads + h0 + hh) : 0.0f;
  }
  cp_async_wait_all();
  __syncthreads();

  // The inclusive cumsum of every head of the group, in order and in
  // float64, one lane per head (lane hh / kWarps of warp hh % kWarps).
  // dt * a is exact in float64, so cum, cum_i - cum_j and total - cum_j
  // carry none of the float32 prefix rounding that dominates the plain
  // version's error.
  {
    const int hh = lane * kWarps + warp;
    if (lane < kHeads / kWarps && hh < nh) {
      const double ah = __ldg(a + h0 + hh);
      const float* d = dts + hh * kQ;
      double* cum = cums + hh * kQ;
      double s = 0.0;
      for (int i = 0; i < kQ; ++i) {
        s += static_cast<double>(d[i]) * ah;
        cum[i] = s;
      }
      total[bc * n_heads + h0 + hh] = static_cast<float>(s);
    }
  }

  // C B^T once for the head group, on and below the diagonal: thread
  // (ti, tj) holds rows ti + 16u and columns tj + 16v, u >= v.
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
        for (int v = 0; v <= u; ++v) {
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
      for (int v = 0; v <= u; ++v) {
        CBs[(ti + 16 * u) * kWQ + tj + 16 * v] = acc[u][v];
      }
    }
  }
  __syncthreads();  // C is dead: the x buffers and W reuse its space
  copy_x(smem + kOffX, x, row0, n_heads, h0);
  // exp(total - cum) dt of every head of the group (the state product's
  // weight of step j).
  for (int e = tid; e < nh * kQ; e += kThreads) {
    const double* cum = cums + (e / kQ) * kQ;
    wts[e] = expf(static_cast<float>(cum[kQ - 1] - cum[e % kQ])) * dts[e];
  }
  cp_async_wait_all();
  __syncthreads();

  // This warp's W blocks: rows rA .. rA + 3 (j < rA + 4) and rB .. rB + 3
  // (j < rB + 4), stored [j][row] so one float4 holds a step's 4 rows.
  float* Ww = smem + kOffW + warp * kWarpW;
  const int rA = kRows * warp;
  const int rB = kQ - kRows * (warp + 1);
  const int nA = rA + kRows, nB = rB + kRows;

  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    const float* xs = smem + kOffX + (hh & 1) * kQ * kP;
    if (hh + 1 < nh) {
      copy_x(smem + kOffX + ((hh + 1) & 1) * kQ * kP, x, row0, n_heads,
             h + 1);
    }

    // W = C B^T (.) decay (.) dt_j on this warp's rows; exp only on and
    // below the diagonal, of the float64 difference.
    const double* cum = cums + hh * kQ;
    const float* dth = dts + hh * kQ;
    for (int e = lane; e < kWarpW; e += 32) {
      const bool in_a = e < kRows * nA;
      const int e2 = in_a ? e : e - kRows * nA;
      const int j = e2 / kRows;
      const int i = (in_a ? rA : rB) + e2 % kRows;
      Ww[e] = i >= j ? CBs[i * kWQ + j] *
                           expf(static_cast<float>(cum[i] - cum[j])) * dth[j]
                     : 0.0f;
    }
    __syncwarp();

    // y: rows of both blocks, columns 2 lane, 2 lane + 1, over the causal
    // half (W is exactly 0 above the diagonal inside a block).
    {
      const float4* wa = reinterpret_cast<const float4*>(Ww);
      const float4* wb = reinterpret_cast<const float4*>(Ww + kRows * nA);
      float ya[kRows][2] = {}, yb[kRows][2] = {};
      int j = 0;
#pragma unroll 4
      for (; j < nA; ++j) {
        const float2 xv = *reinterpret_cast<const float2*>(xs + j * kP +
                                                           2 * lane);
        const float4 w4a = wa[j], w4b = wb[j];
        const float wra[kRows] = {w4a.x, w4a.y, w4a.z, w4a.w};
        const float wrb[kRows] = {w4b.x, w4b.y, w4b.z, w4b.w};
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          ya[r][0] = fmaf(wra[r], xv.x, ya[r][0]);
          ya[r][1] = fmaf(wra[r], xv.y, ya[r][1]);
          yb[r][0] = fmaf(wrb[r], xv.x, yb[r][0]);
          yb[r][1] = fmaf(wrb[r], xv.y, yb[r][1]);
        }
      }
#pragma unroll 4
      for (; j < nB; ++j) {
        const float2 xv = *reinterpret_cast<const float2*>(xs + j * kP +
                                                           2 * lane);
        const float4 w4b = wb[j];
        const float wrb[kRows] = {w4b.x, w4b.y, w4b.z, w4b.w};
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          yb[r][0] = fmaf(wrb[r], xv.x, yb[r][0]);
          yb[r][1] = fmaf(wrb[r], xv.y, yb[r][1]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        __stcs(reinterpret_cast<float2*>(y + ((row0 + rA + r) * n_heads + h) *
                                                 kP + 2 * lane),
               make_float2(ya[r][0], ya[r][1]));
        __stcs(reinterpret_cast<float2*>(y + ((row0 + rB + r) * n_heads + h) *
                                                 kP + 2 * lane),
               make_float2(yb[r][0], yb[r][1]));
      }
    }

    // state (P, N): warp (pb, nb) = (warp / 2, warp % 2) owns rows
    // 16 pb .. 16 pb + 15 and columns 64 nb .. 64 nb + 63; lane (ph, nl)
    // rows p0 .. p0 + 7 (p0 = 16 pb + 8 ph) and columns n0 .. n0 + 3
    // (n0 = 64 nb + 4 nl).  Per step of j the half-warps share a 256-byte
    // row of B and each reads 8 rows of x as two broadcast float4s.
    {
      const int p0 = 16 * (warp / 2) + 8 * (lane / 16);
      const int n0 = 64 * (warp % 2) + 4 * (lane % 16);
      const float4* wt4 = reinterpret_cast<const float4*>(wts + hh * kQ);
      float acc[8][4] = {};
#pragma unroll 2
      for (int j4 = 0; j4 < kQ / 4; ++j4) {
        const float4 w4 = wt4[j4];
        const float wj[4] = {w4.x, w4.y, w4.z, w4.w};
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * j4 + jj;
          const float r = wj[jj];
          const float4 bv = *reinterpret_cast<const float4*>(Bs + j * kBN + n0);
          const float bw[4] = {bv.x * r, bv.y * r, bv.z * r, bv.w * r};
          const float4 x0 = *reinterpret_cast<const float4*>(xs + j * kP + p0);
          const float4 x1 = *reinterpret_cast<const float4*>(xs + j * kP + p0 +
                                                             4);
          const float xv[8] = {x0.x, x0.y, x0.z, x0.w,
                               x1.x, x1.y, x1.z, x1.w};
#pragma unroll
          for (int u = 0; u < 8; ++u) {
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              acc[u][v] = fmaf(bw[v], xv[u], acc[u][v]);
            }
          }
        }
      }
      float* st = states + (bc * n_heads + h) * static_cast<size_t>(kP * kN);
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        __stcs(reinterpret_cast<float4*>(st + (p0 + u) * kN + n0),
               make_float4(acc[u][0], acc[u][1], acc[u][2], acc[u][3]));
      }
    }

    // The next head's x is visible and every warp is done with this
    // head's (and with its own W, which the next head rewrites).
    cp_async_wait_all();
    __syncthreads();
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
      x, dt, a, b_in, c_in, y, states, total, n_heads, head_groups);
  return cudaSuccess;
}
