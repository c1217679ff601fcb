// flash_attention: causal / sliding-window prefill attention with per-row
// arena offsets, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (`flash_attention` -> `pl.pallas_call` with body `_kernel`), float32
// path.  (The int8-scale branch of that kernel is off this serving path.)
//
//   q (B, H, S, D), k/v (B, Hkv, T, D), q_offset/kv_len (B,) -> (B, H, S, D)
// Query row s of batch row b sits at position q_offset[b] + s and attends
// key t iff  t < T  and  t < kv_len[b]  and  t <= q_pos  and
// (window > 0: t > q_pos - window) -- the masks of kernel.py:69-76 (the
// serving path's prefill is always causal).  Compiled for the served
// head dim only (D = 64, smollm-360m); the binding rejects any other.  The
// masked-row contract is ref.py::masked_softmax: the online softmax pins
// m_safe to 0 while a row's running max is -inf and floors the
// denominator at 1e-30, so a fully masked row (bucket padding,
// kv_len == 0) comes out as zeros.
//
// What bounds it on the card: at the admission shapes (S up to 256
// queries against up to a few hundred keys, D = 64) the work is
// ~4*S*T*D flops per head against (S + 2T)*D*4 bytes, tens of flops per
// byte, so float32 arithmetic bounds it (the serving path keeps float32
// "highest" precision, which rules out TF32 tensor cores).  Design: one
// block per (q-tile of 32 rows, head, batch row), four threads per query
// row, looping over KV tiles staged in shared memory; GQA maps head h to
// KV head h / G in the index arithmetic, so grouped heads share K/V
// without a repeated copy.  The KV loop is clipped to the tiles the
// block's masks can reach: it ends at min(kv_len, last causal position
// of the tile) and starts at the window's lower edge, so causal
// prefill does about half the work of the full square.  Query and K
// rows are padded to D + 1 floats in shared memory (conflict-free dot
// products); each thread owns D/4 output columns interleaved by 4 so the
// P@V reads of a warp hit distinct banks.
#include <cuda_runtime.h>
#include <cmath>

namespace {

constexpr int kThreads = 128;
constexpr int kTQ = 32;  // query rows per block: kThreads / 4
constexpr int kD = 64;   // head dim
constexpr int kTK = 32;  // keys per KV tile

template <int D, int TK>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const int* __restrict__ q_offset,
                       const int* __restrict__ kv_len,
                       float* __restrict__ out, int H, int Hkv, int S, int T,
                       int window) {
  constexpr int DP = D + 1;
  constexpr int DT = D / 4;
  constexpr int PP = TK + 1;
  __shared__ float q_s[kTQ * DP];
  __shared__ float k_s[TK * DP];
  __shared__ float v_s[TK * D];
  __shared__ float p_s[kTQ * PP];

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int G = H / Hkv;
  const int kvh = h / G;
  const int tid = threadIdx.x;
  const int r = tid / 4, sub = tid % 4;
  const int row0 = iq * kTQ;
  const int my_q = row0 + r;
  const int qoff = q_offset[b];
  const int qpos = qoff + my_q;
  const int klen = min(kv_len[b], T);

  const size_t q_base = (static_cast<size_t>(b) * H + h) * S * D;
  const size_t kv_base = (static_cast<size_t>(b) * Hkv + kvh) * T * D;
  for (int i = tid; i < kTQ * D; i += kThreads) {
    const int rr = i / D, d = i % D;
    const int s = row0 + rr;
    q_s[rr * DP + d] = s < S ? __ldg(q + q_base + static_cast<size_t>(s) * D + d) : 0.f;
  }

  const int kend = min(klen, qoff + min(row0 + kTQ, S));
  int kbeg = 0;
  if (window > 0) kbeg = max(0, qoff + row0 - window + 1);
  kbeg = (kbeg / TK) * TK;

  float acc[DT];
#pragma unroll
  for (int i = 0; i < DT; ++i) acc[i] = 0.f;
  float m = -INFINITY, l = 0.f;
  const float inv_sqrt_d = 1.0f / sqrtf(static_cast<float>(D));
  __syncthreads();

  for (int k0 = kbeg; k0 < kend; k0 += TK) {
    for (int i = tid; i < TK * D; i += kThreads) {
      const int t = i / D, d = i % D;
      const int kk = k0 + t;
      const bool ok = kk < T;
      const size_t off = kv_base + static_cast<size_t>(kk) * D + d;
      k_s[t * DP + d] = ok ? __ldg(k + off) : 0.f;
      v_s[t * D + d] = ok ? __ldg(v + off) : 0.f;
    }
    __syncthreads();

    float sc[TK / 4];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < TK / 4; ++j) {
      const int c = sub + 4 * j;
      const int kk = k0 + c;
      const bool ok = kk < T && kk < klen && kk <= qpos &&
                      (window <= 0 || kk > qpos - window);
      float s = -INFINITY;
      if (ok) {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot += q_s[r * DP + d] * k_s[c * DP + d];
        s = dot * inv_sqrt_d;
      }
      sc[j] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float m_safe = isfinite(m_new) ? m_new : 0.f;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < TK / 4; ++j) {
      // A masked score is exactly -inf; a live one is finite.
      const float p = sc[j] == -INFINITY ? 0.f : expf(sc[j] - m_safe);
      p_s[r * PP + sub + 4 * j] = p;
      psum += p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float alpha = isfinite(m) ? expf(m - m_safe) : 0.f;
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < DT; ++i) acc[i] *= alpha;
    for (int c = 0; c < TK; ++c) {
      const float p = p_s[r * PP + c];
#pragma unroll
      for (int i = 0; i < DT; ++i) acc[i] += p * v_s[c * D + sub + 4 * i];
    }
    __syncthreads();
  }

  if (my_q < S) {
    const float denom = fmaxf(l, 1e-30f);
    float* o = out + q_base + static_cast<size_t>(my_q) * D;
#pragma unroll
    for (int i = 0; i < DT; ++i) o[sub + 4 * i] = acc[i] / denom;
  }
}

}  // namespace

int flash_attention_head_dim() { return kD; }

void launch_flash_attention(const float* q, const float* k, const float* v,
                            const int* q_offset, const int* kv_len, float* out,
                            int B, int H, int Hkv, int S, int T, int window,
                            cudaStream_t stream) {
  const dim3 grid((S + kTQ - 1) / kTQ, H, B);
  flash_attention_kernel<kD, kTK><<<grid, kThreads, 0, stream>>>(
      q, k, v, q_offset, kv_len, out, H, Hkv, S, T, window);
}
