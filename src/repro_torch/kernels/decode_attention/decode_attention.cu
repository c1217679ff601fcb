// decode_attention: one-query GQA attention over a KV cache for Hopper.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention/kernel.py (`decode_attention` ->
// `pl.pallas_call` with body `_kernel`), float32 path.  (The int8-scale
// branch of that kernel is off this serving path.)
//
//   q (B, H, D), k/v (B, Hkv, T, D), kv_len (B,) -> out (B, H, D)
//   out[b, h] = softmax_t(q[b,h] . k[b, h/G, t] / sqrt(D), t < kv_len[b])
//               @ v[b, h/G]
// with the Pallas kernel's masked-row contract: an online softmax whose
// running max starts at -inf, `m_safe` pinned to 0 while the max is
// still -inf, and the denominator floored at 1e-30, so a row with
// kv_len == 0 comes out as zeros (not NaN).  Compiled for the served
// head dim only (D = 64, smollm-360m); the binding rejects any other.
//
// What bounds it on the card: bytes.  One query token per head does 2*D
// flops per cached key element pair, far below the H100's ~20 flops per
// byte ridge for f32 CUDA cores, so the time is the K/V stream.  Design:
// one block per (b, kv-head) holding all G query heads of the group, so
// each K/V tile is read from device memory ONCE for the whole group (the
// TPU kernel's "G heads ride the sublanes"); G = 3 for smollm is neither
// a power of two nor a warp multiple, so work over (head, key) and
// (head, dim) pairs is flattened and strided, and the ragged tail is
// masked.  The loop runs over KV tiles up to kv_len[b] only; dead tail
// positions are never read.  K tiles are staged in shared memory with a
// padded row (D + 1 floats) so the per-key dot products are free of
// bank conflicts; loads are coalesced along D.
#include <cuda_runtime.h>
#include <cmath>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxAcc = 4;  // G * D <= kMaxAcc * kThreads
constexpr int kD = 64;      // head dim
constexpr int kTK = 64;     // keys per KV tile

template <int D, int TK>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int* __restrict__ kv_len,
                        float* __restrict__ out, int H, int Hkv, int T) {
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int G = H / Hkv;
  const int tid = threadIdx.x;
  extern __shared__ float smem[];
  float* q_s = smem;                    // G * D
  float* k_s = q_s + G * D;             // TK * (D + 1)
  float* v_s = k_s + TK * (D + 1);      // TK * D
  float* p_s = v_s + TK * D;            // G * TK
  float* m_s = p_s + G * TK;            // G running maxima
  float* l_s = m_s + G;                 // G running denominators
  float* a_s = l_s + G;                 // G rescale factors of this tile

  const float* qb = q + (static_cast<size_t>(b) * H + kvh * G) * D;
  const size_t kv_base = (static_cast<size_t>(b) * Hkv + kvh) * T * D;
  for (int i = tid; i < G * D; i += kThreads) q_s[i] = qb[i];
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = -INFINITY;
    l_s[g] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) acc[j] = 0.f;
  const int len = max(0, min(kv_len[b], T));
  const float inv_sqrt_d = 1.0f / sqrtf(static_cast<float>(D));
  __syncthreads();

  for (int t0 = 0; t0 < len; t0 += TK) {
    for (int i = tid; i < TK * D; i += kThreads) {
      const int t = i / D, d = i % D;
      const bool ok = t0 + t < len;
      const size_t off = kv_base + static_cast<size_t>(t0 + t) * D + d;
      k_s[t * (D + 1) + d] = ok ? __ldg(k + off) : 0.f;
      v_s[t * D + d] = ok ? __ldg(v + off) : 0.f;
    }
    __syncthreads();
    for (int i = tid; i < G * TK; i += kThreads) {
      const int g = i / TK, t = i % TK;
      float s = -INFINITY;
      if (t0 + t < len) {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot += q_s[g * D + d] * k_s[t * (D + 1) + d];
        s = dot * inv_sqrt_d;
      }
      p_s[i] = s;
    }
    __syncthreads();
    const int warp = tid / 32, lane = tid % 32;
    for (int g = warp; g < G; g += kWarps) {
      float mx = -INFINITY;
      for (int t = lane; t < TK; t += 32) mx = fmaxf(mx, p_s[g * TK + t]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_prev = m_s[g];
      const float m_new = fmaxf(m_prev, mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      float sum = 0.f;
      for (int t = lane; t < TK; t += 32) {
        const float p = t0 + t < len ? expf(p_s[g * TK + t] - m_safe) : 0.f;
        p_s[g * TK + t] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      if (lane == 0) {
        const float alpha = isfinite(m_prev) ? expf(m_prev - m_safe) : 0.f;
        l_s[g] = l_s[g] * alpha + sum;
        m_s[g] = m_new;
        a_s[g] = alpha;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kMaxAcc; ++j) {
      const int i = tid + j * kThreads;
      if (i < G * D) {
        const int g = i / D, d = i % D;
        float a = acc[j] * a_s[g];
        for (int t = 0; t < TK; ++t) a += p_s[g * TK + t] * v_s[t * D + d];
        acc[j] = a;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int j = 0; j < kMaxAcc; ++j) {
    const int i = tid + j * kThreads;
    if (i < G * D) {
      const int g = i / D, d = i % D;
      out[(static_cast<size_t>(b) * H + kvh * G + g) * D + d] =
          acc[j] / fmaxf(l_s[g], 1e-30f);
    }
  }
}

}  // namespace

int decode_attention_head_dim() { return kD; }
int decode_attention_max_group_dims() { return kMaxAcc * kThreads; }

void launch_decode_attention(const float* q, const float* k, const float* v,
                             const int* kv_len, float* out, int B, int H,
                             int Hkv, int T, cudaStream_t stream) {
  const int G = H / Hkv;
  const size_t smem =
      sizeof(float) * (G * kD + kTK * (kD + 1) + kTK * kD + G * kTK + 3 * G);
  auto kernel = decode_attention_kernel<kD, kTK>;
  if (smem > 48 * 1024) {
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
  }
  kernel<<<dim3(Hkv, B), kThreads, smem, stream>>>(q, k, v, kv_len, out, H,
                                                   Hkv, T);
}
