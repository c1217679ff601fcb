// decode_attention: one-query GQA attention over a KV cache for Hopper,
// each row's keys split over a thread-block cluster.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention/kernel.py:83 (`decode_attention` ->
// `pl.pallas_call` at :128, body `_kernel`), both of its branches: float32
// K/V, and int8 K/V with per-KV-vector float32 scales (kernel.py:53-55,
// the scale BlockSpecs at :122-127), one instance each of the template
// below (KV = float, int8_t).
//
//   q (B, H, D), k/v (B, Hkv, T, D), kv_len (B,) -> out (B, H, D)
//   out[b, h] = softmax_t(q[b,h] . k[b, h/G, t] / sqrt(D), t < kv_len[b])
//               @ v[b, h/G]
// where the int8 instance reads k[b, j, t] = k_int8[b, j, t] *
// k_scale[b, j, t] (and v likewise), scales (B, Hkv, T, 1): the scale is
// folded in after the dot product, s = (q . k_int8) * k_scale / sqrt(D),
// and into the weight, p * v_scale, before P V, so the result differs from
// dequantizing first only by float32 rounding.  HBM streams the int8
// leaves (TMA bulk copies of D-byte key rows, as the float32 instance's
// 4 D-byte rows) plus one float per key and leaf, never a dequantized
// copy.  The scales come as plain 4-byte loads, one per lane and tile: a
// (b, head) row of scales starts at ((b Hkv + h) T + t) * 4 bytes, which at
// the serve buffer (T = 370) is only 8-byte aligned for every other row,
// and a bulk copy needs 16.
// with the Pallas kernel's masked-row contract: `m_safe` pinned to 0 while
// the max is -inf and the denominator floored at 1e-30, so a row with
// kv_len == 0 comes out as zeros; keys past kv_len are never read.
// Compiled for the served head dims, D = 64 (smollm-360m) and D = 128
// (granite-8b), a template parameter beside G and KV; the binding rejects
// any other.  The two instances share one layout of a key's work: each
// lane takes 32 columns of one key, so a key spans D / 32 lanes (a
// half-warp at D = 64, a quarter-warp at D = 128) and a warp holds
// 32 / (D / 32) keys of a tile (16 and 8).  A 4-warp tile is then 64 keys
// at D = 64 and 32 at D = 128: the same 32 KB of float32 K and V per
// stage, so two stages (66 KB) still fit three blocks on an SM at either
// head dim (64-key tiles at D = 128 would take 128 KB for two stages,
// one block per SM, and the split plan could not keep the grid resident).
//
// What bounds it on the card: bytes.  One query per head does ~4 D flops
// per key against the 2 D * 4 bytes of K and V that its G heads share,
// under two flops per byte, so the time is the K/V stream:
// 2 * Hkv * sum(min(kv_len, T)) * D * 4 bytes (15-20 MB at smollm-360m's
// serve shape, 4.6-6 us at 3.35 TB/s; granite-8b's 8 KV heads of 128
// columns stream 3.2 times as much; the int8 instance 2 * Hkv * keys * (D + 4)
// bytes, about a quarter).  A stream that short needs the whole card
// pulling at once, so the design puts every SM's bytes in flight early:
//   * grid (splits, Hkv, B), launched as clusters of `splits` blocks
//     (cudaLaunchKernelEx with a cluster dimension).  Block i of a
//     cluster owns keys [i chunk, (i + 1) chunk) of one (b, KV head) row;
//     the wrapper's plan (`ops.py::decode_split_plan`) picks the most
//     splits, up to 8, whose whole grid is resident at once (a second
//     wave of blocks cost more than the extra splits gained: 2 splits,
//     320 blocks at the serve shape).  A block whose range starts at or
//     past kv_len loads nothing and leaves the neutral partial (m = -inf,
//     l = 0, acc = 0);
//   * one thread copies the block's live K and V keys, each one contiguous
//     run of keys * D * 4 bytes, with TMA bulk copies (cp.async.bulk)
//     that complete on an mbarrier; a range longer than one tile (64 keys
//     at D = 64, 32 at D = 128) streams through a two-stage ring (a full and an empty mbarrier per
//     stage), so the next tile loads while this one is used;
//   * each warp owns 16 (D = 64) or 8 (D = 128) keys of a tile and keeps
//     its own online softmax
//     for all G query heads of the group in registers (G is a template
//     parameter, so the state is sized to the group and a block of 128
//     threads fits seven to an SM), so each K/V byte is read from device
//     memory once for the group: the D / 32 lanes of a key split D for
//     the scores (float4 shared loads, the column order swizzled by key so
//     a quarter-warp touches 8 distinct bank groups), the lanes split D
//     for P V (D / 32 columns each).  No block barrier per tile: a warp
//     waits only for its tile to arrive;
//   * the warps' partials merge in the block (two barriers: the partials
//     reuse the K/V stages' shared memory), the blocks' through
//     distributed shared memory: each block writes its (m, l, acc) into
//     its slot of rank 0's shared memory (map_shared_rank), and after
//     one cluster barrier rank 0 merges them (M = max m_i, w_i =
//     exp(m_i - M) or 0 where m_i = -inf, out = sum w_i acc_i /
//     max(sum w_i l_i, 1e-30)).  The barrier's first phase, which only
//     says that rank 0 has started, is arrived at before the keys and
//     waited on after them, so one barrier blocks, and the peers exit
//     without waiting for rank 0 (rank 0 pulling the partials took a
//     second barrier and a remote read round trip: 5 % slower,
//     `tools/kernel_variants.py`).  No global scratch, no second kernel.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;                   // tiles in flight per block
constexpr int kMaxG = 8;                     // query heads per KV head
constexpr int kMaxSplits = 8;                // the portable cluster size

// The compiled head dims and the work layout each implies.
template <int D>
struct Dims {
  static_assert(D == 64 || D == 128, "compiled for head dims 64 and 128");
  static constexpr int kKeyLanes = D / 32;           // lanes per key
  static constexpr int kWarpKeys = 32 / kKeyLanes;   // keys of a tile/warp
  static constexpr int kTK = kWarps * kWarpKeys;     // keys per tile
  static constexpr int kCols = D / 32;               // P V columns per lane
  static constexpr int kPart = D + 2;                // one head's (m, l, acc)
};

// The dynamic shared memory, in floats: `stages` K/V tiles of `tk` keys
// each, of `kv_bytes` bytes an element (the warps' partials reuse them
// once every warp is done), q of the group, one partial per block of the
// cluster (written by the peers into rank 0's), then a full and an empty
// mbarrier per stage.
template <int D>
struct Layout {
  static constexpr int kPart = Dims<D>::kPart;
  int tk, stages, G, splits, kv_bytes;
  __host__ __device__ int q_off() const {
    const int kv = stages * 2 * tk * D * kv_bytes / 4,
              parts = kWarps * G * kPart;
    return kv > parts ? kv : parts;
  }
  __host__ __device__ int block_off() const { return q_off() + G * D; }
  __host__ __device__ int bar_off() const {
    return (block_off() + splits * G * kPart + 1) & ~1;
  }
  __host__ __device__ size_t bytes() const {
    return sizeof(float) * (bar_off() + 2 * 2 * stages);
  }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// `bytes` of global memory into this block's shared memory by the TMA
// unit, counted against `bar`'s transaction count.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Tile j of the block's `n` keys (K at `k`, V at `v`) into its stage.
template <int D, typename KV>
__device__ __forceinline__ void load_tile(float* smem, uint64_t* full,
                                          const KV* k, const KV* v,
                                          int j, int n, int tk, int stages) {
  const int s = j % stages;
  const uint32_t bytes = sizeof(KV) * D * min(tk, n - j * tk);
  KV* ks = reinterpret_cast<KV*>(smem) + s * 2 * tk * D;
  const size_t off = static_cast<size_t>(j) * tk * D;
  mbar_expect_tx(&full[s], 2 * bytes);
  bulk_load(ks, k + off, bytes, &full[s]);
  bulk_load(ks + tk * D, v + off, bytes, &full[s]);
}

// `kCols` columns of a V row (float or int8) as floats.
template <int N, typename KV>
__device__ __forceinline__ void load_cols(const KV* p, float (&x)[N]) {
  static_assert(N == 2 || N == 4, "2 or 4 columns per lane");
  if constexpr (std::is_same<KV, int8_t>::value) {
    if constexpr (N == 2) {
      const char2 c = *reinterpret_cast<const char2*>(p);
      x[0] = c.x;
      x[1] = c.y;
    } else {
      const char4 c = *reinterpret_cast<const char4*>(p);
      x[0] = c.x;
      x[1] = c.y;
      x[2] = c.z;
      x[3] = c.w;
    }
  } else {
    if constexpr (N == 2) {
      const float2 f = *reinterpret_cast<const float2*>(p);
      x[0] = f.x;
      x[1] = f.y;
    } else {
      const float4 f = *reinterpret_cast<const float4*>(p);
      x[0] = f.x;
      x[1] = f.y;
      x[2] = f.z;
      x[3] = f.w;
    }
  }
}

// D, the head dim, and G, the query heads of a KV head, are template
// parameters so that the per-head softmax state and accumulators stay in
// registers sized to them.  The blocks per SM that the register budget
// must allow: at D = 64 up to four heads fit seven (72 registers; a cap
// of 64 for eight spilled at G = 3), as many as a 47-key single stage's
// shared memory allows; D = 128 holds twice the P V accumulators, and its
// two stages fit three blocks per SM, so a cap of 128 registers (four
// blocks) leaves them room (`ops.py::decode_split_plan` counts blocks per
// SM with the same numbers).  KV is the K/V element type: float, or
// int8_t with `k_scale`/`v_scale` (one float per key; unused by the float
// instance).
template <int D, int G, typename KV>
__global__ void __launch_bounds__(kThreads, D == 64 ? (G <= 4 ? 7 : 4) : 4)
decode_attention_kernel(const float* __restrict__ q,
                        const KV* __restrict__ k,
                        const KV* __restrict__ v,
                        const float* __restrict__ k_scale,
                        const float* __restrict__ v_scale,
                        const int* __restrict__ kv_len,
                        float* __restrict__ out, int H, int Hkv, int T,
                        int chunk, int tk, int stages) {
  constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  constexpr int kD = D;
  constexpr int kWarpKeys = Dims<D>::kWarpKeys;
  constexpr int kCols = Dims<D>::kCols;
  constexpr int kPart = Dims<D>::kPart;
  // 1 / sqrt(D).
  constexpr float kScale = D == 64 ? 0.125f : 0.08838834764831845f;
  cg::cluster_group cluster = cg::this_cluster();
  // The first barrier phase only says that every block of the cluster
  // has started (rank 0's shared memory exists): arrive now, wait once
  // the keys are done, when it has long completed.
  cluster_arrive_relaxed();
  const int split = blockIdx.x;  // the block's rank in its cluster
  const int splits = gridDim.x;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  extern __shared__ __align__(16) float smem[];
  const Layout<D> lay{tk, stages, G, splits, static_cast<int>(sizeof(KV))};
  float* q_s = smem + lay.q_off();
  float* wpart = smem;
  float* bpart = smem + lay.block_off();
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar_off());
  uint64_t* empty = full + stages;

  // This block's live keys: [k0, k0 + n) of the row.
  const int len = max(0, min(kv_len[b], T));
  const long long first = static_cast<long long>(split) * chunk;
  const int k0 = first < len ? static_cast<int>(first) : len;
  const int n = min(chunk, len - k0);
  const int n_tiles = (n + tk - 1) / tk;
  const size_t s_base = (static_cast<size_t>(b) * Hkv + kvh) * T + k0;
  const size_t kv_base = s_base * kD;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int j = 0; j < min(stages, n_tiles); ++j) {
      load_tile<D>(smem, full, k + kv_base, v + kv_base, j, n, tk, stages);
    }
  }
  const float4* qb = reinterpret_cast<const float4*>(
      q + (static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G) * kD);
  for (int i = tid; i < G * kD / 4; i += kThreads) {
    reinterpret_cast<float4*>(q_s)[i] = __ldg(qb + i);
  }
  __syncthreads();

  float m[G], l[G], acc[G][kCols];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[g][c] = 0.f;
  }
  // Lane (t, part) takes key t of the warp's keys, columns [32 part,
  // 32 part + 32) for the scores.
  const int t = lane % kWarpKeys, part = lane / kWarpKeys;
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % stages;
    const uint32_t parity = (j / stages) & 1;
    const int w0 = warp * kWarpKeys;
    const int nw = min(kWarpKeys, min(tk, n - j * tk) - w0);
    const bool valid = t < nw;
    // The int8 instance's scales of key w0 + t, loaded while the tile is
    // in flight (score multiplier with 1 / sqrt(D) folded in, and the
    // weight's multiplier for P V).
    float kmul = kScale;
    [[maybe_unused]] float vmul = 1.f;
    if constexpr (kQuant) {
      if (valid) {
        const size_t si = s_base + static_cast<size_t>(j) * tk + w0 + t;
        kmul = __ldg(k_scale + si) * kScale;
        vmul = __ldg(v_scale + si);
      }
    }
    mbar_wait(&full[s], parity);
    const KV* ks = reinterpret_cast<const KV*>(smem) + s * 2 * tk * kD;
    const KV* vs = ks + tk * kD;
    if (nw > 0) {
      // Scores: lane (t, part) takes key w0 + t over columns
      // [32 part, 32 part + 32), 4 by 4 in swizzled order.
      const KV* krow = ks + (w0 + (valid ? t : 0)) * kD + 32 * part;
      const float* qh = q_s + 32 * part;
      float sc[G];
#pragma unroll
      for (int g = 0; g < G; ++g) sc[g] = 0.f;
#pragma unroll
      for (int c4 = 0; c4 < 8; ++c4) {
        const int c = 4 * (c4 ^ (t & 7));
        float4 kk;
        if constexpr (kQuant) {
          const char4 k8 = *reinterpret_cast<const char4*>(krow + c);
          kk = make_float4(k8.x, k8.y, k8.z, k8.w);
        } else {
          kk = *reinterpret_cast<const float4*>(krow + c);
        }
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float4 qq = *reinterpret_cast<const float4*>(qh + g * kD + c);
          sc[g] = fmaf(qq.x, kk.x, sc[g]);
          sc[g] = fmaf(qq.y, kk.y, sc[g]);
          sc[g] = fmaf(qq.z, kk.z, sc[g]);
          sc[g] = fmaf(qq.w, kk.w, sc[g]);
        }
      }
      // The online softmax of the warp's keys, per head: the lanes
      // t + kWarpKeys i hold the same key once the parts are summed.
      float p[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        // Every lane shuffles (a full-mask shuffle skipped by some lanes
        // is undefined), then the lanes past the warp's keys drop out as
        // -inf.
        float dot = sc[g];
#pragma unroll
        for (int off = kWarpKeys; off < 32; off <<= 1) {
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        }
        const float sg = valid ? dot * kmul : -INFINITY;
        float mx = sg;
#pragma unroll
        for (int off = kWarpKeys / 2; off > 0; off >>= 1) {
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        }
        const float m_new = fmaxf(m[g], mx);
        const float m_safe = isfinite(m_new) ? m_new : 0.f;
        const float alpha = isfinite(m[g]) ? expf(m[g] - m_safe) : 0.f;
        p[g] = valid ? expf(sg - m_safe) : 0.f;
        float sum = p[g];
#pragma unroll
        for (int off = kWarpKeys / 2; off > 0; off >>= 1) {
          sum += __shfl_xor_sync(0xffffffffu, sum, off);
        }
        l[g] = l[g] * alpha + sum;
        m[g] = m_new;
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[g][c] *= alpha;
        if constexpr (kQuant) p[g] *= vmul;
      }
      // P V: lane owns columns kCols lane .. kCols lane + kCols - 1; key
      // i's weight comes from lane i.
      const KV* vcol = vs + w0 * kD + kCols * lane;
#pragma unroll 4
      for (int i = 0; i < nw; ++i) {
        float vv[kCols];
        load_cols<kCols>(vcol + i * kD, vv);
#pragma unroll
        for (int g = 0; g < G; ++g) {
          const float pg = __shfl_sync(0xffffffffu, p[g], i);
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[g][c] = fmaf(pg, vv[c], acc[g][c]);
        }
      }
    }
    // The stage is free once every warp is done with it; thread 0 then
    // refills it with tile j + stages.
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (tid == 0 && j + stages < n_tiles) {
      mbar_wait(&empty[s], parity);
      load_tile<D>(smem, full, k + kv_base, v + kv_base, j + stages, n, tk,
                   stages);
    }
  }

  // The warps' partials (over the K/V stages, once every warp is done
  // with them), then the block's.
  __syncthreads();
  float* wp = wpart + warp * G * kPart;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      wp[g * kPart] = m[g];
      wp[g * kPart + 1] = l[g];
    }
    // 8-byte aligned: kPart, 2 and kCols are even.
#pragma unroll
    for (int c = 0; c < kCols; c += 2) {
      *reinterpret_cast<float2*>(wp + g * kPart + 2 + kCols * lane + c) =
          make_float2(acc[g][c], acc[g][c + 1]);
    }
  }
  __syncthreads();
  // The block's partial goes straight into its slot of rank 0's shared
  // memory.
  cluster_wait();
  float* rpart = cluster.map_shared_rank(bpart, 0) + split * G * kPart;
  for (int i = tid; i < G * kD; i += kThreads) {
    const int g = i / kD, d = i % kD;
    float mw[kWarps];
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      mw[w] = wpart[(w * G + g) * kPart];
      mx = fmaxf(mx, mw[w]);
    }
    const float m_safe = isfinite(mx) ? mx : 0.f;
    float ls = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float sw = isfinite(mw[w]) ? expf(mw[w] - m_safe) : 0.f;
      ls = fmaf(sw, wpart[(w * G + g) * kPart + 1], ls);
      a = fmaf(sw, wpart[(w * G + g) * kPart + 2 + d], a);
    }
    rpart[g * kPart + 2 + d] = a;
    if (d == 0) {
      rpart[g * kPart] = mx;
      rpart[g * kPart + 1] = ls;
    }
  }

  // Once the partials are published rank 0 merges them from its own
  // shared memory; the peers exit without waiting for it.
  cluster_arrive();
  cluster_wait();
  if (split == 0) {
    for (int i = tid; i < G * kD; i += kThreads) {
      const int g = i / kD, d = i % kD;
      float mr[kMaxSplits], lr[kMaxSplits], ar[kMaxSplits];
      float mx = -INFINITY;
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) {
        mr[r] = -INFINITY;
        lr[r] = ar[r] = 0.f;
        if (r < splits) {
          const float* pr = bpart + (r * G + g) * kPart;
          mr[r] = pr[0];
          lr[r] = pr[1];
          ar[r] = pr[2 + d];
        }
        mx = fmaxf(mx, mr[r]);
      }
      const float m_safe = isfinite(mx) ? mx : 0.f;
      float den = 0.f, num = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxSplits; ++r) {
        const float sr = isfinite(mr[r]) ? expf(mr[r] - m_safe) : 0.f;
        den = fmaf(sr, lr[r], den);
        num = fmaf(sr, ar[r], num);
      }
      out[(static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G + g) *
              kD + d] = num / fmaxf(den, 1e-30f);
    }
  }
}

}  // namespace

bool decode_attention_has_head_dim(int d) { return d == 64 || d == 128; }
int decode_attention_max_group() { return kMaxG; }
int decode_attention_max_splits() { return kMaxSplits; }

namespace {

template <int D, typename KV>
cudaError_t launch(const float* q, const KV* k, const KV* v,
                   const float* k_scale, const float* v_scale,
                   const int* kv_len, float* out, int B, int H, int Hkv,
                   int T, int splits, int chunk, cudaStream_t stream) {
  using Kernel = void (*)(const float*, const KV*, const KV*, const float*,
                          const float*, const int*, float*, int, int, int,
                          int, int, int);
  constexpr Kernel kKernels[kMaxG] = {
      decode_attention_kernel<D, 1, KV>, decode_attention_kernel<D, 2, KV>,
      decode_attention_kernel<D, 3, KV>, decode_attention_kernel<D, 4, KV>,
      decode_attention_kernel<D, 5, KV>, decode_attention_kernel<D, 6, KV>,
      decode_attention_kernel<D, 7, KV>, decode_attention_kernel<D, 8, KV>};
  constexpr int kvb = static_cast<int>(sizeof(KV));
  constexpr int kTK = Dims<D>::kTK;
  const int G = H / Hkv;
  if (G < 1 || G > kMaxG) return cudaErrorInvalidValue;
  const Kernel kernel = kKernels[G - 1];
  // The dynamic shared memory above 48 KB is granted once per device,
  // head dim, element type and group size.
  constexpr int kMaxDevices = 64;
  static bool granted[kMaxDevices][kMaxG] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices || !granted[device][G - 1]) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(
            Layout<D>{kTK, kStages, G, kMaxSplits, kvb}.bytes()));
    if (err != cudaSuccess) return err;
    if (device < kMaxDevices) granted[device][G - 1] = true;
  }
  // A range of one tile or less is one stage, sized to the range.
  const int tk = chunk < kTK ? chunk : kTK;
  const int stages = chunk > tk ? kStages : 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, Hkv, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = Layout<D>{tk, stages, G, splits, kvb}.bytes();
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, q, k, v, k_scale, v_scale, kv_len,
                            out, H, Hkv, T, chunk, tk, stages);
}

template <typename KV>
cudaError_t launch_d(const float* q, const KV* k, const KV* v,
                     const float* k_scale, const float* v_scale,
                     const int* kv_len, float* out, int B, int H, int Hkv,
                     int T, int D, int splits, int chunk,
                     cudaStream_t stream) {
  if (D == 64) {
    return launch<64, KV>(q, k, v, k_scale, v_scale, kv_len, out, B, H, Hkv,
                          T, splits, chunk, stream);
  }
  if (D == 128) {
    return launch<128, KV>(q, k, v, k_scale, v_scale, kv_len, out, B, H,
                           Hkv, T, splits, chunk, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

cudaError_t launch_decode_attention(const float* q, const float* k,
                                    const float* v, const int* kv_len,
                                    float* out, int B, int H, int Hkv, int T,
                                    int D, int splits, int chunk,
                                    cudaStream_t stream) {
  return launch_d<float>(q, k, v, nullptr, nullptr, kv_len, out, B, H, Hkv,
                         T, D, splits, chunk, stream);
}

cudaError_t launch_decode_attention_int8(const float* q, const int8_t* k,
                                         const int8_t* v,
                                         const float* k_scale,
                                         const float* v_scale,
                                         const int* kv_len, float* out, int B,
                                         int H, int Hkv, int T, int D,
                                         int splits, int chunk,
                                         cudaStream_t stream) {
  return launch_d<int8_t>(q, k, v, k_scale, v_scale, kv_len, out, B, H, Hkv,
                          T, D, splits, chunk, stream);
}
