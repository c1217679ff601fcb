// flash_attention: causal / sliding-window prefill attention with per-row
// arena offsets, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (`flash_attention` -> `pl.pallas_call` with body `_kernel`), both of its
// branches: float32 K/V, and int8 K/V with per-KV-vector float32 scales
// (kernel.py:60-62, the scale BlockSpecs at :165-172), one instance each
// of the template below (KV = float, int8_t).
//
//   q (B, H, S, D), k/v (B, Hkv, T, D), q_offset/kv_len (B,) -> (B, H, S, D)
// Query row s of batch row b sits at position q_offset[b] + s and attends
// key t iff  t < T  and  t < kv_len[b]  and  t <= q_pos  and
// (window > 0: t > q_pos - window) -- the masks of kernel.py:69-76 (the
// serving path's prefill is always causal).  Compiled for the served
// head dims, D = 64 (smollm-360m) and D = 128 (granite-8b), a template
// parameter beside KV; the binding rejects any other.  The
// masked-row contract is ref.py::masked_softmax: the online softmax pins
// m_safe to 0 while a row's running max is -inf and floors the
// denominator at 1e-30, so a fully masked row (bucket padding,
// kv_len == 0) comes out as zeros.
//
// What bounds it on the card: at the admission shapes (S up to 256
// queries against up to a few hundred keys, D = 64) the work is
// ~4*S*T*D flops per head against (S + 2T)*D*4 bytes, tens of flops per
// byte, so float32 FMAs bound it (the serving path keeps float32
// "highest" precision, which rules out TF32 tensor cores).  The design
// keeps the FMA pipes, not shared memory, the limit:
//   * a warp group of 2 kBQ threads owns kBQ (64) query rows of one head;
//     thread (tr, tc) holds the scores of rows tr + kBQ/8 r (r < 8)
//     against keys tc + 16 n (n < 4) of a 64-key tile, built from float4
//     shared loads, 12 per 128 FMAs; the two half-warps of a warp read
//     neighbouring rows of Q, in different banks;
//   * the online softmax runs in the log2 domain (Q is staged times
//     log2(e) / sqrt(D); ex2.approx.ftz maps a masked -inf score to an
//     exact 0); a row's max is reduced across its 16 threads with
//     shuffles, its sum stays per thread (every thread of a row rescales
//     by the same factor) and is reduced once at the end;
//   * P goes once to shared memory, transposed, in rows the warp itself
//     owns (a warp barrier, not a block one), and P V is a register-
//     tiled product into an 8 x 4 output tile per thread, 3 loads per
//     32 FMAs;
//   * the K/V tiles are double-buffered with cp.async 16-byte copies
//     (keys past T zero-filled), one block barrier per tile;
//   * one block serves up to three query heads of one KV head (GQA), one
//     warp group each, so a K/V tile is staged once for all of them:
//     168 KB of shared memory, 384 threads, one block per SM.
// At D = 128 the same layout would not fit: two 64-key K/V stages take
// 133 KB and each head's Q and P^T 51 KB, 235 KB for two heads against
// the SM's 227 KB, and a thread's 8 x 8 output tile beside its 32 scores
// would spill under the 168-register cap of 384 threads.  The D = 128
// instance keeps the thread layout and halves the key tile instead:
// 32-key tiles (thread (tr, tc) scores keys tc and tc + 16), an 8 x 8
// output tile per thread (columns 4 tc .. 4 tc + 3 and 64 + 4 tc ..
// 64 + 4 tc + 3, so a half-warp still reads a V row's 256 contiguous
// bytes per float4), and up to two query heads per block: 67 KB of K/V
// stages plus 42 KB of Q and P^T per head, 152 KB and 256 threads (a
// cap of 255 registers; ptxas gives 192, no spill) for granite's group
// of 4 in two blocks.  Two heads
// rather than one, so that each K/V tile is staged twice per KV head,
// not four times; the same 8 warps per SM either way.
// The int8 instance (scales k_scale/v_scale (B, Hkv, T, 1)) stages each
// tile's int8 K and V rows (16-byte cp.async copies of the D-byte rows)
// and its scales (4-byte cp.async copies: a scale row starts only 4-byte
// aligned) in two stages, zero-filled past T, and dequantizes the tile in
// shared memory into ONE float32 K/V tile (k_int8 * k_scale, the plain
// version's product exactly), behind a second block barrier; from there it
// runs the float32 body unchanged.  HBM streams int8 plus one float per
// key and leaf; the function stays bound by operations, so its time is
// near the float32 instance's.
// The KV loop is clipped to the tiles the block's masks can reach: it
// ends at min(kv_len, last causal position of the block) and starts at
// the window's lower edge; a tile inside every row's mask skips the
// mask test.  The q tile is the slowest grid dimension, last tile first,
// so the blocks with the longest KV ranges launch first and the short
// ones fill the tail.
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

// The tile of a head dim: keys per K/V tile, query heads per block.
template <int D>
struct Tile;
template <>
struct Tile<64> {
  static constexpr int kBK = 64;
  static constexpr int kMaxHeads = 3;
};
template <>
struct Tile<128> {
  static constexpr int kBK = 32;
  static constexpr int kMaxHeads = 2;
};

constexpr int kBQ = 64;                 // query rows per warp group
constexpr int kRowStep = kBQ / 8;       // thread row r is row tr + kRowStep r
constexpr int kGroup = 2 * kBQ;         // threads per warp group
constexpr int kPP = kBQ + 4;            // padded row of P^T
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory, in floats: the float32 K/V stages (two for the float32
// instance, one for the int8 instance), the int8 instance's two raw stages
// (K and V rows, then their scales), then Q and P^T per group.
template <int D, typename KV>
struct Smem {
  static constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  static constexpr int kBK = Tile<D>::kBK;             // keys per KV tile
  static constexpr int kKN = kBK / 16;                 // keys of a tile/thread
  static constexpr int kOC = D / 16;                   // output columns/thread
  static constexpr int kMaxHeads = Tile<D>::kMaxHeads;  // query heads/block
  static constexpr int kDP = D + 4;                    // padded row of Q, K
  // 1 / sqrt(D) times log2(e): scores live in the log2 domain.
  static constexpr float kScaleLog2 =
      (D == 64 ? 0.125f : 0.08838834764831845f) * kLog2e;
  static constexpr int kKStage = kBK * kDP;
  static constexpr int kVStage = kBK * D;
  static constexpr int kGroupFloats = kBQ * kDP + kBK * kPP;
  static constexpr int kRawKV = kBK * D / 4;         // one int8 K (or V) tile
  static constexpr int kRawStage = 2 * kRawKV + 2 * kBK;  // K, V, scales
  static constexpr int kStagesF = kQuant ? 1 : 2;
  static constexpr int kOffV = kStagesF * kKStage;
  static constexpr int kOffRaw = kOffV + kStagesF * kVStage;
  static constexpr int kOffGroups = kOffRaw + (kQuant ? 2 * kRawStage : 0);
  static constexpr size_t bytes(int heads) {
    return (kOffGroups + heads * kGroupFloats) * sizeof(float);
  }
};

__device__ __forceinline__ void cp_async16_zfill(void* smem_dst,
                                                 const void* gmem_src,
                                                 bool valid) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  const int src_bytes = valid ? 16 : 0;  // 0: fill the 16 bytes with zeros
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(gmem_src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4_zfill(float* smem_dst,
                                                const float* gmem_src,
                                                bool valid) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem_dst));
  const int src_bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(gmem_src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 2^x, flushing subnormal results to 0; 2^-inf = 0, so a masked score
// (-inf) needs no test.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One K/V tile (keys k0 .. k0 + kBK - 1) into a stage, by every thread of
// the block.
template <int D>
__device__ __forceinline__ void load_kv(float* ks, float* vs,
                                        const float* __restrict__ k,
                                        const float* __restrict__ v,
                                        size_t kv_base, int k0, int T) {
  using L = Smem<D, float>;
  constexpr int kD = D, kBK = L::kBK, kDP = L::kDP;
  for (int e = threadIdx.x; e < kBK * kD / 4; e += blockDim.x) {
    const int r = e / (kD / 4), d4 = e % (kD / 4);
    const int kk = k0 + r;
    const bool ok = kk < T;
    const size_t off = kv_base + static_cast<size_t>(ok ? kk : 0) * kD + 4 * d4;
    cp_async16_zfill(ks + r * kDP + 4 * d4, k + off, ok);
    cp_async16_zfill(vs + r * kD + 4 * d4, v + off, ok);
  }
  cp_async_commit();
}

// One int8 K/V tile (keys k0 .. k0 + kBK - 1) and its scales into a raw
// stage, by every thread of the block; rows past T are zeros.
template <int D>
__device__ __forceinline__ void load_kv(float* raw,
                                        const int8_t* __restrict__ k,
                                        const int8_t* __restrict__ v,
                                        const float* __restrict__ k_scale,
                                        const float* __restrict__ v_scale,
                                        size_t kv_base, int k0, int T) {
  using L = Smem<D, int8_t>;
  constexpr int kD = D, kBK = L::kBK, kRawKV = L::kRawKV;
  int8_t* ks = reinterpret_cast<int8_t*>(raw);
  int8_t* vs = reinterpret_cast<int8_t*>(raw + kRawKV);
  for (int e = threadIdx.x; e < kBK * kD / 16; e += blockDim.x) {
    const int r = e / (kD / 16), c = e % (kD / 16);
    const int kk = k0 + r;
    const bool ok = kk < T;
    const size_t off =
        kv_base + static_cast<size_t>(ok ? kk : 0) * kD + 16 * c;
    cp_async16_zfill(ks + r * kD + 16 * c, k + off, ok);
    cp_async16_zfill(vs + r * kD + 16 * c, v + off, ok);
  }
  const size_t s_base = kv_base / kD;
  for (int r = threadIdx.x; r < kBK; r += blockDim.x) {
    const int kk = k0 + r;
    const bool ok = kk < T;
    const size_t off = s_base + (ok ? kk : 0);
    cp_async4_zfill(raw + 2 * kRawKV + r, k_scale + off, ok);
    cp_async4_zfill(raw + 2 * kRawKV + kBK + r, v_scale + off, ok);
  }
  cp_async_commit();
}

// A raw int8 stage into the float32 K (padded rows) and V tiles:
// k_int8 * k_scale, v_int8 * v_scale.
template <int D>
__device__ __forceinline__ void dequantize_kv(float* ks, float* vs,
                                              const float* raw) {
  using L = Smem<D, int8_t>;
  constexpr int kD = D, kBK = L::kBK, kDP = L::kDP, kRawKV = L::kRawKV;
  const char4* k8 = reinterpret_cast<const char4*>(raw);
  const char4* v8 = reinterpret_cast<const char4*>(raw + kRawKV);
  const float* sk = raw + 2 * kRawKV;
  const float* sv = sk + kBK;
  for (int e = threadIdx.x; e < kBK * kD / 4; e += blockDim.x) {
    const int r = e / (kD / 4), d4 = e % (kD / 4);
    const char4 a = k8[e], b = v8[e];
    const float ka = sk[r], va = sv[r];
    *reinterpret_cast<float4*>(ks + r * kDP + 4 * d4) =
        make_float4(a.x * ka, a.y * ka, a.z * ka, a.w * ka);
    *reinterpret_cast<float4*>(vs + r * kD + 4 * d4) =
        make_float4(b.x * va, b.y * va, b.z * va, b.w * va);
  }
}

// D is the head dim; KV is the K/V element type: float, or int8_t with
// `k_scale`/`v_scale` (one float per key; unused by the float instance).
template <int D, typename KV>
__global__ void __launch_bounds__(kGroup * Tile<D>::kMaxHeads, 1)
flash_attention_kernel(const float* __restrict__ q,
                       const KV* __restrict__ k,
                       const KV* __restrict__ v,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ q_offset,
                       const int* __restrict__ kv_len,
                       float* __restrict__ out, int H, int Hkv, int S, int T,
                       int window, int heads) {
  using L = Smem<D, KV>;
  constexpr int kD = D, kBK = L::kBK, kKN = L::kKN, kOC = L::kOC,
                kDP = L::kDP, kKStage = L::kKStage, kVStage = L::kVStage,
                kOffV = L::kOffV;
  constexpr float kScaleLog2 = L::kScaleLog2;
  extern __shared__ __align__(16) float smem[];
  const int g = threadIdx.x / kGroup, t = threadIdx.x % kGroup;
  const int tr = t / 16, tc = t % 16;
  const int iq = gridDim.z - 1 - blockIdx.z;  // the longest KV ranges first
  const int b = blockIdx.y;
  const int h = blockIdx.x * heads + g;
  const int kvh = h / (H / Hkv);              // the same for every group
  const int row0 = iq * kBQ;
  const int qoff = q_offset[b];
  const int klen = min(kv_len[b], T);
  float* Qs = smem + L::kOffGroups + g * L::kGroupFloats;
  float* Pt = Qs + kBQ * kDP;

  const size_t q_base = (static_cast<size_t>(b) * H + h) * S * kD;
  const size_t kv_base = (static_cast<size_t>(b) * Hkv + kvh) * T * kD;

  const int kend = min(klen, qoff + min(row0 + kBQ, S));
  int kbeg = 0;
  if (window > 0) kbeg = max(0, qoff + row0 - window + 1);
  kbeg = (kbeg / kBK) * kBK;
  const int n_tiles = kend > kbeg ? (kend - kbeg + kBK - 1) / kBK : 0;
  if (n_tiles > 0) {
    if constexpr (L::kQuant) {
      load_kv<D>(smem + L::kOffRaw, k, v, k_scale, v_scale, kv_base, kbeg,
                 T);
    } else {
      load_kv<D>(smem, smem + kOffV, k, v, kv_base, kbeg, T);
    }
  }

  // This group's Q tile times kScaleLog2; rows past S are zeros (their
  // outputs are not stored).
  for (int e = t; e < kBQ * kD / 4; e += kGroup) {
    const int r = e / (kD / 4), d4 = e % (kD / 4);
    const int s = row0 + r;
    float4 qv = make_float4(0.f, 0.f, 0.f, 0.f);
    if (s < S) {
      qv = __ldg(reinterpret_cast<const float4*>(
                     q + q_base + static_cast<size_t>(s) * kD) + d4);
      qv.x *= kScaleLog2;
      qv.y *= kScaleLog2;
      qv.z *= kScaleLog2;
      qv.w *= kScaleLog2;
    }
    *reinterpret_cast<float4*>(Qs + r * kDP + 4 * d4) = qv;
  }

  float o[8][kOC] = {};
  float m[8], l[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  // Thread row r is row tr + kRowStep r of the tile: the two half-warps
  // read neighbouring rows of Q, in different banks.
  const int qpos0 = qoff + row0 + tr;

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    cp_async_wait_all();
    // Tile `it` (and the Q tiles) visible to all, and every warp done with
    // tile it - 1, whose stage the next copy overwrites.
    __syncthreads();
    const int k0 = kbeg + it * kBK;
    const float* ks;
    const float* vs;
    if constexpr (L::kQuant) {
      // The raw stage of tile it + 1 was last read while dequantizing
      // tile it - 1, before that tile's second barrier.
      if (it + 1 < n_tiles) {
        load_kv<D>(smem + L::kOffRaw + (stage ^ 1) * L::kRawStage, k, v,
                   k_scale, v_scale, kv_base, k0 + kBK, T);
      }
      dequantize_kv<D>(smem, smem + L::kOffV,
                       smem + L::kOffRaw + stage * L::kRawStage);
      __syncthreads();
      ks = smem;
      vs = smem + L::kOffV;
    } else {
      if (it + 1 < n_tiles) {
        load_kv<D>(smem + (stage ^ 1) * kKStage,
                   smem + kOffV + (stage ^ 1) * kVStage, k, v, kv_base,
                   k0 + kBK, T);
      }
      ks = smem + stage * kKStage;
      vs = smem + kOffV + stage * kVStage;
    }

    // Scores: rows tr + kRowStep r, keys tc + 16 n.
    float sc[8][kKN] = {};
#pragma unroll
    for (int d = 0; d < kD; d += 4) {
      float4 kv4[kKN];
#pragma unroll
      for (int n = 0; n < kKN; ++n) {
        kv4[n] = *reinterpret_cast<const float4*>(ks + (tc + 16 * n) * kDP + d);
      }
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const float4 qv = *reinterpret_cast<const float4*>(
            Qs + (tr + kRowStep * r) * kDP + d);
#pragma unroll
        for (int n = 0; n < kKN; ++n) {
          sc[r][n] = fmaf(qv.x, kv4[n].x, sc[r][n]);
          sc[r][n] = fmaf(qv.y, kv4[n].y, sc[r][n]);
          sc[r][n] = fmaf(qv.z, kv4[n].z, sc[r][n]);
          sc[r][n] = fmaf(qv.w, kv4[n].w, sc[r][n]);
        }
      }
    }

    // A tile inside every row's mask skips the test (block-uniform).
    const bool full = k0 + kBK <= klen && k0 + kBK - 1 <= qoff + row0 &&
                      (window <= 0 || k0 > qoff + row0 + kBQ - 1 - window);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int qpos = qpos0 + kRowStep * r;
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < kKN; ++n) {
        float s = sc[r][n];
        if (!full) {
          const int kk = k0 + tc + 16 * n;
          const bool ok = kk < klen && kk <= qpos &&
                          (window <= 0 || kk > qpos - window);
          if (!ok) s = -INFINITY;
        }
        sc[r][n] = s;
        mx = fmaxf(mx, s);
      }
      // The 16 threads of a row are the lanes of one half-warp.
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
      const float m_new = fmaxf(m[r], mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float alpha = exp2_ftz(m[r] - m_safe);  // 0 while m is -inf
      float psum = 0.f;
#pragma unroll
      for (int n = 0; n < kKN; ++n) {
        const float p = exp2_ftz(sc[r][n] - m_safe);  // masked: exactly 0
        sc[r][n] = p;
        psum += p;
      }
      l[r] = l[r] * alpha + psum;
      m[r] = m_new;
#pragma unroll
      for (int c = 0; c < kOC; ++c) o[r][c] *= alpha;
    }

    // P^T (key, 8 tr + r) in the rows this warp owns.
#pragma unroll
    for (int n = 0; n < kKN; ++n) {
      float* pt = Pt + (tc + 16 * n) * kPP + 8 * tr;
      *reinterpret_cast<float4*>(pt) =
          make_float4(sc[0][n], sc[1][n], sc[2][n], sc[3][n]);
      *reinterpret_cast<float4*>(pt + 4) =
          make_float4(sc[4][n], sc[5][n], sc[6][n], sc[7][n]);
    }
    __syncwarp();

    // O += P V: rows tr + kRowStep r, columns 64 j + 4 tc .. 64 j + 4 tc
    // + 3 for j < kOC / 4.
#pragma unroll 16
    for (int key = 0; key < kBK; ++key) {
      const float4 p0 = *reinterpret_cast<const float4*>(Pt + key * kPP + 8 * tr);
      const float4 p1 = *reinterpret_cast<const float4*>(Pt + key * kPP + 8 * tr + 4);
      const float pr[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
      for (int j = 0; j < kOC / 4; ++j) {
        const float4 vv = *reinterpret_cast<const float4*>(
            vs + key * kD + 64 * j + 4 * tc);
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          o[r][4 * j] = fmaf(pr[r], vv.x, o[r][4 * j]);
          o[r][4 * j + 1] = fmaf(pr[r], vv.y, o[r][4 * j + 1]);
          o[r][4 * j + 2] = fmaf(pr[r], vv.z, o[r][4 * j + 2]);
          o[r][4 * j + 3] = fmaf(pr[r], vv.w, o[r][4 * j + 3]);
        }
      }
    }
    __syncwarp();  // P^T is rewritten by the next tile
  }

  // Row sums across the row's 16 threads, then the normalised rows.
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    float lt = l[r];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    lt += __shfl_xor_sync(0xffffffffu, lt, 4);
    lt += __shfl_xor_sync(0xffffffffu, lt, 8);
    const int s = row0 + tr + kRowStep * r;
    if (s < S) {
      const float denom = fmaxf(lt, 1e-30f);
#pragma unroll
      for (int j = 0; j < kOC / 4; ++j) {
        *reinterpret_cast<float4*>(out + q_base +
                                   static_cast<size_t>(s) * kD + 64 * j +
                                   4 * tc) =
            make_float4(o[r][4 * j] / denom, o[r][4 * j + 1] / denom,
                        o[r][4 * j + 2] / denom, o[r][4 * j + 3] / denom);
      }
    }
  }
}

}  // namespace

bool flash_attention_has_head_dim(int d) { return d == 64 || d == 128; }

namespace {

template <int D, typename KV>
cudaError_t launch(const float* q, const KV* k, const KV* v,
                   const float* k_scale, const float* v_scale,
                   const int* q_offset, const int* kv_len, float* out, int B,
                   int H, int Hkv, int S, int T, int window,
                   cudaStream_t stream) {
  using L = Smem<D, KV>;
  static_assert(kBQ % 32 == 0 && L::kBK % 16 == 0 && D == 64 * (L::kOC / 4),
                "thread (tr, tc): 8 rows, kKN keys, kOC output columns");
  static_assert(L::bytes(L::kMaxHeads) <= 232448, "one block fits on an SM");
  static_assert(L::kDP % 4 == 0 && kPP % 4 == 0 && L::kGroupFloats % 4 == 0 &&
                L::kOffRaw % 4 == 0 && L::kRawStage % 4 == 0 &&
                L::kOffV % 4 == 0, "float4 alignment");
  // The dynamic shared memory above 48 KB is granted once per device,
  // head dim and element type.
  constexpr int kMaxDevices = 64;
  static bool granted[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices || !granted[device]) {
    err = cudaFuncSetAttribute(flash_attention_kernel<D, KV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(L::bytes(L::kMaxHeads)));
    if (err != cudaSuccess) return err;
    if (device < kMaxDevices) granted[device] = true;
  }
  // The most query heads of one KV head (a divisor of H / Hkv) per block.
  const int G = H / Hkv;
  int heads = L::kMaxHeads;
  while (G % heads) --heads;
  const dim3 grid(H / heads, B, (S + kBQ - 1) / kBQ);
  flash_attention_kernel<D, KV>
      <<<grid, kGroup * heads, L::bytes(heads), stream>>>(
          q, k, v, k_scale, v_scale, q_offset, kv_len, out, H, Hkv, S, T,
          window, heads);
  return cudaSuccess;
}

template <typename KV>
cudaError_t launch_d(const float* q, const KV* k, const KV* v,
                     const float* k_scale, const float* v_scale,
                     const int* q_offset, const int* kv_len, float* out,
                     int B, int H, int Hkv, int S, int T, int D, int window,
                     cudaStream_t stream) {
  if (D == 64) {
    return launch<64, KV>(q, k, v, k_scale, v_scale, q_offset, kv_len, out,
                          B, H, Hkv, S, T, window, stream);
  }
  if (D == 128) {
    return launch<128, KV>(q, k, v, k_scale, v_scale, q_offset, kv_len, out,
                           B, H, Hkv, S, T, window, stream);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

cudaError_t launch_flash_attention(const float* q, const float* k,
                                   const float* v, const int* q_offset,
                                   const int* kv_len, float* out, int B, int H,
                                   int Hkv, int S, int T, int D, int window,
                                   cudaStream_t stream) {
  return launch_d<float>(q, k, v, nullptr, nullptr, q_offset, kv_len, out, B,
                         H, Hkv, S, T, D, window, stream);
}

cudaError_t launch_flash_attention_int8(const float* q, const int8_t* k,
                                        const int8_t* v, const float* k_scale,
                                        const float* v_scale,
                                        const int* q_offset, const int* kv_len,
                                        float* out, int B, int H, int Hkv,
                                        int S, int T, int D, int window,
                                        cudaStream_t stream) {
  return launch_d<int8_t>(q, k, v, k_scale, v_scale, q_offset, kv_len, out,
                          B, H, Hkv, S, T, D, window, stream);
}
