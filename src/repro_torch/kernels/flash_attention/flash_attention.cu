// flash_attention: causal or non-causal, optionally windowed, prefill
// attention with per-row arena offsets, for Hopper.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (`flash_attention` -> `pl.pallas_call` with body `_kernel`), both of its
// branches: float32 K/V, and int8 K/V with per-KV-vector float32 scales
// (kernel.py:60-62, the scale BlockSpecs at :165-172).
//
//   q (B, H, S, D), k/v (B, Hkv, T, D), q_offset/kv_len (B,) -> (B, H, S, D)
// Query row s of batch row b sits at position q_offset[b] + s and attends
// key t iff  t < T  and  t < kv_len[b]  and  (causal: t <= q_pos)  and
// (window > 0: t > q_pos - window) -- the masks of kernel.py:69-76 with
// its static `causal` (kernel.py:106).  The serving path's prefill passes
// causal; no served path reaches causal = false, which drops the upper
// edge of the KV loop and the diagonal mask.  Compiled for the served
// head dims, D = 64 (smollm-360m) and D = 128 (granite-8b), each for
// float and int8 K/V; the binding rejects any other D.  The masked-row
// contract is ref.py::masked_softmax: the online softmax pins m_safe to 0
// while a row's running max is -inf and floors the denominator at 1e-30,
// so a fully masked row (bucket padding, kv_len == 0) comes out as zeros.
// Both designs keep the softmax in the log2 domain (scores times
// log2(e) / sqrt(D); ex2.approx.ftz maps a masked -inf score to an exact
// 0), clip the KV loop to the tiles the block's masks can reach (it ends
// at kv_len, or where causal at min(kv_len, last causal position of the
// block), and starts at the window's lower edge; a tile inside every
// row's mask skips the mask test), stage K/V tiles (keys past T
// zero-filled) behind one block barrier per tile, and stage K/V once for
// the query heads of one KV head that share a block (GQA).
//
// What bounds it on the card: at the admission shapes (S = 256 queries
// against up to 370 keys) the work is ~4 D flops per (query, key) pair
// against (S + 2T) D 4 bytes per head, over a hundred flops per byte, so
// operations bound it, never HBM.
//
// D = 64, float (flash_attention_kernel<64, causal>): float32 FMAs on the
// CUDA cores, kept the limit rather than shared memory.  A warp
// group of 2 kBQ threads owns kBQ (64) query rows of one head; thread
// (tr, tc) holds the scores of rows tr + kBQ/8 r (r < 8) against keys
// tc + 16 n (n < 4) of a 64-key tile, built from float4 shared loads, 12
// per 128 FMAs; a row's max is reduced across its 16 threads with
// shuffles, its sum stays per thread and is reduced once at the end; P
// goes once to shared memory, transposed, in rows the warp itself owns,
// and P V is a register-tiled product into an 8 x 4 output tile per
// thread, 3 loads per 32 FMAs; one block serves up to three query heads
// (168 KB, 384 threads, one block per SM), q tiles with the longest KV
// ranges launched first; K/V tiles come by cp.async 16-byte copies into
// two stages.
//
// D = 128, float and int8, and D = 64, int8 (flash_attention_tc_kernel<D,
// KV>): Q K^T and P V on the tensor cores, wgmma with TF32 operands and
// float32 accumulators, at float32 accuracy.  One TF32 product keeps 11
// significant bits (relative error up to 2^-11, about 5e-4: a 1e-4
// tolerance on the output fails), so each float32 operand x is split into
// x_hi = x rounded to TF32 and x_lo = x - x_hi (exact), and a b is formed
// as a_lo b_hi + a_hi b_lo + a_hi b_hi, small terms first ("3xTF32"): the
// dropped a_lo b_lo and what the tensor cores drop of the lo parts' low
// bits are below 2^-20 |a b|, float32-level.  int8 K and V values are exact in
// TF32, so that instance takes 2 products (q_lo k + q_hi k; p_lo v +
// p_hi v) and folds the scales in outside them: s = k_scale (q . k8),
// o += (p v_scale) . v8.  The CUDA cores' float32 rate (67 TFLOP/s)
// bounds a SIMT design at 0.48 ms for granite's admission prefill; 3 TF32
// products at 495 TFLOP/s bound this one at 0.19 ms (int8: 0.13), and 2 at
// 0.030 ms smollm's int8 one (a SIMT design behind a dequantize pass:
// 0.113).  The layout (TcShape: keys a tile, stage sets and blocks per SM
// for each instance):
//   * a block is two warpgroups (8 warps) sharing one KV head: two of its
//     query heads on one 64-row q tile where the group is even, else two
//     q tiles of one head (smollm-360m's G = 3), where the block loops
//     over both tiles' keys; warp w of a
//     warpgroup owns its rows 16 w .. 16 w + 15 (wgmma's register A and
//     accumulator layouts are those of mma.sync m16n8k8 for each warp);
//   * K/V go in tiles of kKeys keys through stage sets of wgmma B
//     operands in shared memory (float32: K hi, K lo, V^T hi, V^T lo;
//     int8: K and V^T as exact floats, and the scales; no-swizzle K-major
//     core matrices, V transposed since 32-bit wgmma operands are
//     K-major): each tile is fetched into registers a tile ahead (__ldg)
//     and split into the next stage set while this tile's score products
//     run, one barrier a tile; at D = 128 32-key tiles in two stage sets,
//     192 KB (int8 129 KB), one block per SM; int8 at D = 64 64-key tiles
//     in two stage sets, 97 KB, two blocks per SM (one block's softmax
//     under the other's products; the launch bound caps a thread at 128
//     registers, and the rest spill to the L1), chosen over 32-key tiles,
//     a third stage set and one block per SM by timed variants
//     (tools/kernel_variants.py --only flash_int8);
//   * the A operands come from registers: Q, by cp.async into shared
//     memory in A-fragment order (one 16-byte load gives a lane its
//     values for 4 k-steps), split at each use; P straight from the score
//     accumulators: score column n of an 8-key step is key n / 2 + 4
//     (n % 2) (the K stage's row order), so a lane's accumulators ARE its
//     A fragment of P V, with no shuffle or shared memory;
//   * D runs in the same permuted order in Q's fragments and the K stage
//     (k-step s of a 32-wide block contracts d = 4 t + s and 16 + 4 t + s,
//     t = lane % 4);
//   * the online softmax runs on the accumulators, the row max over the 4
//     lanes of a row;
//   * the q tile is the fastest grid dimension, last tile first: the
//     blocks that read one KV head's K/V run together;
//   * the output rows are multiplied by the reciprocal of their sums (a
//     division per element ties it in time).
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

// The SIMT design's tile (D = 64): keys per K/V tile, query heads per
// block.
template <int D>
struct Tile;
template <>
struct Tile<64> {
  static constexpr int kBK = 64;
  static constexpr int kMaxHeads = 3;
};

constexpr int kBQ = 64;                 // query rows per warp group
constexpr int kRowStep = kBQ / 8;       // thread row r is row tr + kRowStep r
constexpr int kGroup = 2 * kBQ;         // threads per warp group
constexpr int kPP = kBQ + 4;            // padded row of P^T
constexpr float kLog2e = 1.4426950408889634f;
// The causal limit of a key position when causal is off.
constexpr int kNoLimit = 0x7fffffff;

// Shared memory, in floats: the two K/V stages, then Q and P^T per group.
template <int D>
struct Smem {
  static constexpr int kBK = Tile<D>::kBK;             // keys per KV tile
  static constexpr int kKN = kBK / 16;                 // keys of a tile/thread
  static constexpr int kOC = D / 16;                   // output columns/thread
  static constexpr int kMaxHeads = Tile<D>::kMaxHeads;  // query heads/block
  static constexpr int kDP = D + 4;                    // padded row of Q, K
  // 1 / sqrt(D) times log2(e): scores live in the log2 domain.
  static constexpr float kScaleLog2 = 0.125f * kLog2e;
  static constexpr int kKStage = kBK * kDP;
  static constexpr int kVStage = kBK * D;
  static constexpr int kGroupFloats = kBQ * kDP + kBK * kPP;
  static constexpr int kOffV = 2 * kKStage;
  static constexpr int kOffGroups = kOffV + 2 * kVStage;
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

// Four int8 values (one 32-bit word) as floats, exactly: each byte,
// offset to x + 128, becomes the low byte of the float 2^23 + x + 128,
// less 2^23 + 128.
__device__ __forceinline__ void s8x4_to_f32(uint32_t w, float* f) {
  const uint32_t u = w ^ 0x80808080u;
  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;
}

// One K/V tile (keys k0 .. k0 + kBK - 1) into a stage, by every thread of
// the block.
template <int D>
__device__ __forceinline__ void load_kv(float* ks, float* vs,
                                        const float* __restrict__ k,
                                        const float* __restrict__ v,
                                        size_t kv_base, int k0, int T) {
  using L = Smem<D>;
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

// D is the head dim; kCausal a template parameter here (a runtime flag
// slowed this register-capped body).
template <int D, bool kCausal>
__global__ void __launch_bounds__(kGroup * Tile<D>::kMaxHeads, 1)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const int* __restrict__ q_offset,
                       const int* __restrict__ kv_len,
                       float* __restrict__ out, int H, int Hkv, int S, int T,
                       int window, int heads) {
  using L = Smem<D>;
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

  const int kend = kCausal ? min(klen, qoff + min(row0 + kBQ, S)) : klen;
  int kbeg = 0;
  if (window > 0) kbeg = max(0, qoff + row0 - window + 1);
  kbeg = (kbeg / kBK) * kBK;
  const int n_tiles = kend > kbeg ? (kend - kbeg + kBK - 1) / kBK : 0;
  if (n_tiles > 0) load_kv<D>(smem, smem + kOffV, k, v, kv_base, kbeg, T);

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
  // The causal edge of the block's first row (none: past every key).
  const int lim0 = kCausal ? qoff + row0 : kNoLimit;

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it & 1;
    cp_async_wait_all();
    // Tile `it` (and the Q tiles) visible to all, and every warp done with
    // tile it - 1, whose stage the next copy overwrites.
    __syncthreads();
    const int k0 = kbeg + it * kBK;
    if (it + 1 < n_tiles) {
      load_kv<D>(smem + (stage ^ 1) * kKStage,
                 smem + kOffV + (stage ^ 1) * kVStage, k, v, kv_base,
                 k0 + kBK, T);
    }
    const float* ks = smem + stage * kKStage;
    const float* vs = smem + kOffV + stage * kVStage;

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
    const bool full = k0 + kBK <= klen && k0 + kBK - 1 <= lim0 &&
                      (window <= 0 || k0 > qoff + row0 + kBQ - 1 - window);
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int qpos = qpos0 + kRowStep * r;
      const int lim = kCausal ? qpos : kNoLimit;
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < kKN; ++n) {
        float s = sc[r][n];
        if (!full) {
          const int kk = k0 + tc + 16 * n;
          const bool ok = kk < klen && kk <= lim &&
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


// ---------------------------------------------------------------------------
// Tensor cores: Q K^T and P V by wgmma, TF32 operands split into hi + lo,
// float32 accumulators.
// ---------------------------------------------------------------------------

constexpr int kTcRows = 64;                // query rows of a warpgroup
constexpr int kTcWarps = kTcRows / 16;     // warps of a warpgroup
constexpr int kTcHeadThreads = 32 * kTcWarps;
constexpr int kTcThreads = 2 * kTcHeadThreads;  // two warpgroups a block

// The shape of each instance: keys a K/V tile, stage sets, and the blocks
// a multiprocessor holds at once (the launch bound).
template <int D, typename KV>
struct TcShape {
  static constexpr int kKeys = 32;
  static constexpr int kStages = 2;
  static constexpr int kMinBlocks = 1;
};
template <>
struct TcShape<64, int8_t> {
  static constexpr int kKeys = 64;
  static constexpr int kStages = 2;
  static constexpr int kMinBlocks = 2;
};

// Shared memory, in bytes: the stage sets, then each warpgroup's Q.  A
// stage set holds one tile as wgmma B operands (no-swizzle K-major core
// matrices, 8 rows x 16 bytes, 128 contiguous bytes): float32 K hi, K lo,
// V^T hi, V^T lo; int8 K and V^T (as exact floats), then the tile's
// k_scale and v_scale.
//   K (N = keys, K = D): core (row / 8, c4) at (c4 * kKeys / 8 + row / 8)
//     * 128; key q of an 8-key step sits at row 2 (q % 4) + q / 4, and D
//     follows the A fragments' order: k-step 4 bb + s holds d = 32 bb + 16
//     h + 4 t + s at k = t + 4 h;
//   V^T (N = D, K = keys): core (d / 8, key / 4) at (key / 4 * D / 8 + d
//     / 8) * 128.
template <int D, typename KV>
struct TcLayout {
  static constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  static constexpr int kKeys = TcShape<D, KV>::kKeys;
  static constexpr int kStages = TcShape<D, KV>::kStages;
  static constexpr int kSteps = kKeys / 8;            // 8-key steps a tile
  static constexpr int kArray = kKeys * D * 4;        // one B array
  static constexpr int kOffV = kQuant ? kArray : 2 * kArray;
  static constexpr int kOffScale = 2 * kArray;        // int8 only
  static constexpr int kStage = kQuant ? 2 * kArray + 8 * kKeys : 4 * kArray;
  static constexpr int kOffQ = kStages * kStage;
  static constexpr int kBytes = kOffQ + 2 * kTcRows * D * 4;
  // 1 / sqrt(D) times log2(e): scores live in the log2 domain.
  static constexpr float kScaleLog2 =
      (D == 64 ? 0.125f : 0.08838834764831845f) * kLog2e;
};

__device__ __forceinline__ float part(const float4& x, int i) {
  return i == 0 ? x.x : i == 1 ? x.y : i == 2 ? x.z : x.w;
}

// x rounded to TF32 as float32 bits: nearest, ties away from zero (the
// values of cvt.rna.tf32.f32, in two integer operations: half a TF32 ulp
// added to the magnitude, the 13 low bits cleared).
__device__ __forceinline__ uint32_t tf32_bits(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo: hi = tf32(x); lo = x - hi (exact, at most 2^-11 |x|),
// handed to the tensor cores unrounded: whatever they make of its 13 low
// bits moves a product by under 2^-21 of it (and measured, the same error
// against float64 as lo rounded to TF32).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_bits(x);
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// A wgmma descriptor of a no-swizzle K-major operand at p: lbo bytes
// between core matrices along K, sbo along M or N.
__device__ __forceinline__ uint64_t wg_desc(const void* p, uint32_t lbo,
                                            uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return static_cast<uint64_t>((a >> 4) & 0x3FFF) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Holds a register read or written by an asynchronous wgmma in place until
// after its wait.
__device__ __forceinline__ void wg_keep(float& x) {
  asm volatile("" : "+f"(x)::"memory");
}
__device__ __forceinline__ void wg_keep(uint32_t& x) {
  asm volatile("" : "+r"(x)::"memory");
}

// d (64 x 8 N) += a (64 x 8; this warp's 16 rows in registers, the
// m16n8k8 A layout) b (8 x 8 N, shared memory), TF32, for N = 4, 8, 16.
__device__ __forceinline__ void wg_mma(float (&d)[4][4],
                                       const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wg_mma(float (&d)[8][4],
                                       const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wg_mma(float (&d)[16][4],
                                       const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// A thread's share of a K/V tile, fetched into registers one tile ahead.
// Float32 (D = 128, 32 keys), e = x + 256 j (j < 4): K's 16 bytes at key
// 8 ((e / 32) % 4) + (e % 32) / 4, columns 4 c .. 4 c + 3 with c = 4 (e /
// 128) + e % 4 (a warp reads 8 keys x 64 contiguous bytes); V's column e
// % 128 over keys 4 (e / 128) .. + 3.  int8, threads x below kKeys D / 16
// (which is also (kKeys / 4) (D / 4)): K's 16 bytes at key x % kKeys,
// columns 16 (x / kKeys) ..; V's 4 bytes at columns 4 (x % (D / 4)) .. of
// keys 4 (x / (D / 4)) .. + 3; threads below 2 kKeys a scale.  Keys past
// T are zeros.
template <typename KV>
struct TcShare;
template <>
struct TcShare<float> {
  float4 k[4];
  float v[4][4];
};
template <>
struct TcShare<int8_t> {
  uint4 k;
  uint32_t v[4];
  float scale;
};

template <int D>
__device__ __forceinline__ void tc_fetch(TcShare<float>& x,
                                         const float* __restrict__ k,
                                         const float* __restrict__ v,
                                         const float*, const float*,
                                         size_t kv_base, int k0, int T) {
  static_assert(D == 128 && TcShape<D, float>::kKeys == 32,
                "the float32 share is laid out for D = 128, 32 keys");
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int e = threadIdx.x + kTcThreads * j;
    const int r = 8 * ((e / 32) % 4) + (e % 32) / 4;
    const int c = 4 * (e / 128) + e % 4;
    x.k[j] = k0 + r < T
                 ? __ldg(reinterpret_cast<const float4*>(
                             k + kv_base +
                             static_cast<size_t>(k0 + r) * D) + c)
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    const int d = e % D, c4 = e / D;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int kk = k0 + 4 * c4 + u;
      x.v[j][u] = kk < T ? __ldg(v + kv_base +
                                 static_cast<size_t>(kk) * D + d)
                         : 0.f;
    }
  }
}

template <int D>
__device__ __forceinline__ void tc_fetch(TcShare<int8_t>& x,
                                         const int8_t* __restrict__ k,
                                         const int8_t* __restrict__ v,
                                         const float* __restrict__ k_scale,
                                         const float* __restrict__ v_scale,
                                         size_t kv_base, int k0, int T) {
  constexpr int kKeys = TcShape<D, int8_t>::kKeys;
  const int e = threadIdx.x;
  if (kKeys * D / 16 == kTcThreads || e < kKeys * D / 16) {
    const int r = e % kKeys, m = e / kKeys;
    x.k = k0 + r < T ? __ldg(reinterpret_cast<const uint4*>(
                                 k + kv_base +
                                 static_cast<size_t>(k0 + r) * D) + m)
                     : make_uint4(0u, 0u, 0u, 0u);
    const int c = e % (D / 4), c4 = e / (D / 4);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int kk = k0 + 4 * c4 + u;
      x.v[u] = kk < T ? __ldg(reinterpret_cast<const uint32_t*>(
                                  v + kv_base +
                                  static_cast<size_t>(kk) * D) + c)
                      : 0u;
    }
  }
  if (e < 2 * kKeys) {
    const int kk = k0 + e % kKeys;
    const float* src = e < kKeys ? k_scale : v_scale;
    x.scale = kk < T ? __ldg(src + kv_base / D + kk) : 0.f;
  }
}

// The B row of key r of a tile (score column n of a step is key n / 2 +
// 4 (n % 2)).
__device__ __forceinline__ int tc_krow(int r) {
  const int q = r % 8;
  return (r / 8) * 8 + 2 * (q % 4) + q / 4;
}

// Share j of a fetched tile into the stage set at `stage`: float32 split
// into hi and lo (K's four values go to four k-steps: 4-byte stores, free
// of bank conflicts; V's 16-byte ones).
template <int D>
__device__ __forceinline__ void tc_store(const TcShare<float>& x, int j,
                                         unsigned char* stage) {
  using L = TcLayout<D, float>;
  constexpr int kKeys = L::kKeys;
  const int e = threadIdx.x + kTcThreads * j;
  {
    const int r = 8 * ((e / 32) % 4) + (e % 32) / 4;
    const int c = 4 * (e / 128) + e % 4;
    const int bb = c / 8, hh = (c / 4) % 2, tt = c % 4;
    const int row = tc_krow(r);
    uint32_t* khi = reinterpret_cast<uint32_t*>(stage);
    uint32_t* klo = reinterpret_cast<uint32_t*>(stage + L::kArray);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      uint32_t hi, lo;
      split_tf32(part(x.k[j], s), hi, lo);
      const int c4 = 2 * (4 * bb + s) + hh;
      const int at = ((c4 * (kKeys / 8) + row / 8) * 8 + row % 8) * 4 + tt;
      khi[at] = hi;
      klo[at] = lo;
    }
  }
  {
    uint32_t hi[4], lo[4];
    const int d = e % D, c4 = e / D;
#pragma unroll
    for (int u = 0; u < 4; ++u) split_tf32(x.v[j][u], hi[u], lo[u]);
    const int at = (c4 * (D / 8) + d / 8) * 8 + d % 8;
    reinterpret_cast<uint4*>(stage + L::kOffV)[at] =
        make_uint4(hi[0], hi[1], hi[2], hi[3]);
    reinterpret_cast<uint4*>(stage + L::kOffV + L::kArray)[at] =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// int8: one share a thread (j = 0), converted exactly, and the scales.
template <int D>
__device__ __forceinline__ void tc_store(const TcShare<int8_t>& x, int j,
                                         unsigned char* stage) {
  using L = TcLayout<D, int8_t>;
  constexpr int kKeys = L::kKeys;
  if (j > 0) return;
  const int e = threadIdx.x;
  if (kKeys * D / 16 == kTcThreads || e < kKeys * D / 16) {
    {
      // Columns 16 m .. of key r: block bb = m / 2, half hh = m % 2;
      // k-step 4 bb + s takes t = 0..3 (d = 32 bb + 16 hh + 4 t + s).
      const int r = e % kKeys, m = e / kKeys;
      const int bb = m / 2, hh = m % 2;
      const int row = tc_krow(r);
      float f[4][4];  // [t][s]
      s8x4_to_f32(x.k.x, f[0]);
      s8x4_to_f32(x.k.y, f[1]);
      s8x4_to_f32(x.k.z, f[2]);
      s8x4_to_f32(x.k.w, f[3]);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int c4 = 2 * (4 * bb + s) + hh;
        const int at = (c4 * (kKeys / 8) + row / 8) * 8 + row % 8;
        reinterpret_cast<float4*>(stage)[at] =
            make_float4(f[0][s], f[1][s], f[2][s], f[3][s]);
      }
    }
    {
      // Columns 4 c .. 4 c + 3 of keys 4 c4 .. 4 c4 + 3.
      const int c = e % (D / 4), c4 = e / (D / 4);
      float f[4][4];  // [key][column]
#pragma unroll
      for (int u = 0; u < 4; ++u) s8x4_to_f32(x.v[u], f[u]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int d = 4 * c + i;
        const int at = (c4 * (D / 8) + d / 8) * 8 + d % 8;
        reinterpret_cast<float4*>(stage + L::kOffV)[at] =
            make_float4(f[0][i], f[1][i], f[2][i], f[3][i]);
      }
    }
  }
  if (e < 2 * kKeys) {
    reinterpret_cast<float*>(stage + L::kOffScale)[e] = x.scale;
  }
}

// A block is two warpgroups sharing one KV head: two of its query heads on
// the same q tile where `pair` (the group is even), else two q tiles of
// one query head.  Warp w of a warpgroup owns its rows 16 w .. 16 w + 15.
template <int D, typename KV>
__global__ void __launch_bounds__(kTcThreads, TcShape<D, KV>::kMinBlocks)
flash_attention_tc_kernel(const float* __restrict__ q,
                          const KV* __restrict__ k,
                          const KV* __restrict__ v,
                          const float* __restrict__ k_scale,
                          const float* __restrict__ v_scale,
                          const int* __restrict__ q_offset,
                          const int* __restrict__ kv_len,
                          float* __restrict__ out, int H, int Hkv, int S,
                          int T, int window, int causal, int pair) {
  using L = TcLayout<D, KV>;
  constexpr int kD = D, kBK = L::kKeys, kSteps = L::kSteps;
  constexpr int kStages = L::kStages;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / kTcWarps, w = warp % kTcWarps;
  const int g = lane / 4, t = lane % 4;
  // The q tile (pair: of both warpgroups) is the fastest grid dimension,
  // last first: the blocks that read one KV head's K/V run together, the
  // longest KV range of each first.
  const int xq = gridDim.x - 1 - blockIdx.x;
  const int h = pair ? 2 * blockIdx.y + wg : blockIdx.y;
  const int iq = pair ? xq : 2 * xq + wg;
  const int b = blockIdx.z;
  const int kvh = h / (H / Hkv);
  const int row0 = iq * kTcRows;
  const int brow0 = (pair ? xq : 2 * xq) * kTcRows;  // the block's rows
  const int brow1 = brow0 + (pair ? kTcRows : 2 * kTcRows);
  const int qoff = q_offset[b];
  const int klen = min(kv_len[b], T);
  const size_t q_base = (static_cast<size_t>(b) * H + h) * S * kD;
  const size_t kv_base = (static_cast<size_t>(b) * Hkv + kvh) * T * kD;

  const int kend = causal ? min(klen, qoff + min(brow1, S)) : klen;
  int kbeg = 0;
  if (window > 0) kbeg = max(0, qoff + brow0 - window + 1);
  kbeg = (kbeg / kBK) * kBK;
  const int n_tiles = kend > kbeg ? (kend - kbeg + kBK - 1) / kBK : 0;

  // This warpgroup's Q tile by cp.async, in A-fragment order: float4 (w,
  // bb, i) of lane 4 g + t holds row 16 w + g + 8 (i / 2), columns 32 bb +
  // 16 (i % 2) + 4 t .. + 3 (the 4 k-steps of block bb).  Rows past S are
  // zeros (their outputs are not stored).  The first K/V tile goes
  // straight into stage set 0, the second into registers.
  float4* qf = reinterpret_cast<float4*>(tc_smem + L::kOffQ +
                                         wg * kTcRows * kD * 4);
  TcShare<KV> share;
  if (n_tiles > 0) {
    for (int e = threadIdx.x % kTcHeadThreads; e < kTcRows * kD / 4;
         e += kTcHeadThreads) {
      const int r = e / (kD / 4), c = e % (kD / 4);
      const int s = row0 + r;
      const int rr = r % 16;
      const int frag =
          ((r / 16) * (kD / 32) + c / 8) * 4 + 2 * (rr / 8) + (c % 8) / 4;
      cp_async16_zfill(qf + frag * 32 + 4 * (rr % 8) + c % 4,
                       q + q_base + static_cast<size_t>(s < S ? s : 0) * kD +
                           4 * c,
                       s < S);
    }
    cp_async_commit();
    tc_fetch<D>(share, k, v, k_scale, v_scale, kv_base, kbeg, T);
#pragma unroll
    for (int j = 0; j < 4; ++j) tc_store<D>(share, j, tc_smem);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (n_tiles > 1) {
      tc_fetch<D>(share, k, v, k_scale, v_scale, kv_base, kbeg + kBK, T);
    }
    cp_async_wait_all();
    __syncthreads();
  }
  const float4* qw = qf + w * (kD / 8) * 32 + lane;

  const int wrow0 = row0 + 16 * w;
  const int wpos0 = qoff + wrow0;
  const int wpos1 = qoff + min(wrow0 + 15, S - 1);
  const int wlim0 = causal ? wpos0 : kNoLimit;

  float o[kD / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = kbeg + it * kBK;
    const unsigned stage = static_cast<unsigned>(it) % kStages;
    const unsigned char* st = tc_smem + stage * L::kStage;
    unsigned char* next =
        tc_smem + (stage + 1 == kStages ? 0 : stage + 1) * L::kStage;
    const bool more = it + 1 < n_tiles;

    // Scores, in D / 32 batches of 4 k-steps: Q's A fragments split in
    // registers, then lo hi + hi lo + hi hi (int8: lo k + hi k) against
    // the stage; while a batch runs, the next tile's share goes into the
    // next stage set.
    float sc[kSteps][4];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      sc[i][0] = sc[i][1] = sc[i][2] = sc[i][3] = 0.f;
    }
#pragma unroll
    for (int bb = 0; bb < kD / 32; ++bb) {
      uint32_t ah[4][4], al[4][4];
      const float4 f0 = qw[(4 * bb) * 32], f1 = qw[(4 * bb + 1) * 32];
      const float4 f2 = qw[(4 * bb + 2) * 32], f3 = qw[(4 * bb + 3) * 32];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        split_tf32(part(f0, s), ah[s][0], al[s][0]);
        split_tf32(part(f2, s), ah[s][1], al[s][1]);
        split_tf32(part(f1, s), ah[s][2], al[s][2]);
        split_tf32(part(f3, s), ah[s][3], al[s][3]);
      }
      wg_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const unsigned char* kb = st + (4 * bb + s) * 2 * (kBK / 8) * 128;
        const uint64_t dh = wg_desc(kb, (kBK / 8) * 128, 128);
        wg_mma(sc, al[s], dh);
        if constexpr (!L::kQuant) {
          wg_mma(sc, ah[s], wg_desc(kb + L::kArray, (kBK / 8) * 128, 128));
        }
        wg_mma(sc, ah[s], dh);
      }
      wg_commit();
      if (more) tc_store<D>(share, bb, next);
      wg_wait();
#pragma unroll
      for (int s = 0; s < 4; ++s) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          wg_keep(ah[s][r]);
          wg_keep(al[s][r]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
#pragma unroll
      for (int r = 0; r < 4; ++r) wg_keep(sc[i][r]);
    }
    if (more) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (it + 2 < n_tiles) {
      tc_fetch<D>(share, k, v, k_scale, v_scale, kv_base, k0 + 2 * kBK, T);
    }

    // Masks and the online softmax, rows g (rr = 0) and g + 8 (rr = 1);
    // element (i, 2 rr + e) is key k0 + 8 i + t + 4 e.  A tile inside
    // every row's mask skips the test (warp-uniform).
    const float* ksc = reinterpret_cast<const float*>(st + L::kOffScale);
    const float* vsc = ksc + kBK;
    const bool full = k0 + kBK <= klen && k0 + kBK - 1 <= wlim0 &&
                      (window <= 0 || k0 > wpos1 - window);
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int pos = wpos0 + g + 8 * rr;
      const int lim = causal ? pos : kNoLimit;
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < kSteps; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          // Scores in the log2 domain: times log2(e) / sqrt(D) (int8:
          // and the key's scale).
          float s = sc[i][2 * rr + e] * L::kScaleLog2;
          if constexpr (L::kQuant) s *= ksc[8 * i + t + 4 * e];
          if (!full) {
            const int kk = k0 + 8 * i + t + 4 * e;
            const bool ok = kk < klen && kk <= lim &&
                            (window <= 0 || kk > pos - window);
            if (!ok) s = -INFINITY;
          }
          sc[i][2 * rr + e] = s;
          mx = fmaxf(mx, s);
        }
      }
      // The 4 lanes of a row are neighbours.
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[rr], mx);
      const float m_safe = isfinite(m_new) ? m_new : 0.f;
      const float alpha = exp2_ftz(m[rr] - m_safe);  // 0 while m is -inf
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < kSteps; ++i) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p = exp2_ftz(sc[i][2 * rr + e] - m_safe);
          sc[i][2 * rr + e] = p;  // masked: exactly 0
          psum += p;
        }
      }
      l[rr] = l[rr] * alpha + psum;
      m[rr] = m_new;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        o[j][2 * rr] *= alpha;
        o[j][2 * rr + 1] *= alpha;
      }
    }

    // O += P V: P's A fragment of step i is sc[i] (keys t and t + 4 of
    // the step; int8: times v_scale), split; B the V^T stage.
    uint32_t ph[kSteps][4], pl[kSteps][4];
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      float p[4] = {sc[i][0], sc[i][2], sc[i][1], sc[i][3]};
      if constexpr (L::kQuant) {
        const float va = vsc[8 * i + t], vb = vsc[8 * i + t + 4];
        p[0] *= va;
        p[1] *= va;
        p[2] *= vb;
        p[3] *= vb;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) split_tf32(p[r], ph[i][r], pl[i][r]);
    }
    wg_fence();
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
      const unsigned char* vb = st + L::kOffV + i * 2 * (kD / 8) * 128;
      const uint64_t dh = wg_desc(vb, (kD / 8) * 128, 128);
      wg_mma(o, pl[i], dh);
      if constexpr (!L::kQuant) {
        wg_mma(o, ph[i], wg_desc(vb + L::kArray, (kD / 8) * 128, 128));
      }
      wg_mma(o, ph[i], dh);
    }
    wg_commit();
    wg_wait();
#pragma unroll
    for (int j = 0; j < kD / 8; ++j) {
#pragma unroll
      for (int r = 0; r < 4; ++r) wg_keep(o[j][r]);
    }
#pragma unroll
    for (int i = 0; i < kSteps; ++i) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        wg_keep(ph[i][r]);
        wg_keep(pl[i][r]);
      }
    }
    // The next stage set complete and visible; both warpgroups done with
    // this one, which a later tile overwrites.
    __syncthreads();
  }

  // Row sums across the row's 4 lanes; o[j][2 rr + e] is column 8 j + 2 t
  // + e of row g + 8 rr.
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    float lt = l[rr];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int s = wrow0 + g + 8 * rr;
    if (s < S) {
      const float inv = 1.f / fmaxf(lt, 1e-30f);
      float* orow = out + q_base + static_cast<size_t>(s) * kD + 2 * t;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        *reinterpret_cast<float2*>(orow + 8 * j) =
            make_float2(o[j][2 * rr] * inv, o[j][2 * rr + 1] * inv);
      }
    }
  }
}

}  // namespace

bool flash_attention_has_head_dim(int d) { return d == 64 || d == 128; }

namespace {

// The float32 instance at D = 64 (the SIMT design).
template <bool kCausal>
cudaError_t launch_simt(const float* q, const float* k, const float* v,
                        const int* q_offset, const int* kv_len, float* out,
                        int B, int H, int Hkv, int S, int T, int window,
                        cudaStream_t stream) {
  constexpr int D = 64;
  using L = Smem<D>;
  static_assert(kBQ % 32 == 0 && L::kBK % 16 == 0 && D == 64 * (L::kOC / 4),
                "thread (tr, tc): 8 rows, kKN keys, kOC output columns");
  static_assert(L::bytes(L::kMaxHeads) <= 232448, "one block fits on an SM");
  static_assert(L::kDP % 4 == 0 && kPP % 4 == 0 && L::kGroupFloats % 4 == 0 &&
                L::kOffV % 4 == 0, "float4 alignment");
  // The dynamic shared memory above 48 KB is granted once per device.
  constexpr int kMaxDevices = 64;
  static bool granted[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices || !granted[device]) {
    err = cudaFuncSetAttribute(flash_attention_kernel<D, kCausal>,
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
  flash_attention_kernel<D, kCausal>
      <<<grid, kGroup * heads, L::bytes(heads), stream>>>(
          q, k, v, q_offset, kv_len, out, H, Hkv, S, T, window, heads);
  return cudaSuccess;
}

template <int D, typename KV>
cudaError_t launch_tc(const float* q, const KV* k, const KV* v,
                      const float* k_scale, const float* v_scale,
                      const int* q_offset, const int* kv_len, float* out,
                      int B, int H, int Hkv, int S, int T, int window,
                      int causal, cudaStream_t stream) {
  using L = TcLayout<D, KV>;
  static_assert(L::kBytes * TcShape<D, KV>::kMinBlocks <= 232448,
                "the blocks of an SM fit in its shared memory");
  static_assert(L::kStage % 128 == 0 && L::kArray % 128 == 0 &&
                L::kOffQ % 16 == 0, "stage and Q alignment");
  static_assert(L::kKeys % 8 == 0 && L::kKeys <= 64 && D % 32 == 0 &&
                L::kStages >= 2, "wgmma shapes: n32 / n64 scores");
  static_assert(L::kQuant ? L::kKeys * D / 16 <= kTcThreads
                          : D * L::kKeys == 16 * kTcThreads,
                "one int8 share a thread; four float32 shares");
  constexpr int kMaxDevices = 64;
  static bool granted[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices || !granted[device]) {
    err = cudaFuncSetAttribute(flash_attention_tc_kernel<D, KV>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::kBytes);
    if (err != cudaSuccess) return err;
    if (device < kMaxDevices) granted[device] = true;
  }
  // Two query heads of one KV head a block where the group is even, else
  // two q tiles of one query head.
  const int pair = (H / Hkv) % 2 == 0;
  const int nq = (S + kTcRows - 1) / kTcRows;
  const dim3 grid(pair ? nq : (nq + 1) / 2, pair ? H / 2 : H, B);
  flash_attention_tc_kernel<D, KV><<<grid, kTcThreads, L::kBytes, stream>>>(
      q, k, v, k_scale, v_scale, q_offset, kv_len, out, H, Hkv, S, T, window,
      causal, pair);
  return cudaSuccess;
}

}  // namespace

cudaError_t launch_flash_attention(const float* q, const float* k,
                                   const float* v, const int* q_offset,
                                   const int* kv_len, float* out, int B, int H,
                                   int Hkv, int S, int T, int D, int window,
                                   int causal, cudaStream_t stream) {
  if (D == 64) {
    return causal ? launch_simt<true>(q, k, v, q_offset, kv_len, out, B, H,
                                      Hkv, S, T, window, stream)
                  : launch_simt<false>(q, k, v, q_offset, kv_len, out, B, H,
                                       Hkv, S, T, window, stream);
  }
  if (D == 128) {
    return launch_tc<128, float>(q, k, v, nullptr, nullptr, q_offset,
                                 kv_len, out, B, H, Hkv, S, T, window,
                                 causal, stream);
  }
  return cudaErrorInvalidValue;
}

cudaError_t launch_flash_attention_int8(const float* q, const int8_t* k,
                                        const int8_t* v, const float* k_scale,
                                        const float* v_scale,
                                        const int* q_offset, const int* kv_len,
                                        float* out, int B, int H, int Hkv,
                                        int S, int T, int D, int window,
                                        int causal, cudaStream_t stream) {
  if (D == 64) {
    return launch_tc<64, int8_t>(q, k, v, k_scale, v_scale, q_offset, kv_len,
                                 out, B, H, Hkv, S, T, window, causal,
                                 stream);
  }
  if (D == 128) {
    return launch_tc<128, int8_t>(q, k, v, k_scale, v_scale, q_offset,
                                  kv_len, out, B, H, Hkv, S, T, window,
                                  causal, stream);
  }
  return cudaErrorInvalidValue;
}
