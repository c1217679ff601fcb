// decode_attention: one-query GQA attention over a KV cache for Hopper,
// each row's keys split over a thread-block cluster.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/decode_attention/kernel.py:83 (`decode_attention` ->
// `pl.pallas_call` at :128, body `_kernel`), both of its branches: float32
// K/V (`decode_attention_kernel<D, G>`), and int8 K/V with per-KV-vector
// float32 scales (kernel.py:53-55, the scale BlockSpecs at :122-127;
// `decode_attention_kernel_int8<D, G>`, a design of its own, below); above
// 8 query heads a KV head both on `decode_attention_group_kernel<D, MT,
// KV>`.
//
//   q (B, H, D), k/v (B, Hkv, T, D), kv_len (B,) -> out (B, H, D)
//   out[b, h] = softmax_t(q[b,h] . k[b, h/G, t] / sqrt(D), t < kv_len[b])
//               @ v[b, h/G]
// with the Pallas kernel's masked-row contract: `m_safe` pinned to 0 while
// the max is -inf and the denominator floored at 1e-30, so a row with
// kv_len == 0 comes out as zeros; keys past kv_len are never read.
// Compiled for the served head dims, D = 64 (smollm-360m) and D = 128
// (granite-8b), template parameters beside G (1..8); the binding rejects
// any other head dim.
//
// GQA groups.  The G <= 8 instances hold the softmax state and the P V
// accumulators of all G heads in each warp's registers (at D = 128, G = 8
// already spills a little under the 128-register cap).  A larger group
// (granite-34b's 48 query heads over one KV head, llama3-405b's 16) runs on
// the group instance (`decode_attention_group_kernel<D, MT, KV>`, below,
// KV float or int8_t), which, as the Pallas kernel's grid step does, holds
// the whole group against each K/V tile: one block, or one cluster of key
// splits, per (row, KV head), so each key (and, int8, its scales) is
// copied into shared memory once per KV head, and q K^T and P V run on the
// tensor cores with the group's heads as M (MT = ceil(G / 16) m-tiles, at
// most 3; a group above 48 runs as head slots of at most 48, and the int8
// plan may take slots of 16 heads over a short row).
//
// What bounds it on the card: bytes.  One query per head does ~4 D flops
// per key against the K and V bytes that its G heads share, so the time
// is the K/V stream: 2 * Hkv * sum(min(kv_len, T)) * D * 4 bytes for
// float32 (15-20 MB at smollm-360m's serve shape, 4.6-6 us at 3.35 TB/s),
// 2 * Hkv * keys * (D + 4) for int8, about a quarter.  A stream that
// short needs the whole card pulling at once, so both designs put every
// SM's bytes in flight early:
//   * grid (splits, Hkv, B), launched as clusters of `splits` blocks
//     (cudaLaunchKernelEx with a cluster dimension).  Block i of a
//     cluster owns keys [i chunk, (i + 1) chunk) of one (b, KV head) row;
//     the wrapper's plan (`ops.py::decode_split_plan`) picks `splits` per
//     instance.  A block whose range starts at or past kv_len loads
//     nothing and leaves the neutral partial (m = -inf, l = 0, acc = 0);
//   * one thread copies the block's live K and V keys, each one contiguous
//     run of keys * D bytes per element byte, with TMA bulk copies
//     (cp.async.bulk) that complete on an mbarrier; a range longer than
//     one tile streams through a two-stage ring (a full and an empty
//     mbarrier per stage), so the next tile loads while this one is used;
//   * the warps keep their own online softmax for all G query heads of
//     the group in registers, so each K/V byte is read from device memory
//     once for the group; no block barrier per tile: a warp waits only
//     for its tile to arrive;
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
//
// The float32 instance: each lane takes 32 columns of one key, so a key
// spans D / 32 lanes (a half-warp at D = 64, a quarter-warp at D = 128)
// and a warp holds 32 / (D / 32) keys of a tile (16 and 8).  A 4-warp
// tile is then 64 keys at D = 64 and 32 at D = 128: the same 32 KB of
// K and V per stage, so two stages (66 KB) fit three blocks on an SM at
// either head dim.  The D / 32 lanes of a key split D for the scores
// (float4 shared loads, the column order swizzled by key so a
// quarter-warp touches 8 distinct bank groups) and sum by shuffles; a
// max and a sum tree per tile and head; P V takes each key's weight from
// its lane by a shuffle.
//
// The group instance (a GQA group above 8).  What bounds it on this card:
// float32, bytes.  The arithmetic per K/V byte is G / 2 flops (4 G flops
// a key against 8 D bytes), so at granite-34b's G = 48 and 4,096 keys a
// row the 3.2 GFLOP take 48 us on the FMA pipes, more than the 40 us of
// bytes, and 20 us on the tensor cores at float32 accuracy (3 TF32
// products a product), less.  A first design on the FMA pipes (8 warps
// dividing the heads, q and the accumulators in registers) ran at about a
// fifth of the float32 rate: 245 us there, whatever its warps, unrolling,
// stages or shared-memory reads (`tools/kernel_variants.py --only
// decode_g48 decode_g16`, PERF.md).  int8 K/V are a quarter of the bytes
// (10 us there) and their values exact in TF32, so 2 products a product
// (13 us): the products bound it on paper.  Measured, the conversions
// bind it: int8 to float by byte permutes runs on the integer pipes at
// half the FMA rate, and over 4,096 keys a probe without V's conversions
// took 22-25 % less time, one without the scores' or P V's mma.sync 2-14
// % less (`tools/kernel_variants.py`, PERF.md).  Both types run one
// design:
//   * grid (splits, Hkv x slots, B) in clusters of `splits`; MT x KS
//     warps a block (KS = 4 key slices at MT = 3 and for int8 K/V, 2
//     below), warp (mt, ks) taking m-tile mt (16 heads) against the
//     32-key tiles j = ks (mod KS);
//   * each tile arrives on one mbarrier into stage j % (KS St), St
//     stages a slice (float32 1: K and V by one bulk copy each,
//     `load_tile`; int8 2, a quarter of the bytes a stage: K and V and
//     the 16-byte aligned spans of their scale rows, `load_tile_int8`),
//     refilled by warp (0, ks) once the slice's MT warps are done with it
//     (a full and an empty mbarrier a stage);
//   * q of the slot's heads sits in shared memory, rows padded to D + 16
//     floats; S = q K^T and out += P V by mma.sync m16n8k8 TF32, every
//     float32 operand split hi + lo: 3 products a product (lo hi, hi lo,
//     hi hi) for float32 K/V, 2 for int8 (q lo K8, q hi K8; p lo V8, p hi
//     V8, the V scale folded into the weight p and the K scale into the
//     score), which holds the error against float64 within 4x the plain
//     version's (the rule of the flash instance);
//   * the k dims are permuted so that a lane's q and K fragments of two
//     k-steps are one 16-byte load (int8: one 16-byte load of its K row
//     feeds 8 k-steps, and q's chunks are stored swizzled to match); S's
//     accumulator is P V's A fragment as it stands (P V's k index t is
//     the n-tile's key 2 t, t + 4 its key 2 t + 1); out's dims are
//     permuted so that a lane's V fragments of four n-tiles are one
//     16-byte load a key (int8: one 4-byte load).  K and V rows are not
//     padded: a bulk copy a row into padded rows, or cp.async, cost more
//     than the bank conflicts they remove;
//   * each tile's P V lands in fresh accumulators, added to out by one
//     rounded FMA each: the tensor cores' float32 sums truncate, and one
//     chain over llama3-405b's 4,096 keys put the error against float64
//     at 6.3x plain's;
//   * each warp keeps its own online softmax for its two rows a lane;
//     the slices merge in the block over the stages, and with splits > 1
//     rank r merges heads [r hpr, (r + 1) hpr) from the partials that
//     its peers push into its shared memory after a cluster barrier.
// At MT = 3 a block takes one SM (12 warps of 168 registers, 158 KB), and
// the card holds only 30 clusters of 4 such blocks, so the wrapper's
// plan (`ops.py::decode_group_plan`) splits a row only when its tiles
// outnumber the slices, and then into clusters that three quarters of the
// SMs hold; over a short int8 row it takes head slots of 16 heads (MT =
// 1) instead, for more blocks.
//
// The int8 instance (G <= 8) is sized to its own bytes.  Its float32-sized
// chain (a shuffle sum per key, two trees per 16 keys and head, one
// shuffle per key and head in P V) and its float32 tiles (8 KB a stage)
// left it at 7-10x its bound.  Here, with 8 warps a block taking a tile's
// 32-key chunks in turn:
//   * a stage carries as many bytes as a float32 one: 256 keys at D = 64,
//     128 at D = 128 (32 KB of K and V), and the tile's scales with it:
//     a (b, head) row of scales starts at ((b Hkv + h) T + t) * 4 bytes,
//     only 8-byte aligned at the serve buffer (T = 370), so the same
//     mbarrier takes two more bulk copies of the scale arrays from the
//     16-byte boundary at or before the tile's first key to the one at or
//     after its last (clipped to the tensor; a key past the clip, at most
//     three at the very end of a tensor whose size is no multiple of 4,
//     is read from global memory);
//   * a lane scores a whole key (at D = 128 a lane pair, 64 bytes each,
//     one shuffle to add): four 16-byte shared loads of its int8 row,
//     converted exactly by a byte permute and an add (2^23 + 128 + x as
//     float bits, less 2^23 + 128) where an int-to-float conversion runs
//     at an eighth of the FMA rate, against q from shared memory (each
//     16-column chunk padded to 20 floats).  Each lane starts its row at
//     another 16-byte chunk (rotated by key), so a quarter-warp's loads
//     of K and of q hit 8 distinct bank groups;
//   * per 32 keys and head one max tree; the sums stay per lane (the max
//     is warp-uniform) and meet in one tree at the end;
//   * the weights, with the V scale folded in, go to a per-warp shared
//     array, and P V reads them as broadcasts, four keys a float4, each
//     lane owning D / 32 columns of the output;
//   * a one-split plan merges in the block and writes the output, with no
//     cluster barrier; with more splits rank 0 merges `splits` partials.
// Measured on the card (`tools/kernel_variants.py`): one split beats two
// and four at both serve shapes, 8 warps beat 4 at D = 64, the byte
// permute beats `cvt`; the floor of this design (its grid and data
// movement, no arithmetic) is about 40 % of its time at D = 64, and a
// tensor-core variant (mma.sync, fp16 hi + lo) ties it at D = 64.
// `decode_int8_floor_kernel` is that floor, for measurement only
// (`chip_smoke.py` times it beside the int8 instance).
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cmath>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;                   // tiles in flight per block
constexpr int kMaxG = 8;                     // query heads per KV head
constexpr int kMaxSplits = 8;                // the portable cluster size

// The compiled head dims and the float32 instance's work layout.
template <int D>
struct Dims {
  static_assert(D == 64 || D == 128, "compiled for head dims 64 and 128");
  static constexpr int kKeyLanes = D / 32;           // lanes per key
  static constexpr int kWarpKeys = 32 / kKeyLanes;   // keys of a tile/warp
  static constexpr int kTK = kWarps * kWarpKeys;     // keys per tile
  static constexpr int kCols = D / 32;               // P V columns per lane
  static constexpr int kPart = D + 2;                // one head's (m, l, acc)
};

// The float32 instance's dynamic shared memory, in floats: `stages` K/V
// tiles of `tk` keys each (the warps' partials reuse them once every warp
// is done), q of the group, one partial per block of the cluster
// (written by the peers into rank 0's), then a full and an empty
// mbarrier per stage.
template <int D>
struct Layout {
  static constexpr int kPart = Dims<D>::kPart;
  int tk, stages, G, splits;
  __host__ __device__ int q_off() const {
    const int kv = stages * 2 * tk * D, parts = kWarps * G * kPart;
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
template <int D>
__device__ __forceinline__ void load_tile(float* smem, uint64_t* full,
                                          const float* k, const float* v,
                                          int j, int n, int tk, int stages) {
  const int s = j % stages;
  const uint32_t bytes = sizeof(float) * D * min(tk, n - j * tk);
  float* ks = smem + s * 2 * tk * D;
  const size_t off = static_cast<size_t>(j) * tk * D;
  mbar_expect_tx(&full[s], 2 * bytes);
  bulk_load(ks, k + off, bytes, &full[s]);
  bulk_load(ks + tk * D, v + off, bytes, &full[s]);
}

// `N` columns of a V row as floats.
template <int N>
__device__ __forceinline__ void load_cols(const float* p, float (&x)[N]) {
  static_assert(N == 2 || N == 4, "2 or 4 columns per lane");
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

// `N` columns of a row from floats (the counterpart of `load_cols`).
template <int N>
__device__ __forceinline__ void store_cols(float* p, const float (&x)[N]) {
  static_assert(N == 2 || N == 4, "2 or 4 columns per lane");
  if constexpr (N == 2) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
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
// SM with the same numbers).
template <int D, int G>
__global__ void __launch_bounds__(kThreads, D == 64 ? (G <= 4 ? 7 : 4) : 4)
decode_attention_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v,
                        const int* __restrict__ kv_len,
                        float* __restrict__ out, int H, int Hkv, int T,
                        int chunk, int tk, int stages) {
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
  const Layout<D> lay{tk, stages, G, splits};
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
  const size_t kv_base =
      ((static_cast<size_t>(b) * Hkv + kvh) * T + k0) * kD;
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
    mbar_wait(&full[s], parity);
    const float* ks = smem + s * 2 * tk * kD;
    const float* vs = ks + tk * kD;
    if (nw > 0) {
      // Scores: lane (t, part) takes key w0 + t over columns
      // [32 part, 32 part + 32), 4 by 4 in swizzled order.
      const float* krow = ks + (w0 + (valid ? t : 0)) * kD + 32 * part;
      const float* qh = q_s + 32 * part;
      float sc[G];
#pragma unroll
      for (int g = 0; g < G; ++g) sc[g] = 0.f;
#pragma unroll
      for (int c4 = 0; c4 < 8; ++c4) {
        const int c = 4 * (c4 ^ (t & 7));
        const float4 kk = *reinterpret_cast<const float4*>(krow + c);
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
        const float sg = valid ? dot * kScale : -INFINITY;
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
      }
      // P V: lane owns columns kCols lane .. kCols lane + kCols - 1; key
      // i's weight comes from lane i.
      const float* vcol = vs + w0 * kD + kCols * lane;
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

// ---------------------------------------------------------------------------
// The int8 pieces: the G <= 8 instance's tiles, their scale spans and the
// int8-to-float conversion (the group instance takes them too)
// ---------------------------------------------------------------------------

constexpr int kQWarps = 8;
constexpr int kQThreads = 32 * kQWarps;
constexpr int kQStages = 2;
constexpr int kQStageBytes = 32768;  // K and V of a stage, as a float32 one
constexpr int kQPad = 20;            // floats of a 16-column chunk of q
constexpr int kQChunk = 32;          // keys of a warp's chunk of a tile

// The int8 instance's work layout per head dim.
template <int D>
struct QDims {
  static_assert(D == 64 || D == 128, "compiled for head dims 64 and 128");
  static constexpr int kKeyLanes = D / 64;             // lanes per key
  static constexpr int kTK = kQStageBytes / (2 * D);   // keys per tile
  static constexpr int kChunks = D / 16;               // 16-byte row chunks
  static constexpr int kCols = D / 32;                 // P V columns/lane
  static constexpr int kPart = D + 2;                  // one head's partial
};

// The int8 instance's dynamic shared memory, in bytes: `stages` tiles of
// `tk` keys (K, V, then the K and V scale arrays; the warps' partials
// reuse them once every warp is done), q of the group in padded chunks,
// each warp's 32 weights per head, one partial per block of the cluster,
// then a full and an empty mbarrier per stage.
template <int D>
struct QLayout {
  static constexpr int kPart = QDims<D>::kPart;
  int tk, stages, G, splits;
  // A scale array holds the tile's keys at offsets e0 % 4 ..
  // e0 % 4 + tk - 1 (e0: the first key's index in the scale tensor),
  // rounded up to 16 bytes.
  __host__ __device__ constexpr int scale_floats() const {
    return (tk + 6) & ~3;
  }
  __host__ __device__ constexpr int stage_bytes() const {
    return 2 * tk * D + 8 * scale_floats();
  }
  __host__ __device__ int q_off() const {
    const int kv = stages * stage_bytes(),
              parts = 4 * kQWarps * G * kPart;
    return kv > parts ? kv : parts;
  }
  __host__ __device__ int p_off() const {
    return q_off() + 4 * G * QDims<D>::kChunks * kQPad;
  }
  __host__ __device__ int block_off() const {
    return p_off() + 4 * kQWarps * G * kQChunk;
  }
  __host__ __device__ int bar_off() const {
    return (block_off() + 4 * splits * G * kPart + 7) & ~7;
  }
  __host__ __device__ size_t bytes() const { return bar_off() + 16 * stages; }
};

// The 16-byte bounds [lo, hi) of the scale elements that tile j's bulk
// copies bring: from the boundary at or before its first key e0 to the
// one at or after its last, clipped to the last whole 16 bytes of the
// tensor's `numel` floats.
struct ScaleSpan {
  size_t e0, lo, hi;
  __device__ ScaleSpan(size_t e_base, size_t numel, int j, int tk, int nk)
      : e0(e_base + static_cast<size_t>(j) * tk),
        lo(e0 & ~static_cast<size_t>(3)) {
    const size_t end = (e0 + nk + 3) & ~static_cast<size_t>(3),
                 clip = numel & ~static_cast<size_t>(3);
    hi = end < clip ? end : clip;
  }
};

// Tile j of the block's `n` keys into its stage: K and V rows, and the
// scale arrays' aligned span, all on the stage's full barrier.
template <int D>
__device__ __forceinline__ void load_tile_int8(
    unsigned char* smem, const QLayout<D>& lay, uint64_t* full,
    const int8_t* k, const int8_t* v, const float* k_scale,
    const float* v_scale, size_t e_base, size_t numel, int j, int n) {
  const int s = j % lay.stages;
  const int nk = min(lay.tk, n - j * lay.tk);
  const ScaleSpan sp(e_base, numel, j, lay.tk, nk);
  const uint32_t kv_bytes = D * nk;
  const uint32_t sc_bytes = sp.hi > sp.lo ? 4 * (sp.hi - sp.lo) : 0;
  unsigned char* st = smem + s * lay.stage_bytes();
  mbar_expect_tx(&full[s], 2 * (kv_bytes + sc_bytes));
  bulk_load(st, k + sp.e0 * D, kv_bytes, &full[s]);
  bulk_load(st + lay.tk * D, v + sp.e0 * D, kv_bytes, &full[s]);
  if (sc_bytes) {
    unsigned char* sc = st + 2 * lay.tk * D;
    bulk_load(sc, k_scale + sp.lo, sc_bytes, &full[s]);
    bulk_load(sc + 4 * lay.scale_floats(), v_scale + sp.lo, sc_bytes,
              &full[s]);
  }
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

// `N` int8 columns of a V row as floats.
template <int N>
__device__ __forceinline__ void load_cols_int8(const int8_t* p,
                                               float (&x)[N]) {
  static_assert(N == 2 || N == 4, "2 or 4 columns per lane");
  float f[4];
  if constexpr (N == 2) {
    s8x4_to_f32(*reinterpret_cast<const uint16_t*>(p), f);
  } else {
    s8x4_to_f32(*reinterpret_cast<const uint32_t*>(p), f);
  }
#pragma unroll
  for (int c = 0; c < N; ++c) x[c] = f[c];
}

__device__ __forceinline__ float lane_of(const float4& f, int u) {
  return u == 0 ? f.x : u == 1 ? f.y : u == 2 ? f.z : f.w;
}

// ---------------------------------------------------------------------------
// The group instance for a GQA group above 8, float32 and int8 K/V
// ---------------------------------------------------------------------------

constexpr int kGTK = 32;     // keys of a tile
constexpr int kGMaxMT = 3;   // m-tiles of 16 query heads: 48 heads a slot
constexpr int kGQPad = 16;   // floats past D in a q row (distinct banks)
constexpr int kGInt8Stages = 2;  // stages a key slice, int8 K/V

// The key slices of a block (its warps of one m-tile take the tiles j =
// slice (mod slices)): 4 at 3 m-tiles (12 warps, one block an SM under
// its registers) and for int8 K/V, else 2 (float32 K/V: 4 slices of one
// m-tile measured slower, int8 faster, `tools/kernel_variants.py`).
__host__ __device__ constexpr int group_slices(int mt, bool int8) {
  return int8 || mt == 3 ? 4 : 2;
}

template <int D>
struct GDims {
  static_assert(D == 64 || D == 128, "compiled for head dims 64 and 128");
  static constexpr int kP = D / 16;         // 16-dim blocks: 2 k-steps
  static constexpr int kC = D / 32;         // 32-dim blocks of out
  static constexpr int kQStr = D + kGQPad;  // floats of a q row
  static constexpr int kPart = D + 4;       // a head's (m, l, -, -, acc)
};

// Its dynamic shared memory, in bytes: kSt stages a slice, tile j in
// stage j % (slices kSt) (float32: K then V of the tile, as `load_tile`
// fills it; int8: K, V and their scale spans, as `load_tile_int8` fills
// it), over which, once every warp is done with its keys, each warp's
// partials of its 16 heads land and, with more than one split, the
// partials the cluster's blocks push to this one (`splits` slots of the
// heads it merges); q of the slot's 16 MT heads; then a full and an empty
// mbarrier per stage.
template <int D, int MT, typename KV>
struct GLayout {
  using Dm = GDims<D>;
  static constexpr bool kInt8 = sizeof(KV) == 1;
  static constexpr int kS = group_slices(MT, kInt8), kWarps = MT * kS,
                       kG = 16 * MT;
  static constexpr int kSt = kInt8 ? kGInt8Stages : 1;
  static constexpr int kStages = kS * kSt;
  static constexpr int kStageBytes =
      kInt8 ? QLayout<D>{kGTK, kStages, 0, 1}.stage_bytes()
            : static_cast<int>(sizeof(float)) * 2 * kGTK * D;
  static constexpr int kWpart = 4 * kWarps * 16 * Dm::kPart;
  static constexpr int kRecv = 4 * (kG + kMaxSplits) * Dm::kPart;
  static constexpr int kArea = kStages * kStageBytes > kWpart + kRecv
                                   ? kStages * kStageBytes
                                   : kWpart + kRecv;
  static constexpr int kBar = (kArea + 4 * kG * Dm::kQStr + 7) & ~7;
  static constexpr size_t kBytes =
      static_cast<size_t>(kBar) + 2 * sizeof(uint64_t) * kStages;
};

// x = hi + lo: hi = x rounded to TF32 (nearest, ties away from zero, as
// cvt.rna.tf32.f32, in two integer operations), lo = x - hi exact and
// handed to the tensor cores unrounded (they read its top 19 bits).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += a b, one m16n8k8 TF32 product (float32 accumulate).
__device__ __forceinline__ void mma_tf32(float (&c)[4], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// The A fragments of q's rows g (qa) and g + 8 (qb) for two k-steps (k
// indices t, t + 4 of the first at .x, .y; of the second at .z, .w),
// split hi + lo.
__device__ __forceinline__ void split_q(const float4& qa, const float4& qb,
                                        uint32_t (&ah)[8],
                                        uint32_t (&al)[8]) {
  split_tf32(qa.x, ah[0], al[0]);
  split_tf32(qb.x, ah[1], al[1]);
  split_tf32(qa.y, ah[2], al[2]);
  split_tf32(qb.y, ah[3], al[3]);
  split_tf32(qa.z, ah[4], al[4]);
  split_tf32(qb.z, ah[5], al[5]);
  split_tf32(qa.w, ah[6], al[6]);
  split_tf32(qb.w, ah[7], al[7]);
}

// S = q K^T of a tile of float32 K: k-step 2p takes dims 16 p + 4 t (k
// index t) and + 1 (t + 4), k-step 2p + 1 the next two, so each lane's q
// and K fragments of two k-steps are one 16-byte load; 3 TF32 products a
// product (lo hi and hi lo into sx, hi hi into sc).  Keys past the tile
// read its last row.
template <int D>
__device__ __forceinline__ void group_scores(const float* kst,
                                             const float* qa_row,
                                             const float* qb_row, int g,
                                             int t, int nk,
                                             float (&sc)[4][4],
                                             float (&sx)[4][4]) {
#pragma unroll
  for (int p = 0; p < GDims<D>::kP; ++p) {
    const float4 qa =
        *reinterpret_cast<const float4*>(qa_row + 16 * p + 4 * t);
    const float4 qb =
        *reinterpret_cast<const float4*>(qb_row + 16 * p + 4 * t);
    uint32_t ah[8], al[8];
    split_q(qa, qb, ah, al);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int r = min(8 * nt + g, nk - 1);
      const float4 kk = *reinterpret_cast<const float4*>(
          kst + r * D + 16 * p + 4 * t);
      uint32_t bh[4], bl[4];
      split_tf32(kk.x, bh[0], bl[0]);
      split_tf32(kk.y, bh[1], bl[1]);
      split_tf32(kk.z, bh[2], bl[2]);
      split_tf32(kk.w, bh[3], bl[3]);
      mma_tf32(sx[nt], al[0], al[1], al[2], al[3], bh[0], bh[1]);
      mma_tf32(sx[nt], ah[0], ah[1], ah[2], ah[3], bl[0], bl[1]);
      mma_tf32(sc[nt], ah[0], ah[1], ah[2], ah[3], bh[0], bh[1]);
      mma_tf32(sx[nt], al[4], al[5], al[6], al[7], bh[2], bh[3]);
      mma_tf32(sx[nt], ah[4], ah[5], ah[6], ah[7], bl[2], bl[3]);
      mma_tf32(sc[nt], ah[4], ah[5], ah[6], ah[7], bh[2], bh[3]);
    }
  }
}

// S = q K8^T of a tile of int8 K, whose values are exact in TF32: 2 TF32
// products a product (q lo K8 into sx, q hi K8 into sc).  One 16-byte
// load of a lane's K row, bytes [64 P + 16 t, + 16) of 64-dim block P,
// feeds 8 k-steps: its word c gives k-step 2 (4 P + c) dims 64 P + 16 t
// + 4 c (k index t) and + 1 (t + 4), k-step 2 (4 P + c) + 1 the next two.
// q's float4 of the same dims is its row's 16-byte chunk 16 P + 4 t + c,
// stored at 16 P + 4 t + (c ^ t) so that a quarter-warp's loads hit 8
// distinct bank groups.  Keys past the tile read its last row.
template <int D>
__device__ __forceinline__ void group_scores(const int8_t* kst,
                                             const float* qa_row,
                                             const float* qb_row, int g,
                                             int t, int nk,
                                             float (&sc)[4][4],
                                             float (&sx)[4][4]) {
#pragma unroll
  for (int P = 0; P < D / 64; ++P) {
    int4 kw[4];
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int r = min(8 * nt + g, nk - 1);
      kw[nt] = *reinterpret_cast<const int4*>(kst + r * D + 64 * P + 16 * t);
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int at = 4 * (16 * P + 4 * t + (c ^ t));
      uint32_t ah[8], al[8];
      split_q(*reinterpret_cast<const float4*>(qa_row + at),
              *reinterpret_cast<const float4*>(qb_row + at), ah, al);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int w = c == 0 ? kw[nt].x : c == 1 ? kw[nt].y
                      : c == 2 ? kw[nt].z : kw[nt].w;
        float kf[4];
        s8x4_to_f32(static_cast<uint32_t>(w), kf);
        const uint32_t b0 = __float_as_uint(kf[0]),
                       b1 = __float_as_uint(kf[1]),
                       b2 = __float_as_uint(kf[2]),
                       b3 = __float_as_uint(kf[3]);
        mma_tf32(sx[nt], al[0], al[1], al[2], al[3], b0, b1);
        mma_tf32(sc[nt], ah[0], ah[1], ah[2], ah[3], b0, b1);
        mma_tf32(sx[nt], al[4], al[5], al[6], al[7], b2, b3);
        mma_tf32(sc[nt], ah[4], ah[5], ah[6], ah[7], b2, b3);
      }
    }
  }
}

// out = out alpha + P V of a tile of float32 V, per 32-dim block c: the
// tile's products in fresh accumulators (the tensor cores' float32 sums
// truncate, so no chain of them runs past one tile), added to out by one
// rounded FMA each.  K-step nt: S's accumulator is P's A fragment as is
// (k index t: key 8 nt + 2 t; t + 4: key 8 nt + 2 t + 1); V's B fragments
// of n-tiles (c, 0..3), one 16-byte load a key; 3 TF32 products a
// product.  A key past the tile has weight 0 and reads its last row.
template <int D>
__device__ __forceinline__ void group_pv(const float* vst, int g, int t,
                                         int nk, const float (&p)[4][4],
                                         float al0, float al1,
                                         float (&acc)[D / 32][4][4]) {
#pragma unroll
  for (int c = 0; c < GDims<D>::kC; ++c) {
    float pv[4][4];
#pragma unroll
    for (int j4 = 0; j4 < 4; ++j4) {
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[j4][e] = 0.f;
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      uint32_t ph[4], pl[4];
      split_tf32(p[nt][0], ph[0], pl[0]);
      split_tf32(p[nt][2], ph[1], pl[1]);
      split_tf32(p[nt][1], ph[2], pl[2]);
      split_tf32(p[nt][3], ph[3], pl[3]);
      const float4 va = *reinterpret_cast<const float4*>(
          vst + min(8 * nt + 2 * t, nk - 1) * D + 32 * c + 4 * g);
      const float4 vb = *reinterpret_cast<const float4*>(
          vst + min(8 * nt + 2 * t + 1, nk - 1) * D + 32 * c + 4 * g);
      const float xa[4] = {va.x, va.y, va.z, va.w};
      const float xb[4] = {vb.x, vb.y, vb.z, vb.w};
#pragma unroll
      for (int j4 = 0; j4 < 4; ++j4) {
        uint32_t h0, lo0, h1, lo1;
        split_tf32(xa[j4], h0, lo0);
        split_tf32(xb[j4], h1, lo1);
        mma_tf32(pv[j4], pl[0], pl[1], pl[2], pl[3], h0, h1);
        mma_tf32(pv[j4], ph[0], ph[1], ph[2], ph[3], lo0, lo1);
        mma_tf32(pv[j4], ph[0], ph[1], ph[2], ph[3], h0, h1);
      }
    }
#pragma unroll
    for (int j4 = 0; j4 < 4; ++j4) {
      acc[c][j4][0] = fmaf(acc[c][j4][0], al0, pv[j4][0]);
      acc[c][j4][1] = fmaf(acc[c][j4][1], al0, pv[j4][1]);
      acc[c][j4][2] = fmaf(acc[c][j4][2], al1, pv[j4][2]);
      acc[c][j4][3] = fmaf(acc[c][j4][3], al1, pv[j4][3]);
    }
  }
}

// The same over a tile of int8 V, exact in TF32: each weight times its
// key's V scale (vmul[nt][i]: key 8 nt + 2 t + i), split hi + lo once a
// tile, 2 TF32 products a product (p lo V8, p hi V8); V's B fragments of
// n-tiles (c, 0..3) are one 4-byte word a key.
template <int D>
__device__ __forceinline__ void group_pv(const int8_t* vst, int g, int t,
                                         int nk, const float (&p)[4][4],
                                         const float (&vmul)[4][2],
                                         float al0, float al1,
                                         float (&acc)[D / 32][4][4]) {
  uint32_t ph[4][4], pl[4][4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    split_tf32(p[nt][0] * vmul[nt][0], ph[nt][0], pl[nt][0]);
    split_tf32(p[nt][2] * vmul[nt][0], ph[nt][1], pl[nt][1]);
    split_tf32(p[nt][1] * vmul[nt][1], ph[nt][2], pl[nt][2]);
    split_tf32(p[nt][3] * vmul[nt][1], ph[nt][3], pl[nt][3]);
  }
#pragma unroll
  for (int c = 0; c < GDims<D>::kC; ++c) {
    float pv[4][4];
#pragma unroll
    for (int j4 = 0; j4 < 4; ++j4) {
#pragma unroll
      for (int e = 0; e < 4; ++e) pv[j4][e] = 0.f;
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      float xa[4], xb[4];
      s8x4_to_f32(*reinterpret_cast<const uint32_t*>(
                      vst + min(8 * nt + 2 * t, nk - 1) * D + 32 * c + 4 * g),
                  xa);
      s8x4_to_f32(
          *reinterpret_cast<const uint32_t*>(
              vst + min(8 * nt + 2 * t + 1, nk - 1) * D + 32 * c + 4 * g),
          xb);
#pragma unroll
      for (int j4 = 0; j4 < 4; ++j4) {
        const uint32_t b0 = __float_as_uint(xa[j4]),
                       b1 = __float_as_uint(xb[j4]);
        mma_tf32(pv[j4], pl[nt][0], pl[nt][1], pl[nt][2], pl[nt][3], b0,
                 b1);
        mma_tf32(pv[j4], ph[nt][0], ph[nt][1], ph[nt][2], ph[nt][3], b0,
                 b1);
      }
    }
#pragma unroll
    for (int j4 = 0; j4 < 4; ++j4) {
      acc[c][j4][0] = fmaf(acc[c][j4][0], al0, pv[j4][0]);
      acc[c][j4][1] = fmaf(acc[c][j4][1], al0, pv[j4][1]);
      acc[c][j4][2] = fmaf(acc[c][j4][2], al1, pv[j4][2]);
      acc[c][j4][3] = fmaf(acc[c][j4][3], al1, pv[j4][3]);
    }
  }
}

// MT m-tiles of 16 query heads, group_slices(MT, int8) key slices; warp w
// takes m-tile w / slices against the tiles of slice w % slices.  The
// grid's y runs over Hkv x `slots` head slots: slot y holds query heads [sl Gs,
// sl Gs + Gs) of KV head y / slots (sl = y % slots), Gs = ceil(G /
// slots) at most 16 MT (each slot reads the K/V row).  Lane (g, t) =
// (lane / 4, lane % 4) holds the mma fragments: scores S = q K^T of heads
// 16 mt + g (+ 8) against keys 8 nt + 2 t (+ 1) of the tile, out of the
// same heads at dims 32 c + 8 t + j4 (+ 4).  KV is float or int8_t: int8
// K/V come with their per-key float32 scales (k_scale, v_scale: (B, Hkv,
// T), the K scale folded into the score, the V scale into the weight);
// float32 passes none.  `kFloor` keeps the grid, q, the copies, the
// barriers and the merges and drops the arithmetic: the floor of this
// design, for measurement only (its output is zero, not a decode).
template <int D, int MT, typename KV, bool kFloor>
__global__ void __launch_bounds__(32 * MT *
                                  group_slices(MT, sizeof(KV) == 1), 1)
decode_attention_group_kernel(const float* __restrict__ q,
                              const KV* __restrict__ k,
                              const KV* __restrict__ v,
                              const float* __restrict__ k_scale,
                              const float* __restrict__ v_scale,
                              const int* __restrict__ kv_len,
                              float* __restrict__ out, int H, int Hkv, int T,
                              int chunk) {
  using Dm = GDims<D>;
  using L = GLayout<D, MT, KV>;
  constexpr bool kInt8 = L::kInt8;
  constexpr int kS = L::kS, kNS = L::kStages, kThr = 32 * L::kWarps;
  constexpr int kPart = Dm::kPart;
  constexpr float kScale = D == 64 ? 0.125f : 0.08838834764831845f;
  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x;  // the block's rank in its cluster
  const int splits = gridDim.x;
  const int slots = gridDim.y / Hkv, kvh = blockIdx.y / slots;
  const int b = blockIdx.z, G = H / Hkv, Gs = (G + slots - 1) / slots;
  const int g_first = (blockIdx.y % slots) * Gs, gb = min(Gs, G - g_first);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t = lane & 3, mt = warp / kS, ks = warp % kS;
  extern __shared__ __align__(16) unsigned char gsmem[];
  float* parts = reinterpret_cast<float*>(gsmem);
  float* qs = reinterpret_cast<float*>(gsmem + L::kArea);
  uint64_t* full = reinterpret_cast<uint64_t*>(gsmem + L::kBar);
  uint64_t* empty = full + kNS;

  // This block's live keys: [k0, k0 + n) of the row; e_base is k0's
  // index in the (B, Hkv, T) keys (and scales) of `numel`.
  const int len = max(0, min(kv_len[b], T));
  const long long first = static_cast<long long>(split) * chunk;
  const int k0 = first < len ? static_cast<int>(first) : len;
  const int n = min(chunk, len - k0);
  const int n_tiles = (n + kGTK - 1) / kGTK;
  const size_t e_base = (static_cast<size_t>(b) * Hkv + kvh) * T + k0;
  const size_t numel = static_cast<size_t>(gridDim.z) * Hkv * T;
  const size_t q_base =
      (static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G + g_first) *
      D;
  // Tile j of the block's keys into its stage, j % kNS.
  const auto load = [&](int j) {
    if constexpr (kInt8) {
      load_tile_int8<D>(gsmem, QLayout<D>{kGTK, kNS, 0, 1}, full, k, v,
                        k_scale, v_scale, e_base, numel, j, n);
    } else {
      load_tile<D>(parts, full, k + e_base * D, v + e_base * D, j, n, kGTK,
                   kNS);
    }
  };
  // Thread 0 starts the first tile of every stage before q is loaded.
  if (tid == 0) {
    for (int s = 0; s < kNS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], MT);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int j = 0; j < min(n_tiles, kNS); ++j) load(j);
  }
  // q of the slot's heads, rows past gb zero, every load in flight before
  // the stores; for int8 K/V each row's 16-byte chunk i at i ^ ((i >> 2)
  // & 3) (see group_scores).
  {
    constexpr int kQ4 = L::kG * D / 4, kPer = (kQ4 + kThr - 1) / kThr;
    const float4* q4 = reinterpret_cast<const float4*>(q + q_base);
    float4 qv[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = tid + u * kThr;
      qv[u] = i < kQ4 && i / (D / 4) < gb ? __ldg(q4 + i)
                                          : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = tid + u * kThr, c4 = i % (D / 4);
      if (i < kQ4) {
        reinterpret_cast<float4*>(qs + (i / (D / 4)) * Dm::kQStr)
            [kInt8 ? c4 ^ ((c4 >> 2) & 3) : c4] = qv[u];
      }
    }
  }
  __syncthreads();  // the barriers' initialisation, q

  // Rows g and g + 8 of the m-tile: the online softmax (m; l per lane
  // until the end) and out's accumulators, acc[c][j4] = the fragment of
  // dims 32 c + 4 n + j4 (n = 2 t, 2 t + 1).
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
  float acc[Dm::kC][4][4];
#pragma unroll
  for (int c = 0; c < Dm::kC; ++c) {
#pragma unroll
    for (int j4 = 0; j4 < 4; ++j4) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][j4][e] = 0.f;
    }
  }
  const float* qa_row = qs + (16 * mt + g) * Dm::kQStr;
  const float* qb_row = qa_row + 8 * Dm::kQStr;
  for (int j = ks; j < n_tiles; j += kS) {
    const int s = j % kNS;
    const uint32_t parity = (j / kNS) & 1;
    const int nk = min(kGTK, n - j * kGTK);
    const KV* kst = reinterpret_cast<const KV*>(gsmem + s * L::kStageBytes);
    const KV* vst = kst + kGTK * D;
    mbar_wait(&full[s], parity);
    if constexpr (!kFloor) {
      float sc[4][4], sx[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[nt][e] = sx[nt][e] = 0.f;
      }
      group_scores<D>(kst, qa_row, qb_row, g, t, nk, sc, sx);
      // int8: the scales of the lane's keys 8 nt + 2 t + i (a key past
      // the tile takes its last key's), the K scale times 1 / sqrt(D).
      float kmul[4][2], vmul[4][2];
      if constexpr (kInt8) {
        const ScaleSpan sp(e_base, numel, j, kGTK, nk);
        const float* kss =
            reinterpret_cast<const float*>(kst + 2 * kGTK * D) + (sp.e0 & 3);
        const float* vss = kss + QLayout<D>{kGTK, kNS, 0, 1}.scale_floats();
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int key = min(8 * nt + 2 * t + i, nk - 1);
            const size_t e = sp.e0 + key;
            kmul[nt][i] = (e < sp.hi ? kss[key] : __ldg(k_scale + e)) * kScale;
            vmul[nt][i] = e < sp.hi ? vss[key] : __ldg(v_scale + e);
          }
        }
      }
      // Masked scores, the tile's max per row (the lane's 8 keys, then
      // the row's 4 lanes), the online softmax.
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int key = 8 * nt + 2 * t;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[nt][e] = key + (e & 1) < nk
                          ? (sc[nt][e] + sx[nt][e]) *
                                (kInt8 ? kmul[nt][e & 1] : kScale)
                          : -INFINITY;
        }
        mx0 = fmaxf(mx0, fmaxf(sc[nt][0], sc[nt][1]));
        mx1 = fmaxf(mx1, fmaxf(sc[nt][2], sc[nt][3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      const float ms0 = isfinite(mn0) ? mn0 : 0.f;
      const float ms1 = isfinite(mn1) ? mn1 : 0.f;
      const float al0 = isfinite(m0) ? expf(m0 - ms0) : 0.f;
      const float al1 = isfinite(m1) ? expf(m1 - ms1) : 0.f;
      m0 = mn0;
      m1 = mn1;
      l0 *= al0;
      l1 *= al1;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        sc[nt][0] = expf(sc[nt][0] - ms0);
        sc[nt][1] = expf(sc[nt][1] - ms0);
        sc[nt][2] = expf(sc[nt][2] - ms1);
        sc[nt][3] = expf(sc[nt][3] - ms1);
        l0 += sc[nt][0] + sc[nt][1];
        l1 += sc[nt][2] + sc[nt][3];
      }
      if constexpr (kInt8) {
        group_pv<D>(vst, g, t, nk, sc, vmul, al0, al1, acc);
      } else {
        group_pv<D>(vst, g, t, nk, sc, al0, al1, acc);
      }
    }
    // The stage is free once the slice's MT warps are done with it; warp
    // (0, slice) then refills it with the tile kNS on.
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (mt == 0 && lane == 0 && j + kNS < n_tiles) {
      mbar_wait(&empty[s], parity);
      load(j + kNS);
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  __syncthreads();  // every warp is done with the stages
  // The warp's partials of its 16 heads, over the stages.
  float* wp = parts + warp * 16 * kPart;
  if (t == 0) {
    wp[g * kPart] = m0;
    wp[g * kPart + 1] = l0;
    wp[(g + 8) * kPart] = m1;
    wp[(g + 8) * kPart + 1] = l1;
  }
#pragma unroll
  for (int c = 0; c < Dm::kC; ++c) {
    float* ra = wp + g * kPart + 4 + 32 * c + 8 * t;
    float* rb = ra + 8 * kPart;
    *reinterpret_cast<float4*>(ra) = make_float4(
        acc[c][0][0], acc[c][1][0], acc[c][2][0], acc[c][3][0]);
    *reinterpret_cast<float4*>(ra + 4) = make_float4(
        acc[c][0][1], acc[c][1][1], acc[c][2][1], acc[c][3][1]);
    *reinterpret_cast<float4*>(rb) = make_float4(
        acc[c][0][2], acc[c][1][2], acc[c][2][2], acc[c][3][2]);
    *reinterpret_cast<float4*>(rb + 4) = make_float4(
        acc[c][0][3], acc[c][1][3], acc[c][2][3], acc[c][3][3]);
  }
  __syncthreads();
  // The slices merge per head; with one split that is the output.  With
  // more, rank r merges heads [r hpr, (r + 1) hpr): once every block of
  // the cluster is done with its keys (its stages free: one cluster
  // barrier), each block pushes its heads' partials into their rank's
  // shared memory, beside the warps' partials, in this block's slot, and
  // after a second barrier each rank merges its own.
  const int hpr = (gb + splits - 1) / splits;
  float* recv = parts + L::kWpart / 4;
  if (splits > 1) {
    cluster_arrive();
    cluster_wait();
  }
  // Four dims a thread: the weights once per head and four columns.
  float* orow = out + q_base;
  for (int i = tid; i < gb * D / 4; i += kThr) {
    const int hh = i / (D / 4), d = 4 * (i % (D / 4));
    const float* p0 = parts + ((hh / 16) * kS * 16 + hh % 16) * kPart;
    float mx = -INFINITY;
#pragma unroll
    for (int s2 = 0; s2 < kS; ++s2) mx = fmaxf(mx, p0[s2 * 16 * kPart]);
    const float m_safe = isfinite(mx) ? mx : 0.f;
    float den = 0.f;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int s2 = 0; s2 < kS; ++s2) {
      const float* pr = p0 + s2 * 16 * kPart;
      const float w = isfinite(pr[0]) ? expf(pr[0] - m_safe) : 0.f;
      const float4 a = *reinterpret_cast<const float4*>(pr + 4 + d);
      den = fmaf(w, pr[1], den);
      num = make_float4(fmaf(w, a.x, num.x), fmaf(w, a.y, num.y),
                        fmaf(w, a.z, num.z), fmaf(w, a.w, num.w));
    }
    if (splits == 1) {
      const float dd = fmaxf(den, 1e-30f);
      *reinterpret_cast<float4*>(orow + hh * D + d) = make_float4(
          num.x / dd, num.y / dd, num.z / dd, num.w / dd);
    } else {
      const int owner = hh / hpr;
      float* dst = cluster.map_shared_rank(recv, owner) +
                   (split * hpr + hh - owner * hpr) * kPart;
      *reinterpret_cast<float4*>(dst + 4 + d) = num;
      if (d == 0) {
        dst[0] = mx;
        dst[1] = den;
      }
    }
  }
  if (splits == 1) return;
  cluster_arrive();
  cluster_wait();
  const int g0 = split * hpr, ng = min(hpr, gb - g0);
  for (int i = tid; i < ng * D / 4; i += kThr) {
    const int gg = i / (D / 4), d = 4 * (i % (D / 4));
    float mx = -INFINITY;
    for (int r = 0; r < splits; ++r) {
      mx = fmaxf(mx, recv[(r * hpr + gg) * kPart]);
    }
    const float m_safe = isfinite(mx) ? mx : 0.f;
    float den = 0.f;
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int r = 0; r < splits; ++r) {
      const float* pr = recv + (r * hpr + gg) * kPart;
      const float w = isfinite(pr[0]) ? expf(pr[0] - m_safe) : 0.f;
      const float4 a = *reinterpret_cast<const float4*>(pr + 4 + d);
      den = fmaf(w, pr[1], den);
      num = make_float4(fmaf(w, a.x, num.x), fmaf(w, a.y, num.y),
                        fmaf(w, a.z, num.z), fmaf(w, a.w, num.w));
    }
    const float dd = fmaxf(den, 1e-30f);
    *reinterpret_cast<float4*>(orow + (g0 + gg) * D + d) = make_float4(
        num.x / dd, num.y / dd, num.z / dd, num.w / dd);
  }
}

// ---------------------------------------------------------------------------
// The int8 instance, G <= 8
// ---------------------------------------------------------------------------

// Eight warps: the register cap of 128 allows two blocks of 256 threads
// per SM (`ops.py::decode_split_plan` counts blocks per SM with it).
template <int D, int G>
__global__ void __launch_bounds__(kQThreads, 2)
decode_attention_kernel_int8(const float* __restrict__ q,
                             const int8_t* __restrict__ k,
                             const int8_t* __restrict__ v,
                             const float* __restrict__ k_scale,
                             const float* __restrict__ v_scale,
                             const int* __restrict__ kv_len,
                             float* __restrict__ out, int H, int Hkv, int T,
                             int chunk, int tk, int stages) {
  using QD = QDims<D>;
  constexpr int kKL = QD::kKeyLanes;   // lanes per key
  constexpr int kKeys = 32 / kKL;      // keys a warp scores per pass
  constexpr int kPass = kKL;           // passes per chunk
  constexpr int kCK = kQChunk;
  constexpr int kNC = QD::kChunks, kCols = QD::kCols, kPart = QD::kPart;
  constexpr float kScale = D == 64 ? 0.125f : 0.08838834764831845f;
  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x;  // the block's rank in its cluster
  const int splits = gridDim.x;
  // As in the float32 instance: the first phase is arrived at now and
  // waited on after the keys.  One split needs no cluster barrier.
  if (splits > 1) cluster_arrive_relaxed();
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  extern __shared__ __align__(16) unsigned char qsmem[];
  const QLayout<D> lay{tk, stages, G, splits};
  float* q_s = reinterpret_cast<float*>(qsmem + lay.q_off());
  float* pw =
      reinterpret_cast<float*>(qsmem + lay.p_off()) + warp * G * kCK;
  float* wpart = reinterpret_cast<float*>(qsmem);
  float* bpart = reinterpret_cast<float*>(qsmem + lay.block_off());
  uint64_t* full = reinterpret_cast<uint64_t*>(qsmem + lay.bar_off());
  uint64_t* empty = full + stages;

  // This block's live keys: [k0, k0 + n) of the row; e_base is k0's
  // index in the (B, Hkv, T) scale tensor of `numel` floats.
  const int len = max(0, min(kv_len[b], T));
  const long long first = static_cast<long long>(split) * chunk;
  const int k0 = first < len ? static_cast<int>(first) : len;
  const int n = min(chunk, len - k0);
  const int n_tiles = (n + tk - 1) / tk;
  const size_t e_base = (static_cast<size_t>(b) * Hkv + kvh) * T + k0;
  const size_t numel = static_cast<size_t>(gridDim.z) * Hkv * T;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kQWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int j = 0; j < min(stages, n_tiles); ++j) {
      load_tile_int8<D>(qsmem, lay, full, k, v, k_scale, v_scale, e_base,
                        numel, j, n);
    }
  }
  // q of the group in 16-column chunks, each padded to kQPad floats: the
  // lanes of a quarter-warp read chunks r = 0..3 (at D = 128, 4 h + r)
  // at 80 r bytes, 8 distinct bank groups.
  const float4* qb = reinterpret_cast<const float4*>(
      q + (static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G) * D);
  for (int i = tid; i < G * D / 4; i += kQThreads) {
    const int g = i / (D / 4), c4 = i % (D / 4);
    reinterpret_cast<float4*>(q_s + (g * kNC + c4 / 4) * kQPad)[c4 % 4] =
        __ldg(qb + i);
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
  // Lane `lane` scores keys lane / kKL + i kKeys of a chunk (pass i)
  // over columns [64 half, 64 half + 64), its 16-byte chunks rotated by
  // the key.
  const int half = lane % kKL, rot = lane >> 1;
  const float* qh = q_s + 4 * half * kQPad;
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % stages;
    const uint32_t parity = (j / stages) & 1;
    const int nk = min(tk, n - j * tk);
    const ScaleSpan sp(e_base, numel, j, tk, nk);
    const unsigned char* st = qsmem + s * lay.stage_bytes();
    const int8_t* ks = reinterpret_cast<const int8_t*>(st);
    const int8_t* vs = ks + tk * D;
    const float* kss =
        reinterpret_cast<const float*>(st + 2 * tk * D) + (sp.e0 & 3);
    const float* vss = kss + lay.scale_floats();
    mbar_wait(&full[s], parity);
    // The warps take the tile's chunks of kCK keys in turn.
    for (int c0 = kCK * warp; c0 < nk; c0 += kCK * kQWarps) {
      const int nc = min(kCK, nk - c0);
      // Pass i scores key lane / kKL + i * kKeys of the chunk.
      int t[kPass];
      bool valid[kPass];
#pragma unroll
      for (int i = 0; i < kPass; ++i) {
        const int kk = lane / kKL + i * kKeys;
        valid[i] = kk < nc;
        t[i] = c0 + (valid[i] ? kk : 0);
      }
      // Two partial sums per (head, key): half-length FMA chains.
      float dot[G][kPass][2];
#pragma unroll
      for (int g = 0; g < G; ++g) {
#pragma unroll
        for (int i = 0; i < kPass; ++i) dot[g][i][0] = dot[g][i][1] = 0.f;
      }
      // Each q float4 serves the lane's keys of every pass.
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int r = (jj + rot) & 3;
        float kf[kPass][16];
#pragma unroll
        for (int i = 0; i < kPass; ++i) {
          const int4 w = *reinterpret_cast<const int4*>(
              ks + t[i] * D + 64 * half + 16 * r);
          s8x4_to_f32(static_cast<uint32_t>(w.x), kf[i]);
          s8x4_to_f32(static_cast<uint32_t>(w.y), kf[i] + 4);
          s8x4_to_f32(static_cast<uint32_t>(w.z), kf[i] + 8);
          s8x4_to_f32(static_cast<uint32_t>(w.w), kf[i] + 12);
        }
        const float* qc = qh + r * kQPad;
#pragma unroll
        for (int g = 0; g < G; ++g) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4 qq = *reinterpret_cast<const float4*>(
                qc + g * kNC * kQPad + 4 * e);
#pragma unroll
            for (int i = 0; i < kPass; ++i) {
              float& dp = dot[g][i][e & 1];
              dp = fmaf(qq.x, kf[i][4 * e], dp);
              dp = fmaf(qq.y, kf[i][4 * e + 1], dp);
              dp = fmaf(qq.z, kf[i][4 * e + 2], dp);
              dp = fmaf(qq.w, kf[i][4 * e + 3], dp);
            }
          }
        }
      }
      float sc[G][kPass], vmul[kPass];
#pragma unroll
      for (int i = 0; i < kPass; ++i) {
        const size_t e = sp.e0 + t[i];
        float kmul, vm;
        if (e < sp.hi) {
          kmul = kss[t[i]];
          vm = vss[t[i]];
        } else {
          kmul = __ldg(k_scale + e);
          vm = __ldg(v_scale + e);
        }
        kmul *= kScale;
        vmul[i] = vm;
#pragma unroll
        for (int g = 0; g < G; ++g) {
          float d = dot[g][i][0] + dot[g][i][1];
          // Every lane shuffles, then the lanes past the chunk's keys
          // drop out as -inf.
          if constexpr (kKL == 2) d += __shfl_xor_sync(0xffffffffu, d, 1);
          sc[g][i] = valid[i] ? d * kmul : -INFINITY;
        }
      }
      // Per head, one max tree over the chunk (the lanes of a pair hold
      // the same scores); each lane keeps the sum of its own keys'
      // weights (at D = 128 the passes of its half), and writes the
      // weight times the V scale for P V.
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float mx = sc[g][0];
#pragma unroll
        for (int i = 1; i < kPass; ++i) mx = fmaxf(mx, sc[g][i]);
#pragma unroll
        for (int off = kKL; off < 32; off <<= 1) {
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
        }
        const float m_new = fmaxf(m[g], mx);
        const float m_safe = isfinite(m_new) ? m_new : 0.f;
        const float alpha = isfinite(m[g]) ? expf(m[g] - m_safe) : 0.f;
        float so = sc[g][0], vo = vmul[0];
        if constexpr (kKL == 2) {
          so = half ? sc[g][1] : so;
          vo = half ? vmul[1] : vo;
        }
        const float p = expf(so - m_safe);  // 0 for a key past the chunk
        pw[g * kCK + lane / kKL + half * kKeys] = p * vo;
        l[g] = l[g] * alpha + p;
        m[g] = m_new;
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[g][c] *= alpha;
      }
      __syncwarp();
      // P V: lane owns columns kCols lane .. kCols lane + kCols - 1; the
      // weights of four keys come as one broadcast float4 per head.  No
      // branch: a key past the chunk has weight 0 and reads the chunk's
      // last row, so each step's loads issue together.
      const int8_t* vcol = vs + c0 * D + kCols * lane;
#pragma unroll 2
      for (int i4 = 0; i4 < nc; i4 += 4) {
        float4 pp[G];
#pragma unroll
        for (int g = 0; g < G; ++g) {
          pp[g] = *reinterpret_cast<const float4*>(pw + g * kCK + i4);
        }
        float vv[4][kCols];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          load_cols_int8<kCols>(vcol + min(i4 + u, nc - 1) * D, vv[u]);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int g = 0; g < G; ++g) {
            const float pg = lane_of(pp[g], u);
#pragma unroll
            for (int c = 0; c < kCols; ++c) {
              acc[g][c] = fmaf(pg, vv[u][c], acc[g][c]);
            }
          }
        }
      }
      __syncwarp();  // the weights are rewritten by the next chunk
    }
    // The stage is free once every warp is done with it; thread 0 then
    // refills it with tile j + stages.
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (tid == 0 && j + stages < n_tiles) {
      mbar_wait(&empty[s], parity);
      load_tile_int8<D>(qsmem, lay, full, k, v, k_scale, v_scale, e_base,
                        numel, j + stages, n);
    }
  }
  // The warp's sums: each lane summed its own keys' weights.
#pragma unroll
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      l[g] += __shfl_xor_sync(0xffffffffu, l[g], off);
    }
  }

  // The warps' partials (over the stages, once every warp is done with
  // them), then the block's.
  __syncthreads();
  float* wp = wpart + warp * G * kPart;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      wp[g * kPart] = m[g];
      wp[g * kPart + 1] = l[g];
    }
#pragma unroll
    for (int c = 0; c < kCols; c += 2) {
      *reinterpret_cast<float2*>(wp + g * kPart + 2 + kCols * lane + c) =
          make_float2(acc[g][c], acc[g][c + 1]);
    }
  }
  __syncthreads();
  float* orow =
      out + (static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G) * D;
  float* rpart = bpart;
  if (splits > 1) {
    cluster_wait();
    rpart = cluster.map_shared_rank(bpart, 0) + split * G * kPart;
  }
  for (int i = tid; i < G * D; i += kQThreads) {
    const int g = i / D, d = i % D;
    float mw[kQWarps];
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kQWarps; ++w) {
      mw[w] = wpart[(w * G + g) * kPart];
      mx = fmaxf(mx, mw[w]);
    }
    const float m_safe = isfinite(mx) ? mx : 0.f;
    float ls = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kQWarps; ++w) {
      const float sw = isfinite(mw[w]) ? expf(mw[w] - m_safe) : 0.f;
      ls = fmaf(sw, wpart[(w * G + g) * kPart + 1], ls);
      a = fmaf(sw, wpart[(w * G + g) * kPart + 2 + d], a);
    }
    if (splits == 1) {
      orow[i] = a / fmaxf(ls, 1e-30f);
    } else {
      rpart[g * kPart + 2 + d] = a;
      if (d == 0) {
        rpart[g * kPart] = mx;
        rpart[g * kPart + 1] = ls;
      }
    }
  }
  if (splits == 1) return;

  // Rank 0 merges the `splits` published partials; the peers exit.
  cluster_arrive();
  cluster_wait();
  if (split == 0) {
    for (int i = tid; i < G * D; i += kQThreads) {
      const int g = i / D, d = i % D;
      float mx = -INFINITY;
      for (int r = 0; r < splits; ++r) {
        mx = fmaxf(mx, bpart[(r * G + g) * kPart]);
      }
      const float m_safe = isfinite(mx) ? mx : 0.f;
      float den = 0.f, num = 0.f;
      for (int r = 0; r < splits; ++r) {
        const float* pr = bpart + (r * G + g) * kPart;
        const float sr = isfinite(pr[0]) ? expf(pr[0] - m_safe) : 0.f;
        den = fmaf(sr, pr[1], den);
        num = fmaf(sr, pr[2 + d], num);
      }
      orow[i] = num / fmaxf(den, 1e-30f);
    }
  }
}

// The floor of the int8 design: its grid, clusters, shared memory and
// data movement (q, each tile's K, V and scales through the stage ring by
// the same bulk copies, the cluster barrier), and no arithmetic; rank 0
// writes zeros.  Not a decode: its output is not checked.
template <int D, int G>
__global__ void __launch_bounds__(kQThreads, 2)
decode_int8_floor_kernel(const float* __restrict__ q,
                         const int8_t* __restrict__ k,
                         const int8_t* __restrict__ v,
                         const float* __restrict__ k_scale,
                         const float* __restrict__ v_scale,
                         const int* __restrict__ kv_len,
                         float* __restrict__ out, int H, int Hkv, int T,
                         int chunk, int tk, int stages) {
  const int split = blockIdx.x, splits = gridDim.x;
  if (splits > 1) cluster_arrive_relaxed();
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32;
  extern __shared__ __align__(16) unsigned char qsmem[];
  const QLayout<D> lay{tk, stages, G, splits};
  float* q_s = reinterpret_cast<float*>(qsmem + lay.q_off());
  uint64_t* full = reinterpret_cast<uint64_t*>(qsmem + lay.bar_off());
  uint64_t* empty = full + stages;
  const int len = max(0, min(kv_len[b], T));
  const long long first = static_cast<long long>(split) * chunk;
  const int k0 = first < len ? static_cast<int>(first) : len;
  const int n = min(chunk, len - k0);
  const int n_tiles = (n + tk - 1) / tk;
  const size_t e_base = (static_cast<size_t>(b) * Hkv + kvh) * T + k0;
  const size_t numel = static_cast<size_t>(gridDim.z) * Hkv * T;
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kQWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int j = 0; j < min(stages, n_tiles); ++j) {
      load_tile_int8<D>(qsmem, lay, full, k, v, k_scale, v_scale, e_base,
                        numel, j, n);
    }
  }
  const float4* qb = reinterpret_cast<const float4*>(
      q + (static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G) * D);
  for (int i = tid; i < G * D / 4; i += kQThreads) {
    reinterpret_cast<float4*>(q_s)[i] = __ldg(qb + i);
  }
  __syncthreads();
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % stages;
    const uint32_t parity = (j / stages) & 1;
    mbar_wait(&full[s], parity);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
    if (tid == 0 && j + stages < n_tiles) {
      mbar_wait(&empty[s], parity);
      load_tile_int8<D>(qsmem, lay, full, k, v, k_scale, v_scale, e_base,
                        numel, j + stages, n);
    }
  }
  __syncthreads();
  if (splits > 1) {
    cluster_wait();
    cluster_arrive();
    cluster_wait();
  }
  if (split == 0) {
    float* orow = out +
        (static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G) * D;
    for (int i = tid; i < G * D; i += kQThreads) orow[i] = 0.f;
  }
}

using Int8Kernel = void (*)(const float*, const int8_t*, const int8_t*,
                            const float*, const float*, const int*, float*,
                            int, int, int, int, int, int);

// The int8 instances, and their floors, by group size at head dim D.
template <int D>
constexpr Int8Kernel kInt8Kernels[kMaxG] = {
    decode_attention_kernel_int8<D, 1>, decode_attention_kernel_int8<D, 2>,
    decode_attention_kernel_int8<D, 3>, decode_attention_kernel_int8<D, 4>,
    decode_attention_kernel_int8<D, 5>, decode_attention_kernel_int8<D, 6>,
    decode_attention_kernel_int8<D, 7>, decode_attention_kernel_int8<D, 8>};
template <int D>
constexpr Int8Kernel kInt8Floors[kMaxG] = {
    decode_int8_floor_kernel<D, 1>, decode_int8_floor_kernel<D, 2>,
    decode_int8_floor_kernel<D, 3>, decode_int8_floor_kernel<D, 4>,
    decode_int8_floor_kernel<D, 5>, decode_int8_floor_kernel<D, 6>,
    decode_int8_floor_kernel<D, 7>, decode_int8_floor_kernel<D, 8>};

}  // namespace

bool decode_attention_has_head_dim(int d) { return d == 64 || d == 128; }
int decode_attention_max_splits() { return kMaxSplits; }
// The head slots of a KV head in the float32 group instance: one for a
// group of up to 16 kGMaxMT heads, else the fewest of at most as many
// heads each (the int8 one takes its slots from the wrapper's plan, as
// many or more).
int decode_group_slots(int group) {
  constexpr int kMost = 16 * kGMaxMT;
  return group > kMost ? (group + kMost - 1) / kMost : 1;
}

namespace {

// The dynamic shared memory above 48 KB is granted once per device and
// kernel (`granted`, one flag per device and instance `i`).
template <typename Kernel, int N>
cudaError_t grant_smem(Kernel kernel, bool (&granted)[64][N], int i,
                       size_t bytes) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 64 && granted[device][i]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(bytes));
  if (err == cudaSuccess && device < 64) granted[device][i] = true;
  return err;
}

// One launch of grid (splits, head slots, B) in clusters of `splits`
// blocks (a cluster attribute also for one split: without it the int8 instance
// took 3-6 % longer, `tools/kernel_variants.py`).
template <typename Kernel, typename... Args>
cudaError_t launch_clusters(Kernel kernel, int splits, int slots, int B,
                            int threads, size_t smem, cudaStream_t stream,
                            Args... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, slots, B);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// The group instance (or its floor) at head dim D, MT m-tiles and K/V
// type KV over `slots` head slots a KV head.
template <int D, int MT, typename KV, bool kFloor>
cudaError_t launch_group(const float* q, const KV* k, const KV* v,
                         const float* k_scale, const float* v_scale,
                         const int* kv_len, float* out, int B, int H,
                         int Hkv, int T, int splits, int chunk, int slots,
                         cudaStream_t stream) {
  using L = GLayout<D, MT, KV>;
  const auto kernel = decode_attention_group_kernel<D, MT, KV, kFloor>;
  static bool granted[64][1] = {};
  const cudaError_t err = grant_smem(kernel, granted, 0, L::kBytes);
  if (err != cudaSuccess) return err;
  return launch_clusters(kernel, splits, Hkv * slots, B, 32 * L::kWarps,
                         L::kBytes, stream, q, k, v, k_scale, v_scale,
                         kv_len, out, H, Hkv, T, chunk);
}

// The group instance (or its floor) over `slots` head slots a KV head, at
// the m-tiles of its slots' heads (at most 16 kGMaxMT each).
template <int D, typename KV, bool kFloor>
cudaError_t launch_group_slots(const float* q, const KV* k, const KV* v,
                               const float* k_scale, const float* v_scale,
                               const int* kv_len, float* out, int B, int H,
                               int Hkv, int T, int splits, int chunk,
                               int slots, cudaStream_t stream) {
  const int G = H / Hkv;
  if (slots < 1 || slots > G) return cudaErrorInvalidValue;
  switch (((G + slots - 1) / slots + 15) / 16) {
    case 1:
      return launch_group<D, 1, KV, kFloor>(q, k, v, k_scale, v_scale,
                                            kv_len, out, B, H, Hkv, T,
                                            splits, chunk, slots, stream);
    case 2:
      return launch_group<D, 2, KV, kFloor>(q, k, v, k_scale, v_scale,
                                            kv_len, out, B, H, Hkv, T,
                                            splits, chunk, slots, stream);
    case 3:
      return launch_group<D, 3, KV, kFloor>(q, k, v, k_scale, v_scale,
                                            kv_len, out, B, H, Hkv, T,
                                            splits, chunk, slots, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The float32 launch at head dim D: a group above kMaxG on the group
// instance (or its floor) over its slots (one a KV head up to 16 kGMaxMT
// heads, `decode_group_slots`), else the G <= 8 instance.
template <int D, bool kFloor = false>
cudaError_t launch(const float* q, const float* k, const float* v,
                   const int* kv_len, float* out, int B, int H, int Hkv,
                   int T, int splits, int chunk, cudaStream_t stream) {
  using Kernel = void (*)(const float*, const float*, const float*,
                          const int*, float*, int, int, int, int, int, int);
  constexpr Kernel kKernels[kMaxG] = {
      decode_attention_kernel<D, 1>, decode_attention_kernel<D, 2>,
      decode_attention_kernel<D, 3>, decode_attention_kernel<D, 4>,
      decode_attention_kernel<D, 5>, decode_attention_kernel<D, 6>,
      decode_attention_kernel<D, 7>, decode_attention_kernel<D, 8>};
  if (Hkv < 1 || H % Hkv) return cudaErrorInvalidValue;
  const int G = H / Hkv;
  if (G > kMaxG || kFloor) {
    if (G <= kMaxG) return cudaErrorInvalidValue;
    return launch_group_slots<D, float, kFloor>(
        q, k, v, nullptr, nullptr, kv_len, out, B, H, Hkv, T, splits, chunk,
        decode_group_slots(G), stream);
  }
  constexpr int kTK = Dims<D>::kTK;
  const Kernel kernel = kKernels[G - 1];
  static bool granted[64][kMaxG] = {};
  cudaError_t err = grant_smem(
      kernel, granted, G - 1, Layout<D>{kTK, kStages, G, kMaxSplits}.bytes());
  if (err != cudaSuccess) return err;
  // A range of one tile or less is one stage, sized to the range.
  const int tk = chunk < kTK ? chunk : kTK;
  const int stages = chunk > tk ? kStages : 1;
  return launch_clusters(kernel, splits, Hkv, B, kThreads,
                         Layout<D>{tk, stages, G, splits}.bytes(), stream,
                         q, k, v, kv_len, out, H, Hkv, T, chunk, tk, stages);
}

// The int8 launch at head dim D for a group of up to kMaxG, of one of
// `kernels` (by group size: the int8 instances or their floors);
// `granted` holds their shared memory grants.
template <int D>
cudaError_t launch_int8(const Int8Kernel (&kernels)[kMaxG],
                        bool (&granted)[64][kMaxG], const float* q,
                        const int8_t* k, const int8_t* v,
                        const float* k_scale, const float* v_scale,
                        const int* kv_len, float* out, int B, int H, int Hkv,
                        int T, int splits, int chunk, cudaStream_t stream) {
  constexpr int kTK = QDims<D>::kTK;
  if (Hkv < 1 || H % Hkv || H / Hkv > kMaxG) return cudaErrorInvalidValue;
  const int G = H / Hkv;
  const Int8Kernel kernel = kernels[G - 1];
  cudaError_t err = grant_smem(
      kernel, granted, G - 1,
      QLayout<D>{kTK, kQStages, G, kMaxSplits}.bytes());
  if (err != cudaSuccess) return err;
  // A range of one tile or less is one stage, sized to the range.
  const int tk = chunk < kTK ? chunk : kTK;
  const int stages = chunk > tk ? kQStages : 1;
  return launch_clusters(kernel, splits, Hkv, B, kQThreads,
                         QLayout<D>{tk, stages, G, splits}.bytes(), stream,
                         q, k, v, k_scale, v_scale, kv_len, out, H, Hkv, T,
                         chunk, tk, stages);
}

// The int8 launch at head dim D: a group above kMaxG on the group
// instance over `slots` head slots a KV head (its floor at head dim 128
// only), else the G <= 8 instance (or its floor), whose slot is the KV
// head.
template <int D, bool kFloor>
cudaError_t launch_int8_any(const float* q, const int8_t* k,
                            const int8_t* v, const float* k_scale,
                            const float* v_scale, const int* kv_len,
                            float* out, int B, int H, int Hkv, int T,
                            int splits, int chunk, int slots,
                            cudaStream_t stream) {
  if (Hkv < 1 || H % Hkv) return cudaErrorInvalidValue;
  if (H / Hkv > kMaxG) {
    if constexpr (kFloor && D != 128) {
      return cudaErrorInvalidValue;
    } else {
      return launch_group_slots<D, int8_t, kFloor>(
          q, k, v, k_scale, v_scale, kv_len, out, B, H, Hkv, T, splits,
          chunk, slots, stream);
    }
  }
  if (slots != 1) return cudaErrorInvalidValue;
  static bool granted[64][kMaxG] = {};
  return launch_int8<D>(kFloor ? kInt8Floors<D> : kInt8Kernels<D>, granted,
                        q, k, v, k_scale, v_scale, kv_len, out, B, H, Hkv,
                        T, splits, chunk, stream);
}

}  // namespace

cudaError_t launch_decode_attention(const float* q, const float* k,
                                    const float* v, const int* kv_len,
                                    float* out, int B, int H, int Hkv, int T,
                                    int D, int splits, int chunk,
                                    cudaStream_t stream) {
  if (D == 64) {
    return launch<64>(q, k, v, kv_len, out, B, H, Hkv, T, splits, chunk,
                      stream);
  }
  if (D == 128) {
    return launch<128>(q, k, v, kv_len, out, B, H, Hkv, T, splits, chunk,
                       stream);
  }
  return cudaErrorInvalidValue;
}

// The group instance's floor, at head dim 128 only (the giants').
cudaError_t launch_decode_attention_group_floor(
    const float* q, const float* k, const float* v, const int* kv_len,
    float* out, int B, int H, int Hkv, int T, int D, int splits, int chunk,
    cudaStream_t stream) {
  if (D == 128) {
    return launch<128, true>(q, k, v, kv_len, out, B, H, Hkv, T, splits,
                             chunk, stream);
  }
  return cudaErrorInvalidValue;
}

cudaError_t launch_decode_attention_int8(const float* q, const int8_t* k,
                                         const int8_t* v,
                                         const float* k_scale,
                                         const float* v_scale,
                                         const int* kv_len, float* out, int B,
                                         int H, int Hkv, int T, int D,
                                         int splits, int chunk, int slots,
                                         cudaStream_t stream) {
  if (D == 64) {
    return launch_int8_any<64, false>(q, k, v, k_scale, v_scale, kv_len,
                                      out, B, H, Hkv, T, splits, chunk,
                                      slots, stream);
  }
  if (D == 128) {
    return launch_int8_any<128, false>(q, k, v, k_scale, v_scale, kv_len,
                                       out, B, H, Hkv, T, splits, chunk,
                                       slots, stream);
  }
  return cudaErrorInvalidValue;
}

// The floors of the int8 designs: the G <= 8 instance's at both head
// dims, the group instance's at head dim 128 only.
cudaError_t launch_decode_attention_int8_floor(
    const float* q, const int8_t* k, const int8_t* v, const float* k_scale,
    const float* v_scale, const int* kv_len, float* out, int B, int H,
    int Hkv, int T, int D, int splits, int chunk, int slots,
    cudaStream_t stream) {
  if (D == 64) {
    return launch_int8_any<64, true>(q, k, v, k_scale, v_scale, kv_len, out,
                                     B, H, Hkv, T, splits, chunk, slots,
                                     stream);
  }
  if (D == 128) {
    return launch_int8_any<128, true>(q, k, v, k_scale, v_scale, kv_len,
                                      out, B, H, Hkv, T, splits, chunk,
                                      slots, stream);
  }
  return cudaErrorInvalidValue;
}
