"""Time variants of the port's CUDA kernels.

  python3 tools/kernel_variants.py [--only KIND ...]

KIND is one of ssd, flash, decode, decode_int8, race (default: all).

Needs one CUDA card and ``nvcc``.  A variant is a kernel's shipped source
(``src/repro_torch/kernels/<kernel>/<kernel>.cu``) with a few text
substitutions, each of which must match exactly once; the shipped source
itself is the baseline and goes through the same harness.  Every variant
is built by ``nvcc`` (the port's flags, ``-Xptxas=-v``) into its own
shared library under ``build/kernel_variants/``, all builds started
together, and called through ctypes by an ``extern "C"`` entry appended
to its source.  Nothing here is imported by the port.

At the shapes ``chip_smoke.py`` times (``ssd_chunk``: x (32, 4, 64, 32,
64), B/C (32, 4, 64, 128); ``flash_attention``: q (32, 15, 256, 64), k/v
(32, 5, 370, 64) with half the rows at offset 256; ``decode_attention``:
q (32, 15, 64), four (32, 5, 370, 64) K/V sets and the serve's kv_len;
its int8 instance ``decode_attention_int8``: the same q against int8 K/V
sets with float32 scales, worth three L2 caches; ``gls_row_race``: (20,
8, 49152) and (5, 8, 50280)), every variant is
checked against the kernel's plain version (``ssd_chunk`` 5e-4 abs + rel
on y and the states, 1e-5 on the total; attention 1e-4 abs; the race
bitwise) and timed with CUDA events: the median of 25 samples of 10
back-to-back calls, the variants of a kernel in turn and then in reverse
order.  The decode and race variants cycle through their input sets as
``chip_smoke.py`` does, so each call finds its inputs cold in L2, and
also report their device time per call from ``torch.profiler``.  A
variant may fix the split plan (``splits``) that the wrapper would
choose.  Prints per variant: registers and spills (ptxas), resident
blocks per SM (the occupancy API), the two times (and the device time)
and the max abs error, then the card's name and power limit.  Exits
non-zero when a variant does not build or disagrees with the plain
version.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import pathlib
import re
import shutil
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, os.fspath(ROOT / "src"))
sys.path.insert(1, os.fspath(ROOT))
OUT = ROOT / "build" / "kernel_variants"
SSD = ROOT / "src/repro_torch/kernels/ssd_chunk/ssd_chunk.cu"
FLASH = ROOT / "src/repro_torch/kernels/flash_attention/flash_attention.cu"
DECODE = ROOT / ("src/repro_torch/kernels/decode_attention/"
                 "decode_attention.cu")
RACE = ROOT / "src/repro_torch/kernels/gls_race/row_race.cu"
SEED = 0

# --- ssd_chunk -------------------------------------------------------------

SSD_8_HEADS = [("constexpr int kHeads = 16;", "constexpr int kHeads = 8;")]
# C B^T stored as its lower triangle, row i at i (i + 1) / 2: 8 KB less
# (the diagonal tiles' entries above the diagonal are not stored).
SSD_TRIANGLE_CB = [
    ("constexpr int kOffDt = kOffCB + kQ * kWQ;",
     "constexpr int kOffDt = kOffCB + kQ * (kQ + 1) / 2;"),
    ("CBs[(ti + 16 * u) * kWQ + tj + 16 * v] = acc[u][v];",
     "if (tj + 16 * v <= ti + 16 * u) {\n"
     "          CBs[(ti + 16 * u) * (ti + 16 * u + 1) / 2 + tj + 16 * v] = "
     "acc[u][v];\n        }"),
    ("CBs[i * kWQ + j]", "CBs[i * (i + 1) / 2 + j]"),
]
# One x buffer (the next head's x loads between two barriers) and C read
# through L1 for C B^T instead of staged: with the two above, 73.6 KB of
# shared memory, small enough for three blocks per SM; the registers
# (120 a thread) still allow two.
SSD_ONE_X_BUFFER = [
    ("    cp_async16(Cs + i * kBN + 4 * n4, csrc + 4 * e);\n", ""),
    ("cv[u] = *reinterpret_cast<const float4*>(Cs + (ti + 16 * u) * kBN + n);",
     "cv[u] = __ldg(reinterpret_cast<const float4*>(csrc + (ti + 16 * u) * "
     "kN + n));"),
    ('static_assert(kOffC + kQ * kBN <= kSmemFloats, "C must fit");\n', ""),
    ("constexpr int kOffW = kOffX + 2 * kQ * kP;",
     "constexpr int kOffW = kOffX + kQ * kP;"),
    ("const float* xs = smem + kOffX + (hh & 1) * kQ * kP;",
     "const float* xs = smem + kOffX;"),
    ("""    if (hh + 1 < nh) {
      copy_x(smem + kOffX + ((hh + 1) & 1) * kQ * kP, x, row0, n_heads,
             h + 1);
    }
""", ""),
    ("""    cp_async_wait_all();
    __syncthreads();
  }
}""", """    __syncthreads();
    if (hh + 1 < nh) copy_x(smem + kOffX, x, row0, n_heads, h + 1);
    cp_async_wait_all();
    __syncthreads();
  }
}"""),
]
# Registers capped at 80 a thread, so three blocks of that layout fit.
SSD_THREE_BLOCKS = [
    ("__launch_bounds__(kThreads, 2)", "__launch_bounds__(kThreads, 3)")]
SSD_ENTRY = """
extern "C" int variant_launch(const float* x, const float* dt, const float* a,
                              const float* b, const float* c, float* y,
                              float* states, float* total, int batch,
                              int n_chunks, int n_heads, void* stream) {
  const cudaError_t err = launch_ssd_chunk(
      x, dt, a, b, c, y, states, total, batch, n_chunks, n_heads,
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaPeekAtLastError());
}
extern "C" int variant_blocks_per_sm() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, ssd_chunk_kernel,
                                                kThreads, kSmemBytes);
  return n;
}
"""

# --- flash_attention -------------------------------------------------------

# One query head per block: K/V staged once per query head, 100 KB, two
# blocks per SM.
FLASH_1_HEAD = [
    ("static constexpr int kMaxHeads = 3;",
     "static constexpr int kMaxHeads = 1;"),
    ("__launch_bounds__(kGroup * Tile<D>::kMaxHeads, 1)",
     "__launch_bounds__(kGroup * Tile<D>::kMaxHeads, 2)"),
]
# 32 query rows per warp group and one K/V stage (the next tile loads
# between two barriers): 88 KB and 192 threads, two blocks per SM.
FLASH_32_ROWS_1_STAGE = [
    ("constexpr int kBQ = 64;", "constexpr int kBQ = 32;"),
    ("static constexpr int kStagesF = kQuant ? 1 : 2;",
     "static constexpr int kStagesF = 1;"),
    ("""      if (it + 1 < n_tiles) {
        load_kv<D>(smem + (stage ^ 1) * kKStage,
                   smem + kOffV + (stage ^ 1) * kVStage, k, v, kv_base,
                   k0 + kBK, T);
      }
      ks = smem + stage * kKStage;
      vs = smem + kOffV + stage * kVStage;""", """      ks = smem;
      vs = smem + kOffV;"""),
    ("""    __syncwarp();  // P^T is rewritten by the next tile
  }""", """    __syncwarp();  // P^T is rewritten by the next tile
    if constexpr (!L::kQuant) {
      if (it + 1 < n_tiles) {
        __syncthreads();
        load_kv<D>(smem, smem + kOffV, k, v, kv_base, k0 + kBK, T);
      }
    }
  }"""),
    ("__launch_bounds__(kGroup * Tile<D>::kMaxHeads, 1)",
     "__launch_bounds__(kGroup * Tile<D>::kMaxHeads, 2)"),
]
FLASH_ENTRY = """
extern "C" int variant_launch(const float* q, const float* k, const float* v,
                              const int* q_offset, const int* kv_len,
                              float* out, int B, int H, int Hkv, int S, int T,
                              int window, void* stream) {
  const cudaError_t err = launch_flash_attention(
      q, k, v, q_offset, kv_len, out, B, H, Hkv, S, T, 64, window,
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaPeekAtLastError());
}
extern "C" int variant_blocks_per_sm() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, flash_attention_kernel<64, float>, kGroup * Tile<64>::kMaxHeads,
      Smem<64, float>::bytes(Tile<64>::kMaxHeads));
  return n;
}
"""

# --- decode_attention -------------------------------------------------------

# The blocks' partials through global scratch and a second kernel, in
# place of the merge in rank 0's shared memory (and no cluster in the
# launch).
DECODE_TWO_PASS = [
    ("constexpr int kMaxSplits = 8;                // the portable cluster size",
     "constexpr int kMaxSplits = 8;\n"
     "__device__ float g_scratch[1 << 22];"),
    ("  cluster_arrive_relaxed();\n", ""),
    ("""  cluster_wait();
  float* rpart = cluster.map_shared_rank(bpart, 0) + split * G * kPart;""",
     """  float* rpart = g_scratch +
      ((static_cast<size_t>(b) * Hkv + kvh) * splits + split) * G * kPart;"""),
    ("""  cluster_arrive();
  cluster_wait();
  if (split == 0) {""", """  if (false) {"""),
    ("""kD + d] = num / fmaxf(den, 1e-30f);
    }
  }
}

}  // namespace""", """kD + d] = num / fmaxf(den, 1e-30f);
    }
  }
}

__global__ void decode_merge_kernel(float* __restrict__ out, int H, int Hkv,
                                    int splits) {
  constexpr int kD = 64, kPart = Dims<64>::kPart;
  const int kvh = blockIdx.x, b = blockIdx.y, G = H / Hkv;
  const float* sp = g_scratch +
      (static_cast<size_t>(b) * Hkv + kvh) * splits * G * kPart;
  for (int i = threadIdx.x; i < G * kD; i += blockDim.x) {
    const int g = i / kD, d = i % kD;
    float mx = -INFINITY;
    for (int r = 0; r < splits; ++r) mx = fmaxf(mx, sp[(r * G + g) * kPart]);
    const float m_safe = isfinite(mx) ? mx : 0.f;
    float den = 0.f, num = 0.f;
    for (int r = 0; r < splits; ++r) {
      const float* pr = sp + (r * G + g) * kPart;
      const float sr = isfinite(pr[0]) ? expf(pr[0] - m_safe) : 0.f;
      den = fmaf(sr, pr[1], den);
      num = fmaf(sr, pr[2 + d], num);
    }
    out[(static_cast<size_t>(b) * H + static_cast<size_t>(kvh) * G + g) *
            kD + d] = num / fmaxf(den, 1e-30f);
  }
}

}  // namespace"""),
    ("  cfg.numAttrs = 1;", "  cfg.numAttrs = 0;"),
]
# Rank 0 pulls the peers' partials (two blocking cluster barriers and a
# remote read round trip) instead of the peers pushing them.
DECODE_PULL_MERGE = [
    ("  cluster_arrive_relaxed();\n", ""),
    ("""  cluster_wait();
  float* rpart = cluster.map_shared_rank(bpart, 0) + split * G * kPart;""",
     "  float* rpart = bpart;"),
    ("""  cluster_arrive();
  cluster_wait();
  if (split == 0) {""", """  cluster.sync();
  if (split == 0) {"""),
    ("          const float* pr = bpart + (r * G + g) * kPart;",
     "          const float* pr = cluster.map_shared_rank(bpart, r) + g * kPart;"),
    ("""kD + d] = num / fmaxf(den, 1e-30f);
    }
  }
}""", """kD + d] = num / fmaxf(den, 1e-30f);
    }
  }
  cluster.sync();
}"""),
]
# Each block of a cluster takes 1/splits of the row's LIVE keys (ranges
# of ceil(kv_len / splits)) instead of 1/splits of T.
DECODE_LIVE_RANGES = [
    ("""  const long long first = static_cast<long long>(split) * chunk;""",
     """  const int cb = (len + splits - 1) / splits;
  const long long first = static_cast<long long>(split) * cb;"""),
    ("  const int n = min(chunk, len - k0);", "  const int n = min(cb, len - k0);"),
]
# Two warps a block: 64 threads, 32-key tiles.
DECODE_2_WARPS = [("constexpr int kWarps = 4;", "constexpr int kWarps = 2;")]
# Three tiles in flight per block.
DECODE_3_STAGES = [("constexpr int kStages = 2;", "constexpr int kStages = 3;")]
DECODE_ENTRY = """
extern "C" int variant_launch(const float* q, const float* k, const float* v,
                              const int* kv_len, float* out, int B, int H,
                              int Hkv, int T, int splits, int chunk,
                              void* stream) {
  const cudaError_t err = launch_decode_attention(
      q, k, v, kv_len, out, B, H, Hkv, T, 64, splits, chunk,
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaPeekAtLastError());
}
extern "C" int variant_blocks_per_sm() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, decode_attention_kernel<64, 3, float>, kThreads,
      Layout<64>{64, 2, 3, 2, 4}.bytes());
  return n;
}
"""
# The int8 instance: int8 K/V and their float32 scales.
DECODE_INT8_ENTRY = """
extern "C" int variant_launch(const float* q, const int8_t* k,
                              const int8_t* v, const float* k_scale,
                              const float* v_scale, const int* kv_len,
                              float* out, int B, int H, int Hkv, int T,
                              int splits, int chunk, void* stream) {
  const cudaError_t err = launch_decode_attention_int8(
      q, k, v, k_scale, v_scale, kv_len, out, B, H, Hkv, T, 64, splits,
      chunk, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaPeekAtLastError());
}
extern "C" int variant_blocks_per_sm() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, decode_attention_kernel<64, 3, int8_t>, kThreads,
      Layout<64>{62, 1, 3, 6, 1}.bytes());
  return n;
}
"""
# The int8 instance under a register cap for six blocks per SM (no
# spill at G = 3) in place of seven (8 bytes spilled).
DECODE_INT8_6_BLOCKS = [
    ("__launch_bounds__(kThreads, D == 64 ? (G <= 4 ? 7 : 4) : 4)",
     "__launch_bounds__(kThreads, D == 64 ? (G <= 4 ? 6 : 4) : 4)")]
DECODE_TWO_PASS_ENTRY = DECODE_ENTRY.replace(
    "  return static_cast<int>(err != cudaSuccess ? err : "
    "cudaPeekAtLastError());\n}",
    "  if (err != cudaSuccess) return static_cast<int>(err);\n"
    "  decode_merge_kernel<<<dim3(Hkv, B), kThreads, 0,\n"
    "                        static_cast<cudaStream_t>(stream)>>>(\n"
    "      out, H, Hkv, splits);\n"
    "  return static_cast<int>(cudaPeekAtLastError());\n}", 1)

# --- gls_row_race -----------------------------------------------------------

RACE_512_THREADS = [("constexpr int kThreads = 256;",
                     "constexpr int kThreads = 512;")]
RACE_128_THREADS = [("constexpr int kThreads = 256;",
                     "constexpr int kThreads = 128;")]
RACE_1024_THREADS = [("constexpr int kThreads = 256;",
                      "constexpr int kThreads = 1024;")]


def race_unroll(n):
    """kUnroll float4 loads of each input in flight per thread (1
    shipped)."""
    return [("constexpr int kUnroll = 1; ", f"constexpr int kUnroll = {n}; ")]


# Plain __ldg loads in place of the streamed ones (L1 no-allocate, 256-byte
# L2 fetches).
RACE_LDG = [("""          a[u] = ld_stream(s4 + jj);
          c[u] = ld_stream(q4 + jj);""", """          a[u] = __ldg(s4 + jj);
          c[u] = __ldg(q4 + jj);""")]
# Rank 0 pulls the peers' pairs (two blocking cluster barriers, a remote
# read round trip) instead of the peers pushing them.
RACE_PULL_MERGE = [
    ("  cluster_arrive_relaxed();\n", ""),
    ("""  cluster_wait();
  if (threadIdx.x == 0) {
    *cluster.map_shared_rank(&part_v[split], 0) = bv;
    *cluster.map_shared_rank(&part_i[split], 0) = bi;
  }
  cluster_arrive();
  cluster_wait();
  if (split == 0 && warp == 0) {
    bv = lane < static_cast<int>(gridDim.x) ? part_v[lane] : INFINITY;
    bi = lane < static_cast<int>(gridDim.x) ? part_i[lane] : INT_MAX;""",
     """  if (threadIdx.x == 0) {
    part_v[0] = bv;
    part_i[0] = bi;
  }
  cluster.sync();
  if (split == 0 && warp == 0) {
    bv = INFINITY;
    bi = INT_MAX;
    if (lane < static_cast<int>(gridDim.x)) {
      bv = *cluster.map_shared_rank(&part_v[0], lane);
      bi = *cluster.map_shared_rank(&part_i[0], lane);
    }"""),
    ("""      rarg[row] = bi == INT_MAX ? 0 : bi;
    }
  }
}""", """      rarg[row] = bi == INT_MAX ? 0 : bi;
    }
  }
  cluster.sync();
}"""),
]
# No cluster in the launch (one split: the kernel's barriers then span
# the block alone).
RACE_NO_CLUSTER_ATTR = [("  cfg.numAttrs = 1;", "  cfg.numAttrs = 0;")]
RACE_ENTRY = """
extern "C" int variant_launch(const float* log_s, const float* log_q,
                              float* rmin, int* rarg, int rows, int n,
                              int splits, int chunk, void* stream) {
  const cudaError_t err = launch_gls_row_race(
      log_s, log_q, rmin, rarg, rows, n, splits, chunk,
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaPeekAtLastError());
}
extern "C" int variant_blocks_per_sm() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gls_row_race_kernel,
                                                kThreads, 0);
  return n;
}
"""
# The parent commit's kernels (``--parent DIR``: a tree unpacked with
# ``git archive``), through the same harness.
PARENT_DECODE_ENTRY = """
extern "C" int variant_launch(const float* q, const float* k, const float* v,
                              const int* kv_len, float* out, int B, int H,
                              int Hkv, int T, int splits, int chunk,
                              void* stream) {
  launch_decode_attention(q, k, v, kv_len, out, B, H, Hkv, T,
                          static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaPeekAtLastError());
}
extern "C" int variant_blocks_per_sm() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, decode_attention_kernel<kD, kTK>, kThreads,
      sizeof(float) * (3 * kD + kTK * (kD + 1) + kTK * kD + 3 * kTK + 9));
  return n;
}
"""
PARENT_RACE_ENTRY = """
extern "C" int variant_launch(const float* log_s, const float* log_q,
                              float* rmin, int* rarg, int rows, int n,
                              int splits, int chunk, void* stream) {
  launch_gls_row_race(log_s, log_q, rmin, rarg, rows, n,
                      static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaPeekAtLastError());
}
extern "C" int variant_blocks_per_sm() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gls_row_race_kernel,
                                                kThreads, 0);
  return n;
}
"""
RACE_ENTRY = """
extern "C" int variant_launch(const float* log_s, const float* log_q,
                              float* rmin, int* rarg, int rows, int n,
                              int splits, int chunk, void* stream) {
  const cudaError_t err = launch_gls_row_race(
      log_s, log_q, rmin, rarg, rows, n, splits, chunk,
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaPeekAtLastError());
}
extern "C" int variant_blocks_per_sm() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gls_row_race_kernel,
                                                kThreads, 0);
  return n;
}
"""

VARIANTS = {
    "ssd_chunk": ("ssd", []),
    "ssd_chunk/8_heads": ("ssd", SSD_8_HEADS),
    "ssd_chunk/8_heads_triangle_cb": ("ssd", SSD_8_HEADS + SSD_TRIANGLE_CB),
    "ssd_chunk/8_heads_triangle_cb_one_x": ("ssd", SSD_8_HEADS
                                            + SSD_TRIANGLE_CB
                                            + SSD_ONE_X_BUFFER),
    "ssd_chunk/3_blocks_per_sm": ("ssd", SSD_8_HEADS + SSD_TRIANGLE_CB
                                  + SSD_ONE_X_BUFFER + SSD_THREE_BLOCKS),
    "flash_attention": ("flash", []),
    "flash_attention/1_head": ("flash", FLASH_1_HEAD),
    "flash_attention/32_rows_1_stage": ("flash", FLASH_32_ROWS_1_STAGE),
    # The wrapper's plan at the serve shape is 2 splits.
    "decode_attention": ("decode", []),
    "decode_attention/8_splits": ("decode", [], {"splits": 8}),
    "decode_attention/4_splits": ("decode", [], {"splits": 4}),
    "decode_attention/1_split": ("decode", [], {"splits": 1}),
    "decode_attention/pull_merge": ("decode", DECODE_PULL_MERGE),
    "decode_attention/pull_merge_8_splits": ("decode", DECODE_PULL_MERGE,
                                             {"splits": 8}),
    "decode_attention/two_pass": ("decode_two_pass", DECODE_TWO_PASS),
    "decode_attention/two_pass_8_splits": ("decode_two_pass",
                                           DECODE_TWO_PASS, {"splits": 8}),
    "decode_attention/live_ranges": ("decode", DECODE_LIVE_RANGES),
    "decode_attention/live_ranges_8_splits": ("decode", DECODE_LIVE_RANGES,
                                              {"splits": 8}),
    "decode_attention/2_warps": ("decode", DECODE_2_WARPS),
    "decode_attention/2_warps_4_splits": ("decode", DECODE_2_WARPS,
                                          {"splits": 4}),
    "decode_attention/3_stages": ("decode", DECODE_3_STAGES),
    "decode_attention_int8": ("decode_int8", []),
    "decode_attention_int8/6_blocks_per_sm": ("decode_int8",
                                              DECODE_INT8_6_BLOCKS),
    "decode_attention_int8/2_splits": ("decode_int8", [], {"splits": 2}),
    "decode_attention_int8/8_splits": ("decode_int8", [], {"splits": 8}),
    # The wrapper's plan: 2 splits at (20, 8, 49152), 8 at (5, 8, 50280).
    "gls_row_race": ("race", []),
    "gls_row_race/1_split": ("race", [], {"splits": 1}),
    "gls_row_race/4_splits": ("race", [], {"splits": 4}),
    "gls_row_race/8_splits": ("race", [], {"splits": 8}),
    "gls_row_race/pull_merge": ("race", RACE_PULL_MERGE),
    "gls_row_race/ldg": ("race", RACE_LDG),
    "gls_row_race/ldg_unroll_4": ("race", RACE_LDG + race_unroll(4)),
    "gls_row_race/ldg_unroll_4_4_splits": ("race", RACE_LDG + race_unroll(4),
                                           {"splits": 4}),
    "gls_row_race/ldg_unroll_4_pull_merge": ("race", RACE_LDG + race_unroll(4)
                                             + RACE_PULL_MERGE),
    "gls_row_race/unroll_2": ("race", race_unroll(2)),
    "gls_row_race/unroll_4": ("race", race_unroll(4)),
    "gls_row_race/unroll_8": ("race", race_unroll(8)),
    "gls_row_race/512_threads": ("race", RACE_512_THREADS),
    "gls_row_race/512_threads_4_splits": ("race", RACE_512_THREADS,
                                          {"splits": 4}),
    "gls_row_race/128_threads": ("race", RACE_128_THREADS),
    "gls_row_race/128_threads_unroll_4": ("race", RACE_128_THREADS
                                          + race_unroll(4)),
    "gls_row_race/1024_threads_1_split": ("race", RACE_1024_THREADS,
                                          {"splits": 1}),
    "gls_row_race/1024_threads_1_split_no_cluster": (
        "race", RACE_1024_THREADS + RACE_NO_CLUSTER_ATTR, {"splits": 1}),
}
SOURCES = {"ssd": (SSD, SSD_ENTRY), "flash": (FLASH, FLASH_ENTRY),
           "decode": (DECODE, DECODE_ENTRY),
           "decode_two_pass": (DECODE, DECODE_TWO_PASS_ENTRY),
           "decode_int8": (DECODE, DECODE_INT8_ENTRY),
           "race": (RACE, RACE_ENTRY),
           "decode_parent": (None, PARENT_DECODE_ENTRY),
           "race_parent": (None, PARENT_RACE_ENTRY)}
# The (mangled) name of the kernel whose ptxas registers and spills each
# kind reports: head dim 64, decode at smollm-360m's group size G = 3.
PTXAS_KERNEL = {"ssd": "ssd_chunk_kernel",
                "flash": "flash_attention_kernelILi64EfE",
                "decode": "decode_attention_kernelILi64ELi3EfE",
                "decode_two_pass": "decode_attention_kernelILi64ELi3EfE",
                "decode_int8": "decode_attention_kernelILi64ELi3EaE",
                "race": "gls_row_race_kernel",
                "decode_parent": "decode_attention_kernel",
                "race_parent": "gls_row_race_kernel"}
# The input case each source kind runs.
CASE_OF = {"ssd": "ssd", "flash": "flash", "decode": "decode",
           "decode_two_pass": "decode", "decode_int8": "decode_int8",
           "race": "race",
           "decode_parent": "decode", "race_parent": "race"}
PARENT_VARIANTS = {"decode_attention (parent)": ("decode_parent", []),
                   "gls_row_race (parent)": ("race_parent", [])}
PARENT_FILES = {"decode_parent": DECODE.relative_to(ROOT),
                "race_parent": RACE.relative_to(ROOT)}


def variant_source(kind: str, subs, parent=None) -> str:
    path, entry = SOURCES[kind]
    if path is None:
        path = pathlib.Path(parent) / PARENT_FILES[kind]
    s = path.read_text()
    for old, new in subs:
        n = s.count(old)
        if n != 1:
            raise ValueError(f"{path.name}: {n} matches for {old[:60]!r}")
        s = s.replace(old, new)
    return s + entry


def build_all(names, parent=None):
    """The named variants' nvcc runs at once; returns {name: (lib path,
    ptxas register and spill lines)}."""
    from torch.utils.cpp_extension import CUDA_HOME
    from repro_torch.kernels.build import CUDA_FLAGS
    nvcc = (os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME
            else shutil.which("nvcc"))
    if os.path.isdir(OUT):
        shutil.rmtree(OUT)
    OUT.mkdir(parents=True)
    procs = {}
    for i, name in enumerate(names):
        kind, subs = VARIANTS[name][:2]
        src = OUT / f"v{i}.cu"
        src.write_text(variant_source(kind, subs, parent))
        lib = OUT / f"v{i}.so"
        cmd = [nvcc, *CUDA_FLAGS, "-Xptxas=-v", "-shared", "-Xcompiler",
               "-fPIC", "-o", os.fspath(lib), os.fspath(src)]
        procs[name] = (lib, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    built = {}
    for name, (lib, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"{name}: nvcc failed\n{out}")
        # ptxas's lines for the kernel that runs at the timed shape.
        entry = out.split(PTXAS_KERNEL[VARIANTS[name][0]], 1)[-1]
        regs = re.findall(r"Used (\d+) registers", entry)
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", entry)
        built[name] = (lib, f"{regs[0] if regs else '?'} registers, spill "
                            f"stores/loads {spills[0] if spills else '?'}")
    return built


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def ssd_case(torch, dev):
    """The launcher and check of each ssd_chunk variant, on chip_smoke's
    serve-shape inputs."""
    from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_plain
    b, nc, q, h, p, n = 32, 4, 64, 32, 64, 128
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 40)
    x = torch.randn((b, nc, q, h, p), generator=g, device=dev)
    dt = torch.nn.functional.softplus(
        torch.randn((b, nc, q, h), generator=g, device=dev))
    a = -torch.exp(0.3 * torch.randn((h,), generator=g, device=dev))
    b_in = torch.randn((b, nc, q, n), generator=g, device=dev)
    c_in = torch.randn((b, nc, q, n), generator=g, device=dev)
    want = ssd_chunk_plain(x, dt, a, b_in, c_in)
    y = torch.empty_like(x)
    st = torch.empty((b, nc, h, p, n), device=dev)
    tot = torch.empty((b, nc, h), device=dev)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def run(lib):
        rc = lib.variant_launch(ptr(x), ptr(dt), ptr(a), ptr(b_in),
                                ptr(c_in), ptr(y), ptr(st), ptr(tot), b, nc,
                                h, stream)
        if rc:
            raise RuntimeError(f"launch failed: cuda error {rc}")

    def check():
        err = 0.0
        for got, exp, tol in ((y, want[0], 5e-4), (st, want[1], 5e-4),
                              (tot, want[2], 1e-5)):
            d = (got - exp).abs()
            if not bool((d <= tol + tol * exp.abs()).all()):
                raise AssertionError(f"max abs err {float(d.max())}")
            err = max(err, float(d.max()))
        return err

    return run, check


def flash_case(torch, dev):
    """The launcher and check of each flash_attention variant, on
    chip_smoke's admission-shape inputs."""
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    b, h, hkv, s, t, d = 32, 15, 5, 256, 370, 64
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 2)
    q = torch.randn((b, h, s, d), generator=g, device=dev)
    k = torch.randn((b, hkv, t, d), generator=g, device=dev)
    v = torch.randn((b, hkv, t, d), generator=g, device=dev)
    q_off = torch.zeros(b, dtype=torch.int32, device=dev)
    q_off[b // 2:] = s
    kv_len = q_off + s
    want = flash_attention_plain(q, k, v, q_off, kv_len)
    out = torch.empty_like(q)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def run(lib):
        rc = lib.variant_launch(ptr(q), ptr(k), ptr(v), ptr(q_off),
                                ptr(kv_len), ptr(out), b, h, hkv, s, t, 0,
                                stream)
        if rc:
            raise RuntimeError(f"launch failed: cuda error {rc}")

    def check():
        err = float((out - want).abs().max())
        if err > 1e-4:
            raise AssertionError(f"max abs err {err}")
        return err

    return run, check


def decode_case(torch, dev):
    """The launcher and check of each decode_attention variant, cycling
    through chip_smoke's four K/V sets (cold in L2) with the serve's
    kv_len."""
    import chip_smoke as C
    from repro_torch.kernels.decode_attention.ops import decode_split_plan
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_plain)
    b, h, hkv, d, t = 32, 15, 5, 64, 370
    q, kv_sets, kv_len = C.decode_inputs(torch, dev, b, h, hkv, d, t)
    want = decode_attention_plain(q, *kv_sets[0], kv_len)
    out = torch.empty_like(q)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def calls(lib, opts):
        splits = opts.get("splits", decode_split_plan(b, hkv, t)[0])
        chunk = -(-t // splits)

        def one(k, v):
            rc = lib.variant_launch(ptr(q), ptr(k), ptr(v), ptr(kv_len),
                                    ptr(out), b, h, hkv, t, splits, chunk,
                                    stream)
            if rc:
                raise RuntimeError(f"launch failed: cuda error {rc}")
        return [lambda k=k, v=v: one(k, v) for k, v in kv_sets]

    def check(lib, opts):
        calls(lib, opts)[0]()
        torch.cuda.synchronize()
        err = float((out - want).abs().max())
        if err > 1e-4:
            raise AssertionError(f"max abs err {err}")
        return err

    return calls, check, "decode_"


def decode_int8_case(torch, dev):
    """The launcher and check of each variant of the int8 instance,
    cycling through int8 K/V sets worth three L2 caches with the serve's
    kv_len (as chip_smoke.py's ``kernel_decode_int8``)."""
    import chip_smoke as C
    from repro_torch.kernels.decode_attention.ops import (KEY_BYTES_INT8,
                                                          decode_split_plan)
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_plain)
    b, h, hkv, d, t = 32, 15, 5, 64, 370
    g = torch.Generator(device=dev)
    g.manual_seed(SEED + 11)
    q = torch.randn((b, h, d), generator=g, device=dev)
    sets, _ = C.int8_kv_sets(torch, dev, b, hkv, t, d,
                             C.cold_sets(2 * b * hkv * t * (d + 4)),
                             SEED + 12)
    kv_len = C.serve_kv_len(torch, dev, b, t, SEED + 11)
    want = decode_attention_plain(q, *sets[0][:2], kv_len, *sets[0][2:])
    out = torch.empty_like(q)
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def calls(lib, opts):
        splits = opts.get("splits", decode_split_plan(
            b, hkv, t, key_bytes=KEY_BYTES_INT8)[0])
        chunk = -(-t // splits)

        def one(k, v, ks, vs):
            rc = lib.variant_launch(ptr(q), ptr(k), ptr(v), ptr(ks), ptr(vs),
                                    ptr(kv_len), ptr(out), b, h, hkv, t,
                                    splits, chunk, stream)
            if rc:
                raise RuntimeError(f"launch failed: cuda error {rc}")
        return [lambda s_=s_: one(*s_) for s_ in sets]

    def check(lib, opts):
        calls(lib, opts)[0]()
        torch.cuda.synchronize()
        err = float((out - want).abs().max())
        if err > 1e-4:
            raise AssertionError(f"max abs err {err}")
        return err

    return calls, check, "decode_"


def race_case(torch, dev):
    """The launcher and check of each gls_row_race variant at the two
    serve shapes, each cycling through three L2 caches of tables; one
    variant call races both shapes."""
    import chip_smoke as C
    from repro_torch.kernels.gls_race.ops import row_race_split_plan
    from repro_torch.kernels.gls_race.ref import gls_row_race_plain
    shapes = []
    for rows, vocab in ((20, 49152), (5, 50280)):
        r, n = rows * C.K_DRAFTS, vocab
        sets = C.race_inputs(torch, dev, rows, vocab,
                             C.cold_sets(2 * r * n * 4), SEED)
        shapes.append((r, n, sets, gls_row_race_plain(*sets[0]),
                       torch.empty((r,), device=dev),
                       torch.empty((r,), dtype=torch.int32, device=dev)))
    stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)

    def calls(lib, opts):
        out = []
        for r, n, sets, _, rmin, rarg in shapes:
            splits = opts.get("splits", row_race_split_plan(r, n)[0])
            chunk = 4 * -(-(-(-n // splits)) // 4)

            def one(s_, q_, r=r, n=n, rmin=rmin, rarg=rarg, splits=splits,
                    chunk=chunk):
                rc = lib.variant_launch(ptr(s_), ptr(q_), ptr(rmin),
                                        ptr(rarg), r, n, splits, chunk,
                                        stream)
                if rc:
                    raise RuntimeError(f"launch failed: cuda error {rc}")
            out.append([lambda a=a, one=one: one(*a) for a in sets])
        return out

    def check(lib, opts):
        for shape_calls, (_, _, _, want, rmin, rarg) in zip(
                calls(lib, opts), shapes):
            shape_calls[0]()
            torch.cuda.synchronize()
            if not (torch.equal(rarg, want[1].flatten()) and torch.equal(
                    rmin.view(torch.int32),
                    want[0].flatten().view(torch.int32))):
                raise AssertionError("not bitwise equal to plain")
        return 0.0

    return calls, check, "gls_row_race"


def main(argv) -> int:
    import torch

    import chip_smoke as C
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=sorted(set(CASE_OF.values())),
                    default=sorted(set(CASE_OF.values())))
    ap.add_argument("--parent", help="a parent tree (git archive) whose "
                    "decode and race kernels run as variants too")
    args = ap.parse_args(argv)
    if args.parent:
        VARIANTS.update(PARENT_VARIANTS)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    names = [n for n, v in VARIANTS.items() if CASE_OF[v[0]] in args.only]
    built = build_all(names, args.parent)
    makers = {"ssd": ssd_case, "flash": flash_case, "decode": decode_case,
              "decode_int8": decode_int8_case, "race": race_case}
    cases = {c: makers[c](torch, dev) for c in args.only}

    def opts(name):
        return VARIANTS[name][2] if len(VARIANTS[name]) > 2 else {}

    def shape_calls(case, lib, name):
        """Per shape, the calls (one per input set) a timing cycles
        through."""
        if case in ("ssd", "flash"):
            run = cases[case][0]
            return [[lambda: run(lib)]]
        calls = cases[case][0](lib, opts(name))
        return [calls] if case in ("decode", "decode_int8") else calls

    libs, errs, failed = {}, {}, []
    for name, (lib_path, _) in built.items():
        case = CASE_OF[VARIANTS[name][0]]
        lib = ctypes.CDLL(os.fspath(lib_path))
        try:
            if case in ("ssd", "flash"):
                run, check = cases[case]
                run(lib)
                torch.cuda.synchronize()
                errs[name] = check()
            else:
                errs[name] = cases[case][1](lib, opts(name))
            libs[name] = lib
        except (RuntimeError, AssertionError) as e:
            failed.append(name)
            print(f"{name}: FAILED {e}", flush=True)
    times = {name: [] for name in libs}
    device = {}
    for case in args.only:
        names = [n for n in libs if CASE_OF[VARIANTS[n][0]] == case]
        for name in names + names[::-1]:
            times[name].append([C.time_cycled(c) for c in shape_calls(
                case, libs[name], name)])
        if case in ("decode", "decode_int8", "race"):
            for name in names:
                device[name] = [C.device_ms(torch, c, cases[case][2])
                                for c in shape_calls(case, libs[name], name)]
    for name, lib in libs.items():
        turns = " / ".join(", ".join(f"{t:.4f}" for t in ts)
                           for ts in times[name])
        dev_ms = (", device ms " + ", ".join(f"{t:.4f}" for t in device[name])
                  if name in device else "")
        print(f"{name}: {built[name][1]}, {lib.variant_blocks_per_sm()} "
              f"blocks per SM, ms {turns}{dev_ms}, max abs err "
              f"{errs[name]:.3g}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
