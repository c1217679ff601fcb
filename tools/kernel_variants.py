"""Time variants of the port's CUDA kernels.

  python3 tools/kernel_variants.py [--only KIND ...] [--parent DIR]
                                   [--match SUFFIX ...]

KIND is one of ssd, flash, flash_int8, flash_d128, flash_int8_d128,
decode, decode_g48, decode_g16, decode_int8, decode_int8_d128,
decode_int8_g48, decode_int8_g16, race, joint (default: all).

Needs one CUDA card and ``nvcc``.  A variant is a kernel's shipped source
(``src/repro_torch/kernels/<kernel>/<kernel>.cu``) with a few text
substitutions, each of which must match exactly once, and an
``extern "C"`` entry appended to it, through which ctypes calls it; the
shipped source itself is the baseline and goes through the same harness.
An entry may also bring a kernel of its own built from the shipped
file's pieces: the int8 decode on the tensor cores (``mma.sync``, K/V
exact in fp16, q and the weights split into fp16 hi + lo).  The floors
(the int8 decode's and the joint race's grid, clusters and data movement
with no arithmetic) ship in the kernels' sources, where ``chip_smoke.py``
times them through the extension; here they run beside the variants.
``--parent DIR`` (a tree unpacked with ``git archive``) adds the
parent's flash designs (the tensor-core kernel at D = 128 without the
``causal`` argument, and the SIMT int8 instance at D = 64) and, from
the tree before the int8 decode and joint race were redesigned, those
two.  Every
variant is built by ``nvcc`` (the port's flags, ``-Xptxas=-v``) into its
own shared library under ``build/kernel_variants/``, all builds started
together.
Nothing here is imported by the port.

At the shapes ``chip_smoke.py`` times (``ssd_chunk``: x (32, 4, 64, 32,
64), B/C (32, 4, 64, 128); ``flash_attention``: q (32, 15, 256, 64), k/v
(32, 5, 370, 64) with half the rows at offset 256, float32 and int8, and
at granite-8b's q (32, 32, 256, 128), k/v (32, 8, 370, 128), float32
and int8
(``chip_smoke.flash_inputs``; the check also gives the error against a
float64 evaluation beside the plain version's); ``decode_attention``:
q (32, 15, 64), four (32, 5, 370, 64) K/V sets and the serve's kv_len;
its int8 instance: the same q against int8 K/V sets with float32 scales,
worth three L2 caches, and at D = 128 granite-8b's q (32, 32, 128)
against (32, 8, 370, 128); ``gls_row_race``: (20, 8, 49152) and (5, 8,
50280); ``gls_race``: ``chip_smoke.joint_inputs`` at (20, 8, 49152);
the float32 group instance of ``decode_attention``: granite-34b's q (32,
48, 128) over (32, 1, T, 128) and llama3-405b's q (32, 128, 128) over
(32, 8, T, 128), each at T = 86 with the serve's kv_len and at T = 4,096
with every key live, its check also giving the error against a float64
evaluation beside the plain version's, beside its floor and, with
``--parent`` given the tree before it, the sub-group design it
replaced; its int8 instance likewise, over int8 K/V with float32 scales
(``chip_smoke.decode_int8_inputs``), against float64 of the dequantized
attention, beside its floor and, with ``--parent``, the int8 sub-groups
it replaced),
every variant is checked against the kernel's plain version
(``ssd_chunk`` 5e-4 abs + rel on y and the states, 1e-5 on the total;
attention 1e-4 abs; the races bitwise; floors and probes, which drop
part of the work, unchecked) and timed with CUDA events: the median of
25 samples of 10 back-to-back calls, the variants of a kernel in turn
and then in reverse order.  The decode and race variants cycle through
their input sets as ``chip_smoke.py`` does, so each call finds its inputs
cold in L2, and also report their device time per call from
``torch.profiler``.  A variant may fix the split plan (``splits``, or
the joint race's drafts a block ``kc``) that the wrapper would choose.
``--match`` keeps only the variants whose names end with one of the
given strings.  Prints per variant: registers, stack and spills
(ptxas), resident blocks per SM (the occupancy API; for the group
instance also the clusters of 4 the card holds), the two times (and the
device time) and the max abs error, then the card's name and power
limit.  Exits non-zero when a variant does not build or disagrees with
the plain version.
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
JOINT = ROOT / "src/repro_torch/kernels/gls_race/joint_race.cu"
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
    ("""  static constexpr int kOffV = 2 * kKStage;
  static constexpr int kOffGroups = kOffV + 2 * kVStage;""",
     """  static constexpr int kOffV = kKStage;
  static constexpr int kOffGroups = kOffV + kVStage;"""),
    ("""    if (it + 1 < n_tiles) {
      load_kv<D>(smem + (stage ^ 1) * kKStage,
                 smem + kOffV + (stage ^ 1) * kVStage, k, v, kv_base,
                 k0 + kBK, T);
    }
    const float* ks = smem + stage * kKStage;
    const float* vs = smem + kOffV + stage * kVStage;""",
     """    const float* ks = smem;
    const float* vs = smem + kOffV;"""),
    ("""    __syncwarp();  // P^T is rewritten by the next tile
  }""", """    __syncwarp();  // P^T is rewritten by the next tile
    if (it + 1 < n_tiles) {
      __syncthreads();
      load_kv<D>(smem, smem + kOffV, k, v, kv_base, k0 + kBK, T);
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
      q, k, v, q_offset, kv_len, out, B, H, Hkv, S, T, 64, window, 1,
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaPeekAtLastError());
}
extern "C" int variant_blocks_per_sm() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, flash_attention_kernel<64, true>, kGroup * Tile<64>::kMaxHeads,
      Smem<64>::bytes(Tile<64>::kMaxHeads));
  return n;
}
"""

# --- flash_attention on the tensor cores (D = 128; int8 at D = 64) ---------

# Variants of the shipped design (wgmma, flash_attention_tc_kernel<D, KV>).

# TF32 rounding by cvt.rna.tf32.f32 (the same values as the integer
# operations).
FLASH_TC_CVT = [
    ("  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;",
     '  uint32_t r;\n  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(r) : "f"(x));\n'
     "  return r;")]
# lo rounded to TF32 as well.
FLASH_TC_ROUNDED_LO = [("  lo = __float_as_uint(x - __uint_as_float(hi));",
                        "  lo = tf32_bits(x - __uint_as_float(hi));")]
# The output rows divided by their sums (one division an element) in place
# of a multiply by the reciprocal.
FLASH_TC_DIVIDE = [
    ("      const float inv = 1.f / fmaxf(lt, 1e-30f);\n"
     "      float* orow = out + q_base + static_cast<size_t>(s) * kD + 2 * t;",
     "      const float den = fmaxf(lt, 1e-30f);\n"
     "      float* orow = out + q_base + static_cast<size_t>(s) * kD + 2 * t;"),
    ("            make_float2(o[j][2 * rr] * inv, o[j][2 * rr + 1] * inv);",
     "            make_float2(o[j][2 * rr] / den, o[j][2 * rr + 1] / den);")]
FLASH_TC_ENTRY = """
extern "C" int variant_launch(const float* q, const void* k, const void* v,
                              const float* k_scale, const float* v_scale,
                              const int* q_offset, const int* kv_len,
                              float* out, int B, int H, int Hkv, int S, int T,
                              int window, void* stream) {
  const cudaError_t err = @LAUNCH@(
      q, static_cast<const @KV@*>(k), static_cast<const @KV@*>(v), @SCALES@
      q_offset, kv_len, out, B, H, Hkv, S, T, @D@, window,@CAUSAL@
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaPeekAtLastError());
}
extern "C" int variant_blocks_per_sm() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, @OCCUPANCY@);
  return n;
}
"""


def _flash_tc_entry(d: int, int8: bool, parent: bool) -> str:
    """The entry of the shipped tensor-core design at head dim ``d``, or
    the parent's (its launchers take no ``causal``; at D = 128 its kernel
    was flash_attention_tc_kernel<KV>, at D = 64 the SIMT
    flash_attention_kernel<64, KV>) through the file's launchers."""
    kv = "int8_t" if int8 else "float"
    if not parent:
        occupancy = (f"flash_attention_tc_kernel<{d}, {kv}>, kTcThreads, "
                     f"TcLayout<{d}, {kv}>::kBytes")
    elif d == 128:
        occupancy = (f"flash_attention_tc_kernel<{kv}>, kTcThreads, "
                     f"TcLayout<{kv}>::kBytes")
    else:
        occupancy = (f"flash_attention_kernel<64, {kv}>, kGroup * "
                     f"Tile<64>::kMaxHeads, Smem<64, {kv}>::bytes("
                     f"Tile<64>::kMaxHeads)")
    return (FLASH_TC_ENTRY
            .replace("@LAUNCH@", "launch_flash_attention_int8" if int8
                     else "launch_flash_attention")
            .replace("@KV@", kv)
            .replace("@SCALES@", "k_scale, v_scale," if int8 else "")
            .replace("@D@", str(d))
            .replace("@CAUSAL@", "" if parent else " 1,")
            .replace("@OCCUPANCY@", occupancy))


# The shape of the int8 instance at D = 64 (TcShape<64, int8_t>): keys a
# K/V tile, stage sets, blocks per SM (the launch bound).
_TC_SHAPE_64 = re.search(r"struct TcShape<64, int8_t> \{.*?\};",
                         FLASH.read_text(), re.S).group(0)


def flash_int8_shape(keys: int, stages: int, blocks: int):
    """The substitution that sets TcShape<64, int8_t>."""
    return [(_TC_SHAPE_64, f"""struct TcShape<64, int8_t> {{
  static constexpr int kKeys = {keys};
  static constexpr int kStages = {stages};
  static constexpr int kMinBlocks = {blocks};
}};""")]


# --- decode_attention, float32 ---------------------------------------------

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
  if (split == 0) {
    for (int i = tid; i < G * kD; i += kThreads) {""", """  if (false) {
    for (int i = tid; i < G * kD; i += kThreads) {"""),
    ("""kD + d] = num / fmaxf(den, 1e-30f);
    }
  }
}""", """kD + d] = num / fmaxf(den, 1e-30f);
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
}"""),
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
  if (split == 0) {
    for (int i = tid; i < G * kD; i += kThreads) {""", """  cluster.sync();
  if (split == 0) {
    for (int i = tid; i < G * kD; i += kThreads) {"""),
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
    ("""  const long long first = static_cast<long long>(split) * chunk;
  const int k0 = first < len ? static_cast<int>(first) : len;
  const int n = min(chunk, len - k0);
  const int n_tiles = (n + tk - 1) / tk;
  const size_t kv_base =
      ((static_cast<size_t>(b) * Hkv + kvh) * T + k0) * kD;""",
     """  const int cb = (len + splits - 1) / splits;
  const long long first = static_cast<long long>(split) * cb;
  const int k0 = first < len ? static_cast<int>(first) : len;
  const int n = min(cb, len - k0);
  const int n_tiles = (n + tk - 1) / tk;
  const size_t kv_base =
      ((static_cast<size_t>(b) * Hkv + kvh) * T + k0) * kD;"""),
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
      &n, decode_attention_kernel<64, 3>, kThreads,
      Layout<64>{64, 2, 3, 2}.bytes());
  return n;
}
"""
DECODE_TWO_PASS_ENTRY = DECODE_ENTRY.replace(
    "  return static_cast<int>(err != cudaSuccess ? err : "
    "cudaPeekAtLastError());\n}",
    "  if (err != cudaSuccess) return static_cast<int>(err);\n"
    "  decode_merge_kernel<<<dim3(Hkv, B), kThreads, 0,\n"
    "                        static_cast<cudaStream_t>(stream)>>>(\n"
    "      out, H, Hkv, splits);\n"
    "  return static_cast<int>(cudaPeekAtLastError());\n}", 1)

# --- decode_attention, float32 group instance (a GQA group above 8) ----------

# At group @G@ (head dim 128) through the shipped launcher.
DECODE_GROUP_ENTRY = """
extern "C" int variant_launch(const float* q, const float* k, const float* v,
                              const int* kv_len, float* out, int B, int H,
                              int Hkv, int T, int splits, int chunk,
                              void* stream) {
  const cudaError_t err = @LAUNCH@(
      q, k, v, kv_len, out, B, H, Hkv, T, 128, splits, chunk,
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaPeekAtLastError());
}
using VariantLayout = GLayout<128, (@G@ + 15) / 16, float>;
const auto kVariantKernel =
    decode_attention_group_kernel<128, (@G@ + 15) / 16, float, @FLOOR@>;
extern "C" int variant_blocks_per_sm() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, kVariantKernel, 32 * VariantLayout::kWarps, VariantLayout::kBytes);
  return n;
}
// Clusters of `splits` blocks the card holds at once.
extern "C" int variant_max_clusters(int splits) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(splits, 32, 32);
  cfg.blockDim = dim3(32 * VariantLayout::kWarps);
  cfg.dynamicSmemBytes = VariantLayout::kBytes;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = splits;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int n = 0;
  cudaOccupancyMaxActiveClusters(&n, kVariantKernel, &cfg);
  return n;
}
"""
# The sub-group design the group instance replaced (G = 8 instances over
# Hkv x group / 8 head slots), from a tree given by ``--parent``.
PARENT_DECODE_GROUP_ENTRY = """
extern "C" int variant_launch(const float* q, const float* k, const float* v,
                              const int* kv_len, float* out, int B, int H,
                              int Hkv, int T, int splits, int chunk,
                              void* stream) {
  const cudaError_t err = launch_decode_attention(
      q, k, v, kv_len, out, B, H, Hkv, T, 128, splits, chunk,
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaPeekAtLastError());
}
extern "C" int variant_blocks_per_sm() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, decode_attention_kernel<128, 8>, kThreads,
      Layout<128>{32, 2, 8, 1}.bytes());
  return n;
}
"""


def _group_entry(g: int, floor: bool = False) -> str:
    return (DECODE_GROUP_ENTRY.replace("@G@", str(g))
            .replace("@FLOOR@", "true" if floor else "false")
            .replace("@LAUNCH@", "launch_decode_attention_group_floor"
                     if floor else "launch_decode_attention"))


def group_slices(n: int):
    """``n`` key slices a block of the group instance, whatever its
    m-tiles and K/V type (shipped: 4 at 3 m-tiles and for int8, 2
    below)."""
    return [("  return int8 || mt == 3 ? 4 : 2;", f"  return {n};")]


# Probes of where the group instance's time goes (not decodes): the
# scores' or P V's mma.sync dropped, their operands still loaded and
# split.
GROUP_NO_SCORE_MMA = [("""      mma_tf32(sx[nt], al[0], al[1], al[2], al[3], bh[0], bh[1]);
      mma_tf32(sx[nt], ah[0], ah[1], ah[2], ah[3], bl[0], bl[1]);
      mma_tf32(sc[nt], ah[0], ah[1], ah[2], ah[3], bh[0], bh[1]);
      mma_tf32(sx[nt], al[4], al[5], al[6], al[7], bh[2], bh[3]);
      mma_tf32(sx[nt], ah[4], ah[5], ah[6], ah[7], bl[2], bl[3]);
      mma_tf32(sc[nt], ah[4], ah[5], ah[6], ah[7], bh[2], bh[3]);""",
                       """      sc[nt][0] += __uint_as_float(al[0] ^ bh[0] ^ ah[4] ^ bl[2]);
      sx[nt][1] += __uint_as_float(al[1] ^ bl[1] ^ ah[5] ^ bh[3]);
      sc[nt][2] += __uint_as_float(ah[2] ^ al[6] ^ bl[0] ^ bh[2]);
      sx[nt][3] += __uint_as_float(ah[3] ^ al[7] ^ bh[1] ^ bl[3]);""")]
GROUP_NO_PV_MMA = [("""        mma_tf32(pv[j4], pl[0], pl[1], pl[2], pl[3], h0, h1);
        mma_tf32(pv[j4], ph[0], ph[1], ph[2], ph[3], lo0, lo1);
        mma_tf32(pv[j4], ph[0], ph[1], ph[2], ph[3], h0, h1);""",
                    """        pv[j4][0] += __uint_as_float(h0 ^ pl[0] ^ ph[2]);
        pv[j4][1] += __uint_as_float(lo0 ^ pl[1] ^ ph[3]);
        pv[j4][2] += __uint_as_float(h1 ^ pl[2] ^ ph[0]);
        pv[j4][3] += __uint_as_float(lo1 ^ pl[3] ^ ph[1]);""")]


# --- decode_attention, int8 group instance (a GQA group above 8) -------------

# At group @G@ (head dim 128, @MT@ m-tiles: the instance of the plan over
# 4,096 keys) through the shipped launcher, `slots` head slots a KV head.
DECODE_INT8_GROUP_ENTRY = """
extern "C" int variant_launch(const float* q, const int8_t* k,
                              const int8_t* v, const float* k_scale,
                              const float* v_scale, const int* kv_len,
                              float* out, int B, int H, int Hkv, int T,
                              int splits, int chunk, int slots,
                              void* stream) {
  const cudaError_t err = @LAUNCH@(
      q, k, v, k_scale, v_scale, kv_len, out, B, H, Hkv, T, 128, splits,
      chunk, slots, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaPeekAtLastError());
}
using VariantLayout = GLayout<128, @MT@, int8_t>;
const auto kVariantKernel =
    decode_attention_group_kernel<128, @MT@, int8_t, @FLOOR@>;
""" + DECODE_GROUP_ENTRY[DECODE_GROUP_ENTRY.index(
    'extern "C" int variant_blocks_per_sm'):]
# The sub-group design the int8 group instance replaced (the G = 8 int8
# instance over Hkv x group / 8 head slots, each streaming the K/V row),
# from a tree given by ``--parent`` (`slots` unused).
PARENT_DECODE_INT8_GROUP_ENTRY = """
extern "C" int variant_launch(const float* q, const int8_t* k,
                              const int8_t* v, const float* k_scale,
                              const float* v_scale, const int* kv_len,
                              float* out, int B, int H, int Hkv, int T,
                              int splits, int chunk, int slots,
                              void* stream) {
  const cudaError_t err = launch_decode_attention_int8(
      q, k, v, k_scale, v_scale, kv_len, out, B, H, Hkv, T, 128, splits,
      chunk, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaPeekAtLastError());
}
extern "C" int variant_blocks_per_sm() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, decode_attention_kernel_int8<128, 8>, kQThreads,
      QLayout<128>{QDims<128>::kTK, kQStages, 8, 1}.bytes());
  return n;
}
"""


def _int8_group_entry(g: int, floor: bool = False) -> str:
    return (DECODE_INT8_GROUP_ENTRY.replace("@MT@", "3" if g == 48 else "1")
            .replace("@FLOOR@", "true" if floor else "false")
            .replace("@LAUNCH@", "launch_decode_attention_int8_floor"
                     if floor else "launch_decode_attention_int8"))


# Three blocks an SM of one m-tile under the register cap (170 a thread).
GROUP_3_BLOCKS = [("group_slices(MT, sizeof(KV) == 1), 1)",
                   "group_slices(MT, sizeof(KV) == 1), MT == 1 ? 3 : 1)")]


def int8_group_stages(n: int):
    """``n`` stages a key slice of the int8 group instance (shipped 2)."""
    return [("constexpr int kGInt8Stages = 2;",
             f"constexpr int kGInt8Stages = {n};")]


# Probes of the int8 group instance (not decodes): the scores' or P V's
# mma.sync dropped, their operands still loaded, converted and split.
INT8_GROUP_NO_SCORE_MMA = [("""        mma_tf32(sx[nt], al[0], al[1], al[2], al[3], b0, b1);
        mma_tf32(sc[nt], ah[0], ah[1], ah[2], ah[3], b0, b1);
        mma_tf32(sx[nt], al[4], al[5], al[6], al[7], b2, b3);
        mma_tf32(sc[nt], ah[4], ah[5], ah[6], ah[7], b2, b3);""",
                            """        sc[nt][0] += __uint_as_float(al[0] ^ b0 ^ ah[4] ^ b2);
        sx[nt][1] += __uint_as_float(al[1] ^ b1 ^ ah[5] ^ b3);
        sc[nt][2] += __uint_as_float(ah[2] ^ al[6] ^ b0 ^ b2);
        sx[nt][3] += __uint_as_float(ah[3] ^ al[7] ^ b1 ^ b3);""")]
INT8_GROUP_NO_PV_MMA = [("""        mma_tf32(pv[j4], pl[nt][0], pl[nt][1], pl[nt][2], pl[nt][3], b0,
                 b1);
        mma_tf32(pv[j4], ph[nt][0], ph[nt][1], ph[nt][2], ph[nt][3], b0,
                 b1);""", """        pv[j4][0] += __uint_as_float(b0 ^ pl[nt][0] ^ ph[nt][2]);
        pv[j4][1] += __uint_as_float(b1 ^ pl[nt][1] ^ ph[nt][3]);
        pv[j4][2] += __uint_as_float(b0 ^ pl[nt][2] ^ ph[nt][0]);
        pv[j4][3] += __uint_as_float(b1 ^ pl[nt][3] ^ ph[nt][1]);""")]
# ... the int8-to-float conversions of K or of V dropped (the words' bits
# taken as they are), or q's hi + lo split (q's bits as both).
INT8_GROUP_NO_K_CONVERT = [("""        s8x4_to_f32(static_cast<uint32_t>(w), kf);""",
                            """        kf[0] = kf[1] = kf[2] = kf[3] = __int_as_float(w);""")]
INT8_GROUP_NO_V_CONVERT = [("""      s8x4_to_f32(*reinterpret_cast<const uint32_t*>(
                      vst + min(8 * nt + 2 * t, nk - 1) * D + 32 * c + 4 * g),
                  xa);
      s8x4_to_f32(
          *reinterpret_cast<const uint32_t*>(
              vst + min(8 * nt + 2 * t + 1, nk - 1) * D + 32 * c + 4 * g),
          xb);""", """      xa[0] = xa[1] = xa[2] = xa[3] = __uint_as_float(
          *reinterpret_cast<const uint32_t*>(
              vst + min(8 * nt + 2 * t, nk - 1) * D + 32 * c + 4 * g));
      xb[0] = xb[1] = xb[2] = xb[3] = __uint_as_float(
          *reinterpret_cast<const uint32_t*>(
              vst + min(8 * nt + 2 * t + 1, nk - 1) * D + 32 * c + 4 * g));""")]
INT8_GROUP_NO_Q_SPLIT = [("""      split_q(*reinterpret_cast<const float4*>(qa_row + at),
              *reinterpret_cast<const float4*>(qb_row + at), ah, al);""",
                          """      {
        const float4 qa = *reinterpret_cast<const float4*>(qa_row + at);
        const float4 qb = *reinterpret_cast<const float4*>(qb_row + at);
        const float qf[8] = {qa.x, qb.x, qa.y, qb.y, qa.z, qb.z, qa.w, qb.w};
#pragma unroll
        for (int u = 0; u < 8; ++u) ah[u] = al[u] = __float_as_uint(qf[u]);
      }""")]


# --- decode_attention, int8 --------------------------------------------------

# The int8 instance at head dim D (group G: smollm-360m's 3 at D = 64,
# granite-8b's 4 at D = 128), through the shipped launcher.
DECODE_INT8_ENTRY = """
extern "C" int variant_launch(const float* q, const int8_t* k,
                              const int8_t* v, const float* k_scale,
                              const float* v_scale, const int* kv_len,
                              float* out, int B, int H, int Hkv, int T,
                              int splits, int chunk, void* stream) {
  const cudaError_t err = launch_decode_attention_int8(
      q, k, v, k_scale, v_scale, kv_len, out, B, H, Hkv, T, @D@, splits,
      chunk, 1, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaPeekAtLastError());
}
extern "C" int variant_blocks_per_sm() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, decode_attention_kernel_int8<@D@, @G@>, kQThreads,
      QLayout<@D@>{QDims<@D@>::kTK, kQStages, @G@, 1}.bytes());
  return n;
}
"""
# The floor of the int8 design (`decode_int8_floor_kernel`, shipped in
# decode_attention.cu): its grid, clusters, shared memory and data
# movement, no arithmetic.  Not a decode: its output is not checked.
DECODE_INT8_FLOOR_ENTRY = """
extern "C" int variant_launch(const float* q, const int8_t* k,
                              const int8_t* v, const float* k_scale,
                              const float* v_scale, const int* kv_len,
                              float* out, int B, int H, int Hkv, int T,
                              int splits, int chunk, void* stream) {
  const cudaError_t err = launch_decode_attention_int8_floor(
      q, k, v, k_scale, v_scale, kv_len, out, B, H, Hkv, T, @D@, splits,
      chunk, 1, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaPeekAtLastError());
}
extern "C" int variant_blocks_per_sm() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, decode_int8_floor_kernel<@D@, @G@>, kQThreads,
      QLayout<@D@>{QDims<@D@>::kTK, kQStages, @G@, 1}.bytes());
  return n;
}
"""
# The parent design of the int8 instance (the float32 instance's chain
# and tiles with int8 loads), from a tree given by ``--parent``.
PARENT_DECODE_INT8_ENTRY = """
extern "C" int variant_launch(const float* q, const int8_t* k,
                              const int8_t* v, const float* k_scale,
                              const float* v_scale, const int* kv_len,
                              float* out, int B, int H, int Hkv, int T,
                              int splits, int chunk, void* stream) {
  const cudaError_t err = launch_decode_attention_int8(
      q, k, v, k_scale, v_scale, kv_len, out, B, H, Hkv, T, @D@, splits,
      chunk, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaPeekAtLastError());
}
extern "C" int variant_blocks_per_sm() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, decode_attention_kernel<@D@, @G@, int8_t>, kThreads,
      Layout<@D@>{Dims<@D@>::kTK, 1, @G@, 2, 1}.bytes());
  return n;
}
"""
# The int8 instance on the tensor cores: its own kernel beside the
# shipped one, the same tiles, layout and launcher.
DECODE_INT8_MMA_ENTRY = r"""
#include <cuda_fp16.h>
namespace {

// An int8 pair of the word `u` (the int8 word xor 0x80808080) as an fp16
// pair, exactly: the bytes at `sel` become the low bytes of fp16 1024 +
// x + 128 (exponent byte 0x64), less 1152.
__device__ __forceinline__ uint32_t s8pair_to_h2(uint32_t u, uint32_t sel) {
  const uint32_t h = __byte_perm(u, 0x64646464u, sel);
  uint32_t r;
  asm("sub.f16x2 %0, %1, %2;" : "=r"(r) : "r"(h), "r"(0x64806480u));
  return r;
}

__device__ __forceinline__ uint32_t h2_bits(__half2 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// (a, b) as an fp16 pair and the pair of what it leaves out.
__device__ __forceinline__ void split_h2(float a, float b, uint32_t& hi,
                                         uint32_t& lo) {
  const __half2 h = __floats2half2_rn(a, b);
  const float2 f = __half22float2(h);
  hi = h2_bits(h);
  lo = h2_bits(__floats2half2_rn(a - f.x, b - f.y));
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// One head's 32 weights in fp16, their 16 pairs' order xor-swizzled by
// head so that a warp's B loads (eight heads, four pairs each) hit 32
// distinct banks.
__device__ __forceinline__ int p_index(int head, int kk) {
  return 32 * head + 2 * ((kk >> 1) ^ (4 * ((head >> 1) & 3))) + (kk & 1);
}
__device__ __forceinline__ int p_word(int head, int w) {
  return 16 * head + (w ^ (4 * ((head >> 1) & 3)));
}

// The int8 instance on the tensor cores: per warp chunk of 32 keys,
// S^T = K Q^T and out^T += V^T P^T by mma.sync m16n8k16 (f16 in, f32
// accumulate), K and V exact in fp16, q and P (times 1024) split into
// fp16 hi + lo.  The D columns are permuted so that a thread's A bytes of
// K are one 16-byte run (column 16 tig + 4 s + j at D = 64, 32 tig + 4 s
// + j at D = 128, for k-step s and j = 0..3), q the same; V comes by
// ldmatrix.trans of int8 pairs, the output columns permuted (logical
// row g of an m-tile is column 2 g, row g + 8 column 2 g + 1).
template <int D, int G>
__global__ void __launch_bounds__(kQThreads, 512 / kQThreads)
decode_int8_mma_kernel(const float* __restrict__ q,
                       const int8_t* __restrict__ k,
                       const int8_t* __restrict__ v,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ kv_len,
                       float* __restrict__ out, int H, int Hkv, int T,
                       int chunk, int tk, int stages) {
  using QD = QDims<D>;
  constexpr int kKS = D / 16;   // k-steps of S, m-tiles of out^T
  constexpr int kNC = QD::kChunks, kPart = QD::kPart;
  constexpr int kTB = D / 4;    // bytes of a row per thread group
  constexpr float kScale = D == 64 ? 0.125f : 0.08838834764831845f;
  constexpr float kPScale = 1024.f;
  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x;
  const int splits = gridDim.x;
  if (splits > 1) cluster_arrive_relaxed();
  const int slot = blockIdx.y, kvh = slot, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, tig = lane & 3;
  extern __shared__ __align__(16) unsigned char qsmem[];
  const QLayout<D> lay{tk, stages, G, splits};
  float* q_s = reinterpret_cast<float*>(qsmem + lay.q_off());
  __half* p_hi = reinterpret_cast<__half*>(qsmem + lay.p_off()) +
                 warp * 2 * G * 32;
  __half* p_lo = p_hi + G * 32;
  float* wpart = reinterpret_cast<float*>(qsmem);
  float* bpart = reinterpret_cast<float*>(qsmem + lay.block_off());
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
  const float4* qb4 = reinterpret_cast<const float4*>(
      q + (static_cast<size_t>(b) * H + static_cast<size_t>(slot) * G) * D);
  for (int i = tid; i < G * D / 4; i += kQThreads) {
    const int gg = i / (D / 4), c4 = i % (D / 4);
    reinterpret_cast<float4*>(q_s + (gg * kNC + c4 / 4) * kQPad)[c4 % 4] =
        __ldg(qb4 + i);
  }
  __syncthreads();

  // q's B fragments (hi, lo) for head g, times a power of 2 that keeps
  // its largest magnitude in fp16's range.
  float qv[kKS][4];
  float qmax = 0.f;
#pragma unroll
  for (int s = 0; s < kKS; ++s) {
    const int c = kTB * tig + 4 * s;
    float4 t4 = make_float4(0.f, 0.f, 0.f, 0.f);
    if (g < G) {
      t4 = *reinterpret_cast<const float4*>(q_s + (g * kNC + c / 16) * kQPad +
                                            c % 16);
    }
    qv[s][0] = t4.x;
    qv[s][1] = t4.y;
    qv[s][2] = t4.z;
    qv[s][3] = t4.w;
    qmax = fmaxf(qmax, fmaxf(fmaxf(fabsf(t4.x), fabsf(t4.y)),
                             fmaxf(fabsf(t4.z), fabsf(t4.w))));
  }
  qmax = fmaxf(qmax, __shfl_xor_sync(0xffffffffu, qmax, 1));
  qmax = fmaxf(qmax, __shfl_xor_sync(0xffffffffu, qmax, 2));
  const float qscale =
      qmax > 16384.f ? exp2f(-ceilf(log2f(qmax / 16384.f))) : 1.f;
  uint32_t qf[kKS][2][2];  // [step][hi, lo][b0b1, b2b3]
#pragma unroll
  for (int s = 0; s < kKS; ++s) {
    split_h2(qv[s][0] * qscale, qv[s][1] * qscale, qf[s][0][0], qf[s][1][0]);
    split_h2(qv[s][2] * qscale, qv[s][3] * qscale, qf[s][0][1], qf[s][1][1]);
  }
  // The scores' heads of this thread's C elements: 2 tig and 2 tig + 1.
  const float kinv0 = kScale / __shfl_sync(0xffffffffu, qscale, 8 * tig);
  const float kinv1 = kScale / __shfl_sync(0xffffffffu, qscale, 8 * tig + 4);

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[kKS][4];
#pragma unroll
  for (int s = 0; s < kKS; ++s) acc[s][0] = acc[s][1] = acc[s][2] = acc[s][3] = 0.f;
  const int gc = g < G ? g : G - 1;  // the P row this thread's B reads
  for (int j = 0; j < n_tiles; ++j) {
    const int s_ = j % stages;
    const uint32_t parity = (j / stages) & 1;
    const int nk = min(tk, n - j * tk);
    const ScaleSpan sp(e_base, numel, j, tk, nk);
    const unsigned char* st = qsmem + s_ * lay.stage_bytes();
    const int8_t* ks = reinterpret_cast<const int8_t*>(st);
    const int8_t* vs = ks + tk * D;
    const float* kss =
        reinterpret_cast<const float*>(st + 2 * tk * D) + (sp.e0 & 3);
    const float* vss = kss + lay.scale_floats();
    mbar_wait(&full[s_], parity);
    for (int c0 = 32 * warp; c0 < nk; c0 += 32 * kQWarps) {
      const int nc = min(32, nk - c0);
      // S^T for keys c0 + 16 mt + g (+ 8), heads 2 tig (+ 1).
      float sacc[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        sacc[mt][0] = sacc[mt][1] = sacc[mt][2] = sacc[mt][3] = 0.f;
        const int ra = c0 + min(16 * mt + g, nc - 1);
        const int rb = c0 + min(16 * mt + g + 8, nc - 1);
        uint32_t wa[kKS], wb[kKS];
#pragma unroll
        for (int h = 0; h < kKS / 4; ++h) {
          const int4 xa = *reinterpret_cast<const int4*>(ks + ra * D + kTB * tig + 16 * h);
          const int4 xb = *reinterpret_cast<const int4*>(ks + rb * D + kTB * tig + 16 * h);
          wa[4 * h] = xa.x; wa[4 * h + 1] = xa.y; wa[4 * h + 2] = xa.z; wa[4 * h + 3] = xa.w;
          wb[4 * h] = xb.x; wb[4 * h + 1] = xb.y; wb[4 * h + 2] = xb.z; wb[4 * h + 3] = xb.w;
        }
#pragma unroll
        for (int s = 0; s < kKS; ++s) {
          const uint32_t ua = wa[s] ^ 0x80808080u, ub = wb[s] ^ 0x80808080u;
          const uint32_t a[4] = {s8pair_to_h2(ua, 0x4140), s8pair_to_h2(ub, 0x4140),
                                 s8pair_to_h2(ua, 0x4342), s8pair_to_h2(ub, 0x4342)};
          mma16816(sacc[mt], a, qf[s][0][0], qf[s][0][1]);
          mma16816(sacc[mt], a, qf[s][1][0], qf[s][1][1]);
        }
      }
      // Scores, masked; each head's max over the chunk (the thread's
      // four keys, then the eight groups).
      float sc[2][4], vm[2][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int kk = 16 * mt + g + 8 * hh;
          const bool valid = kk < nc;
          const int t = c0 + (valid ? kk : 0);
          const size_t e = sp.e0 + t;
          float kmul, vmv;
          if (e < sp.hi) {
            kmul = kss[t];
            vmv = vss[t];
          } else {
            kmul = __ldg(k_scale + e);
            vmv = __ldg(v_scale + e);
          }
          vm[mt][hh] = vmv;
          sc[mt][2 * hh] = valid ? sacc[mt][2 * hh] * kmul * kinv0 : -INFINITY;
          sc[mt][2 * hh + 1] =
              valid ? sacc[mt][2 * hh + 1] * kmul * kinv1 : -INFINITY;
        }
      }
      float alpha[2], msafe[2];
#pragma unroll
      for (int jh = 0; jh < 2; ++jh) {
        float mx = fmaxf(fmaxf(sc[0][jh], sc[0][2 + jh]),
                         fmaxf(sc[1][jh], sc[1][2 + jh]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
        const float m_new = fmaxf(m[jh], mx);
        msafe[jh] = isfinite(m_new) ? m_new : 0.f;
        alpha[jh] = isfinite(m[jh]) ? expf(m[jh] - msafe[jh]) : 0.f;
        m[jh] = m_new;
        l[jh] *= alpha[jh];
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int jh = e & 1, hh = e >> 1;
          const float p = expf(sc[mt][e] - msafe[jh]);
          l[jh] += p;
          const int head = 2 * tig + jh;
          if (head < G) {
            const float w = p * vm[mt][hh] * kPScale;
            const __half wh = __float2half_rn(w);
            const int kk = 16 * mt + g + 8 * hh;
            p_hi[p_index(head, kk)] = wh;
            p_lo[p_index(head, kk)] = __float2half_rn(w - __half2float(wh));
          }
        }
      }
#pragma unroll
      for (int s = 0; s < kKS; ++s) {
        acc[s][0] *= alpha[0];
        acc[s][1] *= alpha[1];
        acc[s][2] *= alpha[0];
        acc[s][3] *= alpha[1];
      }
      __syncwarp();
      // out^T += V^T P^T, m-tile s: columns 16 s + 2 g (row g) and
      // 16 s + 2 g + 1 (row g + 8); lane L brings key c0 + L's row.
      const uint32_t* phw = reinterpret_cast<const uint32_t*>(p_hi);
      const uint32_t* plw = reinterpret_cast<const uint32_t*>(p_lo);
      uint32_t bh[4], bl[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        bh[w] = phw[p_word(gc, tig + 4 * w)];
        bl[w] = plw[p_word(gc, tig + 4 * w)];
      }
      const int8_t* vrow = vs + (c0 + min(lane, nc - 1)) * D;
#pragma unroll
      for (int s = 0; s < kKS; ++s) {
        uint32_t r[4];
        ldsm_x4_trans(r, vrow + 16 * s);
#pragma unroll
        for (int ks2 = 0; ks2 < 2; ++ks2) {
          const uint32_t u0 = r[2 * ks2] ^ 0x80808080u;
          const uint32_t u1 = r[2 * ks2 + 1] ^ 0x80808080u;
          const uint32_t a[4] = {s8pair_to_h2(u0, 0x4240), s8pair_to_h2(u0, 0x4341),
                                 s8pair_to_h2(u1, 0x4240), s8pair_to_h2(u1, 0x4341)};
          mma16816(acc[s], a, bh[2 * ks2], bh[2 * ks2 + 1]);
          mma16816(acc[s], a, bl[2 * ks2], bl[2 * ks2 + 1]);
        }
      }
      __syncwarp();  // the weights are rewritten by the next chunk
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s_]);
    if (tid == 0 && j + stages < n_tiles) {
      mbar_wait(&empty[s_], parity);
      load_tile_int8<D>(qsmem, lay, full, k, v, k_scale, v_scale, e_base,
                        numel, j + stages, n);
    }
  }
#pragma unroll
  for (int jh = 0; jh < 2; ++jh) {
    l[jh] += __shfl_xor_sync(0xffffffffu, l[jh], 4);
    l[jh] += __shfl_xor_sync(0xffffffffu, l[jh], 8);
    l[jh] += __shfl_xor_sync(0xffffffffu, l[jh], 16);
  }
  __syncthreads();
#pragma unroll
  for (int jh = 0; jh < 2; ++jh) {
    const int head = 2 * tig + jh;
    if (head < G) {
      float* wp = wpart + (warp * G + head) * kPart;
      if (g == 0) {
        wp[0] = m[jh];
        wp[1] = l[jh];
      }
#pragma unroll
      for (int s = 0; s < kKS; ++s) {
        wp[2 + 16 * s + 2 * g] = acc[s][jh] * (1.f / kPScale);
        wp[2 + 16 * s + 2 * g + 1] = acc[s][2 + jh] * (1.f / kPScale);
      }
    }
  }
  __syncthreads();
  float* orow =
      out + (static_cast<size_t>(b) * H + static_cast<size_t>(slot) * G) * D;
  float* rpart = bpart;
  if (splits > 1) {
    cluster_wait();
    rpart = cluster.map_shared_rank(bpart, 0) + split * G * kPart;
  }
  for (int i = tid; i < G * D; i += kQThreads) {
    const int gg = i / D, d = i % D;
    float mw[kQWarps];
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kQWarps; ++w) {
      mw[w] = wpart[(w * G + gg) * kPart];
      mx = fmaxf(mx, mw[w]);
    }
    const float m_safe = isfinite(mx) ? mx : 0.f;
    float ls = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kQWarps; ++w) {
      const float sw = isfinite(mw[w]) ? expf(mw[w] - m_safe) : 0.f;
      ls = fmaf(sw, wpart[(w * G + gg) * kPart + 1], ls);
      a = fmaf(sw, wpart[(w * G + gg) * kPart + 2 + d], a);
    }
    if (splits == 1) {
      orow[i] = a / fmaxf(ls, 1e-30f);
    } else {
      rpart[gg * kPart + 2 + d] = a;
      if (d == 0) {
        rpart[gg * kPart] = mx;
        rpart[gg * kPart + 1] = ls;
      }
    }
  }
  if (splits == 1) return;
  cluster_arrive();
  cluster_wait();
  if (split == 0) {
    for (int i = tid; i < G * D; i += kQThreads) {
      const int gg = i / D, d = i % D;
      float mx = -INFINITY;
      for (int r = 0; r < splits; ++r) mx = fmaxf(mx, bpart[(r * G + gg) * kPart]);
      const float m_safe = isfinite(mx) ? mx : 0.f;
      float den = 0.f, num = 0.f;
      for (int r = 0; r < splits; ++r) {
        const float* pr = bpart + (r * G + gg) * kPart;
        const float sr = isfinite(pr[0]) ? expf(pr[0] - m_safe) : 0.f;
        den = fmaf(sr, pr[1], den);
        num = fmaf(sr, pr[2 + d], num);
      }
      orow[i] = num / fmaxf(den, 1e-30f);
    }
  }
}

template <int D>
constexpr Int8Kernel kInt8Mma[kMaxG] = {
    decode_int8_mma_kernel<D, 1>, decode_int8_mma_kernel<D, 2>,
    decode_int8_mma_kernel<D, 3>, decode_int8_mma_kernel<D, 4>,
    decode_int8_mma_kernel<D, 5>, decode_int8_mma_kernel<D, 6>,
    decode_int8_mma_kernel<D, 7>, decode_int8_mma_kernel<D, 8>};
}  // namespace

extern "C" int variant_launch(const float* q, const int8_t* k,
                              const int8_t* v, const float* k_scale,
                              const float* v_scale, const int* kv_len,
                              float* out, int B, int H, int Hkv, int T,
                              int splits, int chunk, void* stream) {
  static bool granted[64][kMaxG] = {};
  const cudaError_t err = launch_int8<@D@>(
      kInt8Mma<@D@>, granted, q, k, v, k_scale, v_scale, kv_len, out, B, H,
      Hkv, T, splits, chunk, static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaPeekAtLastError());
}
extern "C" int variant_blocks_per_sm() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, decode_int8_mma_kernel<@D@, @G@>, kQThreads,
      QLayout<@D@>{QDims<@D@>::kTK, kQStages, @G@, 1}.bytes());
  return n;
}
"""
# Plain int-to-float conversions in place of the byte permute and add.
DECODE_INT8_CVT = [
    ("""  f[0] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7440)) - 8388736.f;
  f[1] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7441)) - 8388736.f;
  f[2] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7442)) - 8388736.f;
  f[3] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7443)) - 8388736.f;""",
     """  (void)u;
  f[0] = static_cast<float>(static_cast<int8_t>(w & 0xff));
  f[1] = static_cast<float>(static_cast<int8_t>((w >> 8) & 0xff));
  f[2] = static_cast<float>(static_cast<int8_t>((w >> 16) & 0xff));
  f[3] = static_cast<float>(static_cast<int8_t>(w >> 24));""")]
# Four warps a block (128 threads, four blocks an SM under the same
# register cap of 128), in place of eight.
DECODE_INT8_4_WARPS = [
    ("constexpr int kQWarps = 8;", "constexpr int kQWarps = 4;"),
    ("__global__ void __launch_bounds__(kQThreads, 2)\n"
     "decode_attention_kernel_int8(",
     "__global__ void __launch_bounds__(kQThreads, 4)\n"
     "decode_attention_kernel_int8(")]
# P V's loop over 4-key steps unrolled 4 times (2 shipped).
DECODE_INT8_PV_UNROLL_4 = [
    ("#pragma unroll 2\n      for (int i4 = 0; i4 < nc; i4 += 4) {",
     "#pragma unroll 4\n      for (int i4 = 0; i4 < nc; i4 += 4) {")]
# Half-size stages (128 keys at D = 64, 64 at D = 128).
DECODE_INT8_16K_STAGES = [("constexpr int kQStageBytes = 32768;",
                           "constexpr int kQStageBytes = 16384;")]
DECODE_INT8_3_STAGES = [("constexpr int kQStages = 2;",
                         "constexpr int kQStages = 3;")]
# Probes, not decodes (their output is not checked): the int8 kernel
# without its P V loop, without its scores' loads and FMAs, with q from
# registers in place of shared memory, without the max trees' shuffles.
DECODE_INT8_NO_PV = [("      for (int i4 = 0; i4 < nc; i4 += 4) {",
                      "      for (int i4 = 0; i4 < 0; i4 += 4) {")]
DECODE_INT8_NO_SCORES = [("      for (int jj = 0; jj < 4; ++jj) {",
                          "      for (int jj = 0; jj < 0; ++jj) {")]
DECODE_INT8_NO_QLOAD = [
    ("""            const float4 qq = *reinterpret_cast<const float4*>(
                qc + g * kNC * kQPad + 4 * e);""",
     """            const float4 qq = make_float4(1.f + g, 0.5f, 0.25f, 2.f + e);
            (void)qc;""")]
DECODE_INT8_NO_TREE = [
    ("""        for (int off = kKL; off < 32; off <<= 1) {
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));""",
     """        for (int off = kKL; off < 32; off <<= 1) {
          mx = fmaxf(mx, mx + off);""")]
# No cluster attribute for a one-split plan (a plain launch).
DECODE_INT8_NO_CLUSTER_OF_ONE = [
    ("  cfg.numAttrs = 1;", "  cfg.numAttrs = splits > 1 ? 1 : 0;")]

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

# --- gls_race, the joint race -------------------------------------------------

JOINT_ENTRY = """
extern "C" int variant_launch(const float* log_s, const float* log_p,
                              const float* log_q, const bool* active, int* x,
                              int* y, int batch, int k_drafts, int n, int kc,
                              void* stream) {
  const cudaError_t err = launch_gls_race(
      log_s, log_p, log_q, active, x, y, batch, k_drafts, n, kc,
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaPeekAtLastError());
}
extern "C" int variant_blocks_per_sm() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gls_race_kernel,
                                                kThreads, 0);
  return n;
}
"""
# The floor of the joint design (`gls_race_floor_kernel`, shipped in
# joint_race.cu): its grid, clusters and loads, no compares.  Its output
# is not checked.
JOINT_FLOOR_ENTRY = (JOINT_ENTRY.replace("launch_gls_race(",
                                         "launch_gls_race_floor(")
                     .replace("&n, gls_race_kernel,",
                              "&n, gls_race_floor_kernel,"))
# The parent design: one block of 1024 threads per batch row.
PARENT_JOINT_ENTRY = """
extern "C" int variant_launch(const float* log_s, const float* log_p,
                              const float* log_q, const bool* active, int* x,
                              int* y, int batch, int k_drafts, int n, int kc,
                              void* stream) {
  launch_gls_race(log_s, log_p, log_q, active, x, y, batch, k_drafts, n,
                  static_cast<cudaStream_t>(stream));
  return static_cast<int>(cudaPeekAtLastError());
}
extern "C" int variant_blocks_per_sm() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, gls_race_kernel,
                                                kThreads, 0);
  return n;
}
"""
JOINT_256_THREADS = [("constexpr int kThreads = 512;",
                      "constexpr int kThreads = 256;")]
JOINT_1024_THREADS = [("constexpr int kThreads = 512;",
                       "constexpr int kThreads = 1024;")]


def joint_unroll(n):
    """kUnroll float4 loads of each input in flight per thread (2
    shipped)."""
    return [("constexpr int kUnroll = 2; ", f"constexpr int kUnroll = {n}; ")]


# Every draft's log_q read, active or not (the first design's bytes).
JOINT_ALL_LOG_Q = [("""          if (act) e[u] = ld_stream(q4 + jj);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int jj = j + u * kThreads;""", """          e[u] = ld_stream(q4 + jj);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int jj = j + u * kThreads;""")]

# The plans of the two int8 decode serve shapes and the joint race at
# (20, 8, 49152) come from the wrappers (``ops.py``) unless a variant
# fixes them; the parent's int8 plan at those shapes was 6 splits at
# D = 64 and 2 at D = 128.
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
    # The group instance's plan: 1 split at both serve shapes and at
    # llama3-405b's 4,096 keys, 3 at granite-34b's.
    "decode_attention_d128_g48": ("decode_g48", []),
    "decode_attention_d128_g48/floor": ("decode_g48_floor", []),
    "decode_attention_d128_g48/1_split": ("decode_g48", [], {"splits": 1}),
    "decode_attention_d128_g48/2_splits": ("decode_g48", [], {"splits": 2}),
    "decode_attention_d128_g48/4_splits": ("decode_g48", [], {"splits": 4}),
    "decode_attention_d128_g48/2_slices": ("decode_g48", group_slices(2)),
    "decode_attention_d128_g48/probe_no_score_mma": ("decode_g48_probe",
                                                     GROUP_NO_SCORE_MMA),
    "decode_attention_d128_g48/probe_no_pv_mma": ("decode_g48_probe",
                                                  GROUP_NO_PV_MMA),
    "decode_attention_d128_g16": ("decode_g16", []),
    "decode_attention_d128_g16/floor": ("decode_g16_floor", []),
    "decode_attention_d128_g16/2_splits": ("decode_g16", [], {"splits": 2}),
    "decode_attention_d128_g16/4_slices": ("decode_g16", group_slices(4)),
    # The int8 group instance's plan: 3 slots of 16 heads at granite-34b's
    # serve shape, one slot of 48 and 3 splits over its 4,096 keys; 1
    # slot and 1 split at both of llama3-405b's.
    "decode_attention_int8_d128_g48": ("decode_int8_g48", []),
    "decode_attention_int8_d128_g48/floor": ("decode_int8_g48_floor", []),
    "decode_attention_int8_d128_g48/1_slot": ("decode_int8_g48", [],
                                              {"slots": 1}),
    "decode_attention_int8_d128_g48/3_slots": ("decode_int8_g48", [],
                                               {"slots": 3}),
    "decode_attention_int8_d128_g48/1_split": ("decode_int8_g48", [],
                                               {"splits": 1}),
    "decode_attention_int8_d128_g48/2_splits": ("decode_int8_g48", [],
                                                {"splits": 2}),
    "decode_attention_int8_d128_g48/4_splits": ("decode_int8_g48", [],
                                                {"splits": 4}),
    "decode_attention_int8_d128_g48/1_stage": ("decode_int8_g48",
                                               int8_group_stages(1)),
    "decode_attention_int8_d128_g48/4_stages": ("decode_int8_g48",
                                                int8_group_stages(4)),
    "decode_attention_int8_d128_g48/2_slices": ("decode_int8_g48",
                                                group_slices(2)),
    "decode_attention_int8_d128_g48/3_slots_2_splits": (
        "decode_int8_g48", [], {"slots": 3, "splits": 2}),
    "decode_attention_int8_d128_g48/2_slots_2_splits": (
        "decode_int8_g48", [], {"slots": 2, "splits": 2}),
    "decode_attention_int8_d128_g48/probe_no_score_mma": (
        "decode_int8_g48_probe", INT8_GROUP_NO_SCORE_MMA),
    "decode_attention_int8_d128_g48/probe_no_pv_mma": (
        "decode_int8_g48_probe", INT8_GROUP_NO_PV_MMA),
    "decode_attention_int8_d128_g48/probe_no_k_convert": (
        "decode_int8_g48_probe", INT8_GROUP_NO_K_CONVERT),
    "decode_attention_int8_d128_g48/probe_no_v_convert": (
        "decode_int8_g48_probe", INT8_GROUP_NO_V_CONVERT),
    "decode_attention_int8_d128_g48/probe_no_q_split": (
        "decode_int8_g48_probe", INT8_GROUP_NO_Q_SPLIT),
    "decode_attention_int8_d128_g16": ("decode_int8_g16", []),
    "decode_attention_int8_d128_g16/floor": ("decode_int8_g16_floor", []),
    "decode_attention_int8_d128_g16/2_splits": ("decode_int8_g16", [],
                                                {"splits": 2}),
    "decode_attention_int8_d128_g16/1_stage": ("decode_int8_g16",
                                               int8_group_stages(1)),
    "decode_attention_int8_d128_g16/4_stages": ("decode_int8_g16",
                                                int8_group_stages(4)),
    "decode_attention_int8_d128_g16/2_slices": ("decode_int8_g16",
                                                group_slices(2)),
    "decode_attention_int8_d128_g16/1_stage_3_blocks": (
        "decode_int8_g16", int8_group_stages(1) + GROUP_3_BLOCKS),
    "decode_attention_int8_d128_g16/probe_no_score_mma": (
        "decode_int8_g16_probe", INT8_GROUP_NO_SCORE_MMA),
    "decode_attention_int8_d128_g16/probe_no_pv_mma": (
        "decode_int8_g16_probe", INT8_GROUP_NO_PV_MMA),
    "decode_attention_int8_d128_g16/probe_no_k_convert": (
        "decode_int8_g16_probe", INT8_GROUP_NO_K_CONVERT),
    "decode_attention_int8_d128_g16/probe_no_v_convert": (
        "decode_int8_g16_probe", INT8_GROUP_NO_V_CONVERT),
    "decode_attention_int8_d128_g16/probe_no_q_split": (
        "decode_int8_g16_probe", INT8_GROUP_NO_Q_SPLIT),
    # The gls_row_race plan: 2 splits at (20, 8, 49152), 8 at (5, 8, 50280).
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
    # The joint race: one draft a block, 160 blocks at (20, 8, 49152).
    "gls_race": ("joint", []),
    "gls_race/floor": ("joint_floor", []),
    "gls_race/2_drafts_a_block": ("joint", [], {"kc": 2}),
    "gls_race/256_threads": ("joint", JOINT_256_THREADS),
    "gls_race/1024_threads": ("joint", JOINT_1024_THREADS),
    "gls_race/unroll_1": ("joint", joint_unroll(1)),
    "gls_race/unroll_4": ("joint", joint_unroll(4)),
    "gls_race/256_threads_unroll_4": ("joint", JOINT_256_THREADS
                                      + joint_unroll(4)),
    "gls_race/all_log_q": ("joint", JOINT_ALL_LOG_Q),
}


def _flash_d128_variants(kind: str) -> dict:
    """A head-dim-128 flash instance: the shipped wgmma kernel with TF32
    rounding by cvt, lo rounded, or the output divided by the row sums."""
    name = {"flash_d128": "flash_attention_d128",
            "flash_int8_d128": "flash_attention_int8_d128"}[kind]
    return {name: (kind, []),
            f"{name}/cvt": (kind, FLASH_TC_CVT),
            f"{name}/rounded_lo": (kind, FLASH_TC_ROUNDED_LO),
            f"{name}/divide": (kind, FLASH_TC_DIVIDE)}


VARIANTS.update(_flash_d128_variants("flash_d128"))
VARIANTS.update(_flash_d128_variants("flash_int8_d128"))
# The int8 instance at D = 64 (smollm-360m) and its other shapes: 32 or 64
# keys a tile, two or three stage sets, one or two blocks per SM (64 keys
# in three sets do not fit two blocks).
VARIANTS.update({
    "flash_attention_int8": ("flash_int8", []),
    **{f"flash_attention_int8/{k}_keys_{st}_stages_{bl}_blocks": (
        "flash_int8", flash_int8_shape(k, st, bl))
       for k, st, bl in ((32, 2, 1), (32, 2, 2), (32, 3, 1), (32, 3, 2),
                         (64, 2, 1), (64, 2, 2), (64, 3, 1))
       if flash_int8_shape(k, st, bl)[0][1] != _TC_SHAPE_64}})


def _int8_variants(kind: str) -> dict:
    """The int8 decode instance's variants at one head dim."""
    name = {"decode_int8": "decode_attention_int8",
            "decode_int8_d128": "decode_attention_int8_d128"}[kind]
    return {
        name: (kind, []),
        f"{name}/floor": (kind + "_floor", []),
        f"{name}/floor_2_splits": (kind + "_floor", [], {"splits": 2}),
        f"{name}/2_splits": (kind, [], {"splits": 2}),
        f"{name}/4_splits": (kind, [], {"splits": 4}),
        f"{name}/4_warps": (kind, DECODE_INT8_4_WARPS),
        f"{name}/4_warps_2_splits": (kind, DECODE_INT8_4_WARPS,
                                     {"splits": 2}),
        f"{name}/16k_stages": (kind, DECODE_INT8_16K_STAGES),
        f"{name}/3_stages": (kind, DECODE_INT8_3_STAGES),
        f"{name}/cvt": (kind, DECODE_INT8_CVT),
        f"{name}/no_cluster_of_one": (kind, DECODE_INT8_NO_CLUSTER_OF_ONE),
        f"{name}/pv_unroll_4": (kind, DECODE_INT8_PV_UNROLL_4),
        f"{name}/mma": (kind + "_mma", []),
        f"{name}/mma_4_warps": (kind + "_mma", DECODE_INT8_4_WARPS),
        f"{name}/probe_no_pv": (kind + "_probe", DECODE_INT8_NO_PV),
        f"{name}/probe_no_scores": (kind + "_probe", DECODE_INT8_NO_SCORES),
        f"{name}/probe_no_qload": (kind + "_probe", DECODE_INT8_NO_QLOAD),
        f"{name}/probe_no_tree": (kind + "_probe", DECODE_INT8_NO_TREE),
        f"{name}/probe_no_pv_no_scores": (kind + "_probe", DECODE_INT8_NO_PV
                                          + DECODE_INT8_NO_SCORES),
    }


VARIANTS.update(_int8_variants("decode_int8"))
VARIANTS.update(_int8_variants("decode_int8_d128"))


def _entry(template: str, d: int, g: int) -> str:
    return template.replace("@D@", str(d)).replace("@G@", str(g))


SOURCES = {"ssd": (SSD, SSD_ENTRY), "flash": (FLASH, FLASH_ENTRY),
           "decode": (DECODE, DECODE_ENTRY),
           "decode_two_pass": (DECODE, DECODE_TWO_PASS_ENTRY),
           "decode_int8": (DECODE, _entry(DECODE_INT8_ENTRY, 64, 3)),
           "decode_int8_d128": (DECODE, _entry(DECODE_INT8_ENTRY, 128, 4)),
           "decode_int8_probe": (DECODE, _entry(DECODE_INT8_ENTRY, 64, 3)),
           "decode_int8_mma": (DECODE, _entry(DECODE_INT8_MMA_ENTRY, 64, 3)),
           "decode_int8_d128_mma": (DECODE, _entry(DECODE_INT8_MMA_ENTRY, 128,
                                                   4)),
           "decode_int8_d128_probe": (DECODE, _entry(DECODE_INT8_ENTRY, 128,
                                                     4)),
           "decode_int8_floor": (DECODE, _entry(DECODE_INT8_FLOOR_ENTRY, 64,
                                                3)),
           "decode_int8_d128_floor": (DECODE, _entry(DECODE_INT8_FLOOR_ENTRY,
                                                     128, 4)),
           "decode_g48": (DECODE, _group_entry(48)),
           "decode_g48_probe": (DECODE, _group_entry(48)),
           "decode_g48_floor": (DECODE, _group_entry(48, True)),
           "decode_g48_parent": (None, PARENT_DECODE_GROUP_ENTRY),
           "decode_g16": (DECODE, _group_entry(16)),
           "decode_g16_floor": (DECODE, _group_entry(16, True)),
           "decode_g16_parent": (None, PARENT_DECODE_GROUP_ENTRY),
           "decode_int8_g48": (DECODE, _int8_group_entry(48)),
           "decode_int8_g48_probe": (DECODE, _int8_group_entry(48)),
           "decode_int8_g48_floor": (DECODE, _int8_group_entry(48, True)),
           "decode_int8_g48_parent": (None, PARENT_DECODE_INT8_GROUP_ENTRY),
           "decode_int8_g16": (DECODE, _int8_group_entry(16)),
           "decode_int8_g16_probe": (DECODE, _int8_group_entry(16)),
           "decode_int8_g16_floor": (DECODE, _int8_group_entry(16, True)),
           "decode_int8_g16_parent": (None, PARENT_DECODE_INT8_GROUP_ENTRY),
           "race": (RACE, RACE_ENTRY),
           "joint": (JOINT, JOINT_ENTRY),
           "joint_floor": (JOINT, JOINT_FLOOR_ENTRY),
           "decode_int8_parent": (None, _entry(PARENT_DECODE_INT8_ENTRY, 64,
                                               3)),
           "decode_int8_d128_parent": (None, _entry(PARENT_DECODE_INT8_ENTRY,
                                                    128, 4)),
           "joint_parent": (None, PARENT_JOINT_ENTRY),
           "flash_int8": (FLASH, _flash_tc_entry(64, True, False)),
           "flash_int8_parent": (None, _flash_tc_entry(64, True, True)),
           "flash_d128": (FLASH, _flash_tc_entry(128, False, False)),
           "flash_d128_parent": (None, _flash_tc_entry(128, False, True)),
           "flash_int8_d128": (FLASH, _flash_tc_entry(128, True, False)),
           "flash_int8_d128_parent": (None, _flash_tc_entry(128, True, True))}
# The (mangled) name of the kernel whose ptxas registers and spills each
# kind reports: decode at the serve shapes' groups (G = 3 at D = 64, 4
# at D = 128).
PTXAS_KERNEL = {"ssd": "ssd_chunk_kernel",
                "flash": "flash_attention_kernelILi64ELb1EE",
                "decode": "decode_attention_kernelILi64ELi3EEE",
                "decode_two_pass": "decode_attention_kernelILi64ELi3EEE",
                "decode_int8": "decode_attention_kernel_int8ILi64ELi3EEE",
                "decode_int8_d128":
                    "decode_attention_kernel_int8ILi128ELi4EEE",
                "decode_int8_probe": "decode_attention_kernel_int8ILi64ELi3EEE",
                "decode_int8_mma": "decode_int8_mma_kernelILi64ELi3EEE",
                "decode_int8_d128_mma": "decode_int8_mma_kernelILi128ELi4EEE",
                "decode_int8_d128_probe":
                    "decode_attention_kernel_int8ILi128ELi4EEE",
                "decode_int8_floor": "decode_int8_floor_kernelILi64ELi3EEE",
                "decode_int8_d128_floor":
                    "decode_int8_floor_kernelILi128ELi4EEE",
                "decode_g48":
                    "decode_attention_group_kernelILi128ELi3EfLb0EEE",
                "decode_g48_probe":
                    "decode_attention_group_kernelILi128ELi3EfLb0EEE",
                "decode_g48_floor":
                    "decode_attention_group_kernelILi128ELi3EfLb1EEE",
                "decode_g48_parent": "decode_attention_kernelILi128ELi8EEE",
                "decode_g16":
                    "decode_attention_group_kernelILi128ELi1EfLb0EEE",
                "decode_g16_floor":
                    "decode_attention_group_kernelILi128ELi1EfLb1EEE",
                "decode_g16_parent": "decode_attention_kernelILi128ELi8EEE",
                "decode_int8_g48":
                    "decode_attention_group_kernelILi128ELi3EaLb0EEE",
                "decode_int8_g48_probe":
                    "decode_attention_group_kernelILi128ELi3EaLb0EEE",
                "decode_int8_g48_floor":
                    "decode_attention_group_kernelILi128ELi3EaLb1EEE",
                "decode_int8_g48_parent":
                    "decode_attention_kernel_int8ILi128ELi8EEE",
                "decode_int8_g16":
                    "decode_attention_group_kernelILi128ELi1EaLb0EEE",
                "decode_int8_g16_probe":
                    "decode_attention_group_kernelILi128ELi1EaLb0EEE",
                "decode_int8_g16_floor":
                    "decode_attention_group_kernelILi128ELi1EaLb1EEE",
                "decode_int8_g16_parent":
                    "decode_attention_kernel_int8ILi128ELi8EEE",
                "race": "gls_row_race_kernel",
                "joint": "gls_race_kernel",
                "joint_floor": "gls_race_floor_kernel",
                "decode_int8_parent": "decode_attention_kernelILi64ELi3EaE",
                "decode_int8_d128_parent":
                    "decode_attention_kernelILi128ELi4EaE",
                "joint_parent": "gls_race_kernel",
                "flash_int8": "flash_attention_tc_kernelILi64EaE",
                "flash_int8_parent": "flash_attention_kernelILi64EaE",
                "flash_d128": "flash_attention_tc_kernelILi128EfE",
                "flash_d128_parent": "flash_attention_tc_kernelIfE",
                "flash_int8_d128": "flash_attention_tc_kernelILi128EaE",
                "flash_int8_d128_parent": "flash_attention_tc_kernelIaE"}
# The input case each source kind runs.
CASE_OF = {"ssd": "ssd", "flash": "flash", "decode": "decode",
           "decode_two_pass": "decode", "decode_int8": "decode_int8",
           "decode_int8_d128": "decode_int8_d128",
           "decode_int8_probe": "decode_int8",
           "decode_int8_mma": "decode_int8",
           "decode_int8_d128_mma": "decode_int8_d128",
           "decode_int8_d128_probe": "decode_int8_d128",
           "decode_int8_floor": "decode_int8",
           "decode_int8_d128_floor": "decode_int8_d128",
           "decode_g48": "decode_g48", "decode_g48_probe": "decode_g48",
           "decode_g48_floor": "decode_g48", "decode_g48_parent": "decode_g48",
           "decode_g16": "decode_g16", "decode_g16_floor": "decode_g16",
           "decode_g16_parent": "decode_g16",
           "decode_int8_g48": "decode_int8_g48",
           "decode_int8_g48_probe": "decode_int8_g48",
           "decode_int8_g48_floor": "decode_int8_g48",
           "decode_int8_g48_parent": "decode_int8_g48",
           "decode_int8_g16": "decode_int8_g16",
           "decode_int8_g16_probe": "decode_int8_g16",
           "decode_int8_g16_floor": "decode_int8_g16",
           "decode_int8_g16_parent": "decode_int8_g16",
           "race": "race", "joint": "joint", "joint_floor": "joint",
           "decode_int8_parent": "decode_int8",
           "decode_int8_d128_parent": "decode_int8_d128",
           "joint_parent": "joint",
           "flash_int8": "flash_int8", "flash_int8_parent": "flash_int8",
           "flash_d128": "flash_d128", "flash_d128_parent": "flash_d128",
           "flash_int8_d128": "flash_int8_d128",
           "flash_int8_d128_parent": "flash_int8_d128"}
# Cases timed as one call on one input set (no cycling, no device time).
SINGLE_CALL = ("ssd", "flash", "flash_int8", "flash_d128", "flash_int8_d128")
# Cases whose variants run at several shapes (one list of calls a shape).
MULTI_SHAPE = ("race", "decode_g48", "decode_g16", "decode_int8_g48",
               "decode_int8_g16")
# Kinds whose output is not the kernel's function (no check).
UNCHECKED = {"decode_int8_floor", "decode_int8_d128_floor", "joint_floor",
             "decode_int8_probe", "decode_int8_d128_probe",
             "decode_g48_floor", "decode_g16_floor", "decode_g48_probe",
             "decode_int8_g48_floor", "decode_int8_g16_floor",
             "decode_int8_g48_probe", "decode_int8_g16_probe"}
PARENT_VARIANTS = {
    "decode_attention_int8 (parent)": ("decode_int8_parent", [],
                                       {"splits": 6}),
    "decode_attention_int8_d128 (parent)": ("decode_int8_d128_parent", [],
                                            {"splits": 2}),
    "gls_race (parent)": ("joint_parent", []),
    "flash_attention_int8 (parent)": ("flash_int8_parent", []),
    "flash_attention_d128 (parent)": ("flash_d128_parent", []),
    "flash_attention_int8_d128 (parent)": ("flash_int8_d128_parent", []),
    "decode_attention_d128_g48 (parent)": ("decode_g48_parent", [],
                                           {"plan": "parent"}),
    "decode_attention_d128_g16 (parent)": ("decode_g16_parent", [],
                                           {"plan": "parent"}),
    "decode_attention_int8_d128_g48 (parent)": ("decode_int8_g48_parent", [],
                                                {"plan": "parent"}),
    "decode_attention_int8_d128_g16 (parent)": ("decode_int8_g16_parent", [],
                                                {"plan": "parent"})}
PARENT_FILES = {"decode_int8_parent": DECODE.relative_to(ROOT),
                "decode_int8_d128_parent": DECODE.relative_to(ROOT),
                "joint_parent": JOINT.relative_to(ROOT),
                "flash_int8_parent": FLASH.relative_to(ROOT),
                "flash_d128_parent": FLASH.relative_to(ROOT),
                "flash_int8_d128_parent": FLASH.relative_to(ROOT),
                "decode_g48_parent": DECODE.relative_to(ROOT),
                "decode_g16_parent": DECODE.relative_to(ROOT),
                "decode_int8_g48_parent": DECODE.relative_to(ROOT),
                "decode_int8_g16_parent": DECODE.relative_to(ROOT)}


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
    ptxas register and spill lines)} and the names that did not build."""
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
    built, failed = {}, []
    for name, (lib, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            print(f"{name}: nvcc failed\n{out[-4000:]}", flush=True)
            failed.append(name)
            continue
        # ptxas's lines for the kernel that runs at the timed shape.
        entry = out.split(PTXAS_KERNEL[VARIANTS[name][0]], 1)[-1]
        regs = re.findall(r"Used (\d+) registers", entry)
        stack = re.findall(r"(\d+) bytes stack frame", entry)
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", entry)
        warn = "".join(f"; ptxas: {w.strip()}" for w in out.splitlines()
                       if "Performance Loss" in w)
        built[name] = (lib, f"{regs[0] if regs else '?'} registers, "
                            f"stack {stack[0] if stack else '?'} bytes, spill "
                            f"stores/loads {spills[0] if spills else '?'}"
                            f"{warn}")
    return built, failed


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def stream_ptr(torch):
    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


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
    stream = stream_ptr(torch)

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
    stream = stream_ptr(torch)

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


def flash_tc_case(torch, dev, d: int, int8: bool):
    """The launcher and check of each variant of a tensor-core flash
    instance at its model's admission shape (``chip_smoke.flash_inputs``:
    granite-8b's q (32, 32, 256, 128), K/V (32, 8, 370, 128); smollm-360m's
    q (32, 15, 256, 64), K/V (32, 5, 370, 64)): within 1e-4 of plain; the
    check also returns the error against a float64 evaluation of the same
    inputs beside the plain version's."""
    import chip_smoke as C
    from repro_torch.kernels.flash_attention.ref import flash_attention_plain
    b, s, t = 32, 256, 370
    h, hkv = (32, 8) if d == 128 else (15, 5)
    args, mask = C.flash_inputs(torch, dev, b, h, hkv, d, s, t, int8)
    q, k, v, q_off, kv_len, ks, vs = args
    want = flash_attention_plain(*args)
    want64 = C.flash_float64(torch, args, mask)
    plain64 = float((want.double() - want64).abs().max())
    out = torch.empty_like(q)
    stream = stream_ptr(torch)

    def run(lib):
        rc = lib.variant_launch(ptr(q), ptr(k), ptr(v),
                                ptr(ks) if int8 else None,
                                ptr(vs) if int8 else None, ptr(q_off),
                                ptr(kv_len), ptr(out), b, h, hkv, s, t, 0,
                                stream)
        if rc:
            raise RuntimeError(f"launch failed: cuda error {rc}")

    def check():
        err = float((out - want).abs().max())
        if err > 1e-4:
            raise AssertionError(f"max abs err {err}")
        return err, float((out.double() - want64).abs().max()), plain64

    return run, check


def decode_case(torch, dev):
    """The launcher and check of each float32 decode_attention variant,
    cycling through chip_smoke's four K/V sets (cold in L2) with the
    serve's kv_len."""
    import chip_smoke as C
    from repro_torch.kernels.decode_attention.ops import decode_split_plan
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_plain)
    b, h, hkv, d, t = 32, 15, 5, 64, 370
    q, kv_sets, kv_len = C.decode_inputs(torch, dev, b, h, hkv, d, t)
    want = decode_attention_plain(q, *kv_sets[0], kv_len)
    out = torch.empty_like(q)
    stream = stream_ptr(torch)

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

    return calls, check, "decode_attention_kernel"


def decode_group_case(torch, dev, group: int):
    """The launcher and check of each variant of the float32 group
    instance at a giant's shape: granite-34b's q (32, 48, 128) over (32,
    1, T, 128) (``group`` 48) or llama3-405b's q (32, 128, 128) over (32,
    8, T, 128) (16); T = 86 with the serve's kv_len and T = 4,096 with
    every key live, each cycling through K/V sets worth three L2 caches.
    The plan is the wrapper's unless a variant fixes ``splits``; the
    parent's sub-groups take the parent's plan (group 8 over Hkv x group
    / 8 head slots).  The check also
    returns the error against a float64 evaluation of the first set
    beside the plain version's, at the shape where their ratio is the
    largest."""
    import chip_smoke as C
    from repro_torch.kernels.decode_attention.ops import decode_split_plan
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_plain)
    b, d = 32, 128
    hkv = 1 if group == 48 else 8
    h = hkv * group
    shapes = []
    for t in (86, 4096):
        q, kv_sets, kv_len = C.decode_inputs(
            torch, dev, b, h, hkv, d, t, C.cold_sets(8 * b * hkv * t * d),
            full=t != 86)
        want = decode_attention_plain(q, *kv_sets[0], kv_len)
        want64 = C.decode_float64(torch, q, *kv_sets[0], kv_len)
        shapes.append((t, q, kv_sets, kv_len, want, torch.empty_like(q),
                       want64, float((want.double() - want64).abs().max())))
    stream = stream_ptr(torch)

    def splits_of(opts, t):
        if "splits" in opts:
            return opts["splits"]
        if opts.get("plan") == "parent":
            return decode_split_plan(b, hkv * group // 8, t, head_dim=d,
                                     group=8)[0]
        return decode_split_plan(b, hkv, t, head_dim=d, group=group)[0]

    def calls(lib, opts):
        out = []
        for t, q, kv_sets, kv_len, _, o, *_ in shapes:
            splits = splits_of(opts, t)

            def one(k, v, q=q, kv_len=kv_len, o=o, t=t, splits=splits):
                rc = lib.variant_launch(ptr(q), ptr(k), ptr(v), ptr(kv_len),
                                        ptr(o), b, h, hkv, t, splits,
                                        -(-t // splits), stream)
                if rc:
                    raise RuntimeError(f"launch failed: cuda error {rc}")
            out.append([lambda k=k, v=v, one=one: one(k, v)
                        for k, v in kv_sets])
        return out

    def check(lib, opts):
        err, worst = 0.0, (0.0, 1.0)
        for shape_calls, shape in zip(calls(lib, opts), shapes):
            shape_calls[0]()
            torch.cuda.synchronize()
            err = max(err, float((shape[5] - shape[4]).abs().max()))
            e64 = float((shape[5].double() - shape[6]).abs().max())
            if e64 / shape[7] > worst[0] / worst[1]:
                worst = (e64, shape[7])
        if err > 1e-4:
            raise AssertionError(f"max abs err {err}")
        return (err,) + worst

    return calls, check, "decode_"


def decode_int8_group_case(torch, dev, group: int):
    """The launcher and check of each variant of the int8 group instance
    at a giant's shape: granite-34b's q (32, 48, 128) over int8 (32, 1, T,
    128) K/V (``group`` 48) or llama3-405b's q (32, 128, 128) over (32, 8,
    T, 128) (16), with float32 scales; T = 86 with the serve's kv_len and
    T = 4,096 with every key live, each cycling through int8 sets worth
    three L2 caches (``chip_smoke.decode_int8_inputs``).  The plan is the
    wrapper's (``decode_group_plan``) unless a variant fixes ``slots`` or
    ``splits``; the parent's sub-groups take the parent's plan (the int8
    G = 8 plan over Hkv x group / 8 head slots).  The check also returns
    the error against a float64 evaluation of the dequantized attention
    on the first set beside the plain version's, at the shape where their
    ratio is the largest."""
    import chip_smoke as C
    from repro_torch.kernels.decode_attention.ops import (decode_group_plan,
                                                          decode_split_plan)
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_plain)
    b, d = 32, 128
    hkv = 1 if group == 48 else 8
    h = hkv * group
    shapes = []
    for t in (86, 4096):
        q, sets, _, kv_len = C.decode_int8_inputs(torch, dev, b, h, hkv, d,
                                                  t, full=t != 86)
        want = decode_attention_plain(q, *sets[0][:2], kv_len, *sets[0][2:])
        want64 = C.decode_float64(torch, q, *sets[0][:2], kv_len,
                                  *sets[0][2:])
        shapes.append((t, q, sets, kv_len, want, torch.empty_like(q),
                       want64, float((want.double() - want64).abs().max())))
        C.gc_collect(torch)
    stream = stream_ptr(torch)

    def plan_of(opts, t):
        if opts.get("plan") == "parent":
            return 1, decode_split_plan(b, hkv * group // 8, t, head_dim=d,
                                        int8=True, group=8)[0]
        slots, splits, _ = decode_group_plan(b, hkv, t, head_dim=d,
                                             group=group, int8=True)
        return opts.get("slots", slots), opts.get("splits", splits)

    def calls(lib, opts):
        out = []
        for t, q, sets, kv_len, _, o, *_ in shapes:
            slots, splits = plan_of(opts, t)

            def one(k, v, ks, vs, q=q, kv_len=kv_len, o=o, t=t,
                    splits=splits, slots=slots):
                rc = lib.variant_launch(ptr(q), ptr(k), ptr(v), ptr(ks),
                                        ptr(vs), ptr(kv_len), ptr(o), b, h,
                                        hkv, t, splits, -(-t // splits),
                                        slots, stream)
                if rc:
                    raise RuntimeError(f"launch failed: cuda error {rc}")
            out.append([lambda s_=s_, one=one: one(*s_) for s_ in sets])
        return out

    def check(lib, opts):
        err, worst = 0.0, (0.0, 1.0)
        for shape_calls, shape in zip(calls(lib, opts), shapes):
            shape_calls[0]()
            torch.cuda.synchronize()
            err = max(err, float((shape[5] - shape[4]).abs().max()))
            e64 = float((shape[5].double() - shape[6]).abs().max())
            if e64 / shape[7] > worst[0] / worst[1]:
                worst = (e64, shape[7])
        if err > 1e-4:
            raise AssertionError(f"max abs err {err}")
        return (err,) + worst

    return calls, check, "decode_"


def int8_decode_calls(torch, lib, q, sets, kv_len, out, splits: int):
    """One call per int8 K/V set through a variant library's
    ``variant_launch`` (the int8 signature) at ``splits`` splits."""
    b, h = q.shape[:2]
    hkv, t = sets[0][0].shape[1:3]
    chunk = -(-t // splits)
    stream = stream_ptr(torch)

    def one(k, v, ks, vs):
        rc = lib.variant_launch(ptr(q), ptr(k), ptr(v), ptr(ks), ptr(vs),
                                ptr(kv_len), ptr(out), b, h, hkv, t,
                                splits, chunk, stream)
        if rc:
            raise RuntimeError(f"launch failed: cuda error {rc}")
    return [lambda s_=s_: one(*s_) for s_ in sets]


def decode_int8_case(torch, dev, d: int = 64):
    """The launcher and check of each variant of the int8 instance at head
    dim ``d`` (smollm-360m's serve shape at 64, granite-8b's at 128),
    cycling through int8 K/V sets worth three L2 caches with the serve's
    kv_len (as chip_smoke.py's ``kernel_decode_int8``)."""
    import chip_smoke as C
    from repro_torch.kernels.decode_attention.ops import decode_split_plan
    from repro_torch.kernels.decode_attention.ref import (
        decode_attention_plain)
    b, t = 32, 370
    h, hkv = (15, 5) if d == 64 else (32, 8)
    q, sets, _, kv_len = C.decode_int8_inputs(torch, dev, b, h, hkv, d, t)
    want = decode_attention_plain(q, *sets[0][:2], kv_len, *sets[0][2:])
    out = torch.empty_like(q)

    def calls(lib, opts):
        splits = opts.get("splits", decode_split_plan(
            b, hkv, t, head_dim=d, int8=True)[0])
        return int8_decode_calls(torch, lib, q, sets, kv_len, out, splits)

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
    stream = stream_ptr(torch)

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


def joint_calls(torch, lib, args, x, y, kc: int):
    """One call of a joint-race variant library on ``args`` (log_s, log_p,
    log_q, active) at ``kc`` drafts a block."""
    log_s, log_p, log_q, active = args
    b, k, n = log_s.shape
    stream = stream_ptr(torch)

    def one():
        rc = lib.variant_launch(ptr(log_s), ptr(log_p), ptr(log_q),
                                ptr(active), ptr(x), ptr(y), b, k, n, kc,
                                stream)
        if rc:
            raise RuntimeError(f"launch failed: cuda error {rc}")
    return [one]


def joint_case(torch, dev):
    """The launcher and check of each gls_race variant on chip_smoke's
    joint-race inputs (20, 8, 49152), bitwise against the plain version."""
    import chip_smoke as C
    from repro_torch.kernels.gls_race.ops import joint_race_split_plan
    from repro_torch.kernels.gls_race.ref import gls_race_plain
    args = C.joint_inputs(torch, dev, 49152)
    b, k, n = args[0].shape
    want = gls_race_plain(*args)
    x = torch.empty((b, k), dtype=torch.int32, device=dev)
    y = torch.empty((b,), dtype=torch.int32, device=dev)

    def calls(lib, opts):
        kc = opts.get("kc", joint_race_split_plan(k))
        return joint_calls(torch, lib, args, x, y, kc)

    def check(lib, opts):
        calls(lib, opts)[0]()
        torch.cuda.synchronize()
        if not (torch.equal(x, want[0]) and torch.equal(y, want[1])):
            raise AssertionError("not equal to plain")
        return 0.0

    return calls, check, "gls_race"


def main(argv) -> int:
    import torch

    import chip_smoke as C
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", nargs="+", choices=sorted(set(CASE_OF.values())),
                    default=sorted(set(CASE_OF.values())))
    ap.add_argument("--match", nargs="+", help="only the variants whose "
                    "names end with one of these strings")
    ap.add_argument("--parent", help="a parent tree (git archive) whose "
                    "flash kernels (and, from an older tree, int8 decode "
                    "and joint race) run as variants too")
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
    names = [n for n, v in VARIANTS.items() if CASE_OF[v[0]] in args.only
             and (not args.match or any(n.endswith(m) for m in args.match))]
    built, failed = build_all(names, args.parent)
    makers = {"ssd": ssd_case, "flash": flash_case, "decode": decode_case,
              "decode_int8": decode_int8_case,
              "decode_int8_d128": lambda t, d: decode_int8_case(t, d, 128),
              "decode_g48": lambda t, d: decode_group_case(t, d, 48),
              "decode_g16": lambda t, d: decode_group_case(t, d, 16),
              "decode_int8_g48":
                  lambda t, d: decode_int8_group_case(t, d, 48),
              "decode_int8_g16":
                  lambda t, d: decode_int8_group_case(t, d, 16),
              "race": race_case, "joint": joint_case,
              "flash_int8": lambda t, d: flash_tc_case(t, d, 64, True),
              "flash_d128": lambda t, d: flash_tc_case(t, d, 128, False),
              "flash_int8_d128": lambda t, d: flash_tc_case(t, d, 128, True)}
    cases = {c: makers[c](torch, dev) for c in args.only}

    def opts(name):
        return VARIANTS[name][2] if len(VARIANTS[name]) > 2 else {}

    def shape_calls(case, lib, name):
        """Per shape, the calls (one per input set) a timing cycles
        through."""
        if case in SINGLE_CALL:
            run = cases[case][0]
            return [[lambda: run(lib)]]
        calls = cases[case][0](lib, opts(name))
        return calls if case in MULTI_SHAPE else [calls]

    libs, errs = {}, {}
    for name, (lib_path, _) in built.items():
        case = CASE_OF[VARIANTS[name][0]]
        lib = ctypes.CDLL(os.fspath(lib_path))
        try:
            if case in SINGLE_CALL:
                run, check = cases[case]
                run(lib)
                torch.cuda.synchronize()
                errs[name] = check()
            elif VARIANTS[name][0] in UNCHECKED:
                for c in shape_calls(case, lib, name):
                    c[0]()
                torch.cuda.synchronize()
                errs[name] = float("nan")
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
        if case not in SINGLE_CALL:
            for name in names:
                try:
                    device[name] = [C.device_ms(torch, c, cases[case][2])
                                    for c in shape_calls(case, libs[name],
                                                         name)]
                except AssertionError as e:
                    print(f"{name}: {e}", flush=True)
    for name, lib in libs.items():
        turns = " / ".join(", ".join(f"{t:.4f}" for t in ts)
                           for ts in times[name])
        dev_ms = (", device ms " + ", ".join(f"{t:.4f}" for t in device[name])
                  if name in device else "")
        err = errs[name]
        err = (f"{err[0]:.3g} (against float64 {err[1]:.3g}, the plain "
               f"version's {err[2]:.3g})" if isinstance(err, tuple)
               else f"{err:.3g}")
        try:
            clusters = ", clusters of 4 resident " + str(
                lib.variant_max_clusters(4))
        except AttributeError:
            clusters = ""
        print(f"{name}: {built[name][1]}, {lib.variant_blocks_per_sm()} "
              f"blocks per SM{clusters}, ms {turns}{dev_ms}, max abs err "
              f"{err}", flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
