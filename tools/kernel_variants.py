"""Time variants of the ``ssd_chunk`` and ``flash_attention`` CUDA kernels.

  python3 tools/kernel_variants.py

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
(32, 5, 370, 64) with half the rows at offset 256), every variant is
checked against the kernel's plain version (``ssd_chunk`` 5e-4 abs + rel
on y and the states, 1e-5 on the total; flash 1e-4 abs) and timed with
CUDA events: the median of 25 samples of 10 back-to-back calls, the
variants of a kernel in turn and then in reverse order.  Prints per
variant: registers and spills (ptxas), resident blocks per SM (the
occupancy API), the two times and the max abs error, then the card's name
and power limit.  Exits non-zero when a variant does not build or
disagrees with the plain version.
"""

from __future__ import annotations

import ctypes
import os
import pathlib
import re
import shutil
import statistics
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, os.fspath(ROOT / "src"))
OUT = ROOT / "build" / "kernel_variants"
SSD = ROOT / "src/repro_torch/kernels/ssd_chunk/ssd_chunk.cu"
FLASH = ROOT / "src/repro_torch/kernels/flash_attention/flash_attention.cu"
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
    ("constexpr int kMaxHeads = 3;", "constexpr int kMaxHeads = 1;"),
    ("__launch_bounds__(kGroup * kMaxHeads, 1)",
     "__launch_bounds__(kGroup * kMaxHeads, 2)"),
]
# 32 query rows per warp group and one K/V stage (the next tile loads
# between two barriers): 88 KB and 192 threads, two blocks per SM.
FLASH_32_ROWS_1_STAGE = [
    ("constexpr int kBQ = 64;", "constexpr int kBQ = 32;"),
    ("constexpr int kOffV = 2 * kKStage;", "constexpr int kOffV = kKStage;"),
    ("constexpr int kOffGroups = kOffV + 2 * kVStage;",
     "constexpr int kOffGroups = kOffV + kVStage;"),
    ("const int stage = it & 1;", "const int stage = 0;"),
    ("""    if (it + 1 < n_tiles) {
      load_kv(smem + (stage ^ 1) * kKStage, smem + kOffV + (stage ^ 1) * kVStage,
              k, v, kv_base, k0 + kBK, T);
    }
""", ""),
    ("""    __syncwarp();  // P^T is rewritten by the next tile
  }""", """    __syncwarp();  // P^T is rewritten by the next tile
    if (it + 1 < n_tiles) {
      __syncthreads();
      load_kv(smem, smem + kOffV, k, v, kv_base, k0 + kBK, T);
    }
  }"""),
    ("__launch_bounds__(kGroup * kMaxHeads, 1)",
     "__launch_bounds__(kGroup * kMaxHeads, 2)"),
]
FLASH_ENTRY = """
extern "C" int variant_launch(const float* q, const float* k, const float* v,
                              const int* q_offset, const int* kv_len,
                              float* out, int B, int H, int Hkv, int S, int T,
                              int window, void* stream) {
  const cudaError_t err = launch_flash_attention(
      q, k, v, q_offset, kv_len, out, B, H, Hkv, S, T, window,
      static_cast<cudaStream_t>(stream));
  return static_cast<int>(err != cudaSuccess ? err : cudaPeekAtLastError());
}
extern "C" int variant_blocks_per_sm() {
  int n = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, flash_attention_kernel, kGroup * kMaxHeads, smem_bytes(kMaxHeads));
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
}
SOURCES = {"ssd": (SSD, SSD_ENTRY), "flash": (FLASH, FLASH_ENTRY)}


def variant_source(kind: str, subs) -> str:
    path, entry = SOURCES[kind]
    s = path.read_text()
    for old, new in subs:
        n = s.count(old)
        if n != 1:
            raise ValueError(f"{path.name}: {n} matches for {old[:60]!r}")
        s = s.replace(old, new)
    return s + entry


def build_all():
    """All variants' nvcc runs at once; returns {name: (lib path, ptxas
    register and spill lines)}."""
    from torch.utils.cpp_extension import CUDA_HOME
    from repro_torch.kernels.build import CUDA_FLAGS
    nvcc = (os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME
            else shutil.which("nvcc"))
    if os.path.isdir(OUT):
        shutil.rmtree(OUT)
    OUT.mkdir(parents=True)
    procs = {}
    for i, (name, (kind, subs)) in enumerate(VARIANTS.items()):
        src = OUT / f"v{i}.cu"
        src.write_text(variant_source(kind, subs))
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
        regs = re.findall(r"Used (\d+) registers", out)
        spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", out)
        built[name] = (lib, f"{regs[-1] if regs else '?'} registers, spill "
                            f"stores/loads {spills[-1] if spills else '?'}")
    return built


def time_ms(torch, fn, samples: int = 25, batch: int = 10, warmup: int = 3):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(samples):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(batch):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / batch)
    return statistics.median(times)


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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    dev = torch.device("cuda")
    built = build_all()
    cases = {"ssd": ssd_case(torch, dev), "flash": flash_case(torch, dev)}
    libs, errs, failed = {}, {}, []
    for name, (lib_path, _) in built.items():
        run, check = cases[VARIANTS[name][0]]
        lib = ctypes.CDLL(os.fspath(lib_path))
        try:
            run(lib)
            torch.cuda.synchronize()
            errs[name] = check()
            libs[name] = lib
        except (RuntimeError, AssertionError) as e:
            failed.append(name)
            print(f"{name}: FAILED {e}", flush=True)
    times = {name: [] for name in libs}
    for kind in ("ssd", "flash"):
        names = [n for n in libs if VARIANTS[n][0] == kind]
        run, _ = cases[kind]
        for name in names + names[::-1]:
            times[name].append(time_ms(torch, lambda: run(libs[name])))
    for name, lib in libs.items():
        print(f"{name}: {built[name][1]}, {lib.variant_blocks_per_sm()} "
              f"blocks per SM, ms {times[name][0]:.4f} / "
              f"{times[name][1]:.4f}, max abs err {errs[name]:.3g}",
              flush=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
