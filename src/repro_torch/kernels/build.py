"""Builds the port's CUDA kernels on first use.

One ``torch.utils.cpp_extension.load`` call compiles every ``.cu``
source under ``kernels/`` together with ONE small binding file
(``binding.cpp``, the only translation unit that includes PyTorch's
headers), for ``sm_90a`` only, into ``build/repro_torch_kernels/`` at
the repository root (listed in ``.gitignore``).  Nothing is built when
a module is imported: the first kernel launch calls ``load_kernels()``,
so the CPU tests import every module on machines without ``nvcc``.
"""

from __future__ import annotations

import os
import pathlib

_KERNEL_DIR = pathlib.Path(__file__).resolve().parent
_REPO_ROOT = _KERNEL_DIR.parents[2]
BUILD_DIR = _REPO_ROOT / "build" / "repro_torch_kernels"

SOURCES = (
    _KERNEL_DIR / "binding.cpp",
    _KERNEL_DIR / "gls_race" / "row_race.cu",
    _KERNEL_DIR / "gls_race" / "binned_race.cu",
    _KERNEL_DIR / "gls_race" / "joint_race.cu",
    _KERNEL_DIR / "decode_attention" / "decode_attention.cu",
    _KERNEL_DIR / "flash_attention" / "flash_attention.cu",
    _KERNEL_DIR / "ssd_chunk" / "ssd_chunk.cu",
)

CUDA_FLAGS = ["-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a"]

_ext = None


def load_kernels(verbose: bool = False):
    """Compile (once per process) and return the bound extension."""
    global _ext
    if _ext is not None:
        return _ext
    from torch.utils.cpp_extension import load

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    flags = list(CUDA_FLAGS)
    if verbose:
        flags.append("-Xptxas=-v")
    _ext = load(name="repro_torch_kernels",
                sources=[os.fspath(s) for s in SOURCES],
                build_directory=os.fspath(BUILD_DIR),
                extra_cflags=["-O2", "-std=c++17"],
                extra_cuda_cflags=flags,
                verbose=verbose)
    return _ext
