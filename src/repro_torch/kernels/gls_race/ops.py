"""Public wrapper of the GLS row race: the CUDA kernel for a CUDA tensor,
the plain version for a CPU tensor (``kernels/mode.py``)."""

from __future__ import annotations

import torch

from repro_torch.kernels.gls_race.ref import gls_row_race_plain
from repro_torch.kernels.mode import launch_counts, use_kernel


def gls_row_race(log_s: torch.Tensor, log_q: torch.Tensor):
    """log_s/log_q: (B, K, N) f32 -> (rmin (B, K) f32, rarg (B, K) i32).
    Bit-exact between the two routes."""
    if not use_kernel(log_s):
        return gls_row_race_plain(log_s, log_q)
    from repro_torch.kernels.build import load_kernels
    ext = load_kernels()
    rmin, rarg = ext.gls_row_race(log_s.contiguous(), log_q.contiguous())
    launch_counts["gls_row_race"] += 1
    return rmin, rarg
