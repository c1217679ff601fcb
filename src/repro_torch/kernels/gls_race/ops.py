"""Public wrappers of the GLS race kernels: the CUDA kernel for a CUDA
tensor, the plain version for a CPU tensor (``kernels/mode.py``).  Each
adds one to ``launch_counts[<name>]`` where it launches its kernel."""

from __future__ import annotations

import torch

from repro_torch.kernels.gls_race.ref import (gls_binned_race_plain,
                                              gls_race_plain,
                                              gls_row_race_plain)
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


def gls_binned_race(log_s: torch.Tensor, log_q: torch.Tensor,
                    bins: torch.Tensor, *, l_max: int):
    """log_s/log_q: (B, K, N) f32, bins: (B, N) i32 ->
    (bmin (B, K, l_max) f32, barg (B, K, l_max) i32): per-(row, sheet,
    bin) race minima and their atom indices.  Bit-exact between the two
    routes; the kernel takes ``l_max`` up to 64 (a 6-bit message)."""
    if not use_kernel(log_s):
        return gls_binned_race_plain(log_s, log_q, bins, l_max=l_max)
    from repro_torch.kernels.build import load_kernels
    ext = load_kernels()
    bmin, barg = ext.gls_binned_race(log_s.contiguous(), log_q.contiguous(),
                                     bins.contiguous(), int(l_max))
    launch_counts["gls_binned_race"] += 1
    return bmin, barg


def gls_race(log_s: torch.Tensor, log_p: torch.Tensor, log_q: torch.Tensor,
             active: torch.Tensor):
    """log_s/log_p/log_q: (B, K, N) f32, active: (B, K) bool ->
    (x (B, K) i32, y (B,) i32): the draft argmins and the target argmin
    over the active drafts.  Bit-exact between the two routes."""
    if not use_kernel(log_s):
        return gls_race_plain(log_s, log_p, log_q, active)
    from repro_torch.kernels.build import load_kernels
    ext = load_kernels()
    x, y = ext.gls_race(log_s.contiguous(), log_p.contiguous(),
                        log_q.contiguous(), active.contiguous())
    launch_counts["gls_race"] += 1
    return x, y
