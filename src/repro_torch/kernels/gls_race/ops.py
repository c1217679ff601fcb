"""Public wrappers of the GLS race kernels: the CUDA kernel for a CUDA
tensor, the plain version for a CPU tensor (``kernels/mode.py``).  Each
adds one to ``launch_counts[<name>]`` where it launches its kernel."""

from __future__ import annotations

import torch

from repro_torch.kernels.gls_race.ref import (gls_binned_race_plain,
                                              gls_race_plain,
                                              gls_row_race_plain)
from repro_torch.kernels.mode import (H100_SMS, MAX_CLUSTER, launch_counts,
                                      sm_count, use_kernel)


def row_race_split_plan(rows: int, n: int,
                        sms: int = H100_SMS) -> tuple[int, int]:
    """(splits, chunk): each row runs as a cluster of ``splits`` blocks,
    block i streaming elements [i chunk, min((i + 1) chunk, n)) (empty
    where it starts at or past n), chunk a multiple of 4 so every block
    keeps the float4 path.  The least power of two of splits that gives
    ~2 blocks per SM (the reprefill verifier's 40 rows x 8 = 320 blocks,
    the kv_fused verifier's 160 x 2), at most 8 and at most one per 2,048
    elements."""
    want = -(-2 * sms // max(rows, 1))
    cap = min(MAX_CLUSTER, max(1, -(-n // 2048)))
    splits = 1
    while splits < min(want, cap):
        splits *= 2
    splits = min(splits, cap)
    return splits, 4 * -(-max(1, -(-n // splits)) // 4)


def joint_race_split_plan(k: int) -> int:
    """kc, the drafts a block of the joint race takes: each batch row runs
    as a cluster of ceil(k / kc) blocks, block r streaming the drafts
    [r kc, min((r + 1) kc, k)) over the whole vocabulary.  One draft a
    block up to the cluster's 8 (kc drafts a block above): at the serving
    race shape (20, 8, 49152) 160 blocks."""
    return -(-max(k, 1) // MAX_CLUSTER)


def gls_row_race(log_s: torch.Tensor, log_q: torch.Tensor):
    """log_s/log_q: (B, K, N) f32 -> (rmin (B, K) f32, rarg (B, K) i32).
    Bit-exact between the two routes."""
    if not use_kernel(log_s):
        return gls_row_race_plain(log_s, log_q)
    from repro_torch.kernels.build import load_kernels
    ext = load_kernels()
    b, k, n = log_s.shape
    splits, chunk = row_race_split_plan(b * k, n, sm_count(log_s.device))
    rmin, rarg = ext.gls_row_race(log_s.contiguous(), log_q.contiguous(),
                                  splits, chunk)
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
                        log_q.contiguous(), active.contiguous(),
                        joint_race_split_plan(log_s.shape[1]))
    launch_counts["gls_race"] += 1
    return x, y
