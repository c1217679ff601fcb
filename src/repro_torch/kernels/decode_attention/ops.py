"""Public wrapper of decode attention: the CUDA kernel for a CUDA tensor,
the plain version for a CPU tensor (``kernels/mode.py``)."""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.ref import decode_attention_plain
from repro_torch.kernels.mode import (H100_SMS, MAX_CLUSTER, aligned16,
                                      launch_counts, sm_count, use_kernel)


# The kernel's tile and its shared memory (decode_attention.cu): K and V
# of up to 64 keys per stage, two stages for a longer range, up to ~8 KB
# more for q, the cluster's partials and the barriers; up to 8 blocks an
# SM.
_TILE_KEYS, _KEY_BYTES, _EXTRA_BYTES, _MAX_BLOCKS = 64, 2 * 64 * 4, 8192, 8
_SMEM_PER_SM, _SMEM_PER_BLOCK_RESERVED = 228 * 1024, 1024


def decode_split_plan(b: int, hkv: int, t: int,
                      sms: int = H100_SMS) -> tuple[int, int]:
    """(splits, chunk): each (row, KV head) runs as a cluster of ``splits``
    blocks, block i owning keys [i chunk, min((i + 1) chunk, t)) (empty
    where it starts at or past t).  The most splits (at most 8, at most
    one per 16 keys) whose whole grid is resident on the card at once:
    a second wave of blocks costs more than the splits gain (at the serve
    shape, 2 splits: 320 blocks of two 64-key stages, 3 per SM)."""
    rows = max(1, b * hkv)
    best = 1
    for splits in range(2, min(MAX_CLUSTER, max(1, -(-t // 16))) + 1):
        chunk = -(-t // splits)
        tile = min(chunk, _TILE_KEYS)
        stages = 2 if chunk > tile else 1
        smem = stages * tile * _KEY_BYTES + _EXTRA_BYTES
        per_sm = min(_MAX_BLOCKS,
                     _SMEM_PER_SM // (smem + _SMEM_PER_BLOCK_RESERVED))
        if rows * splits <= sms * per_sm:
            best = splits
    return best, max(1, -(-t // best))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """q: (B, H, D); k/v: (B, Hkv, T, D) f32; kv_len: (B,) -> (B, H, D).
    The two routes agree to float32 summation order."""
    if not use_kernel(q):
        return decode_attention_plain(q, k, v, kv_len)
    from repro_torch.kernels.build import load_kernels
    ext = load_kernels()
    splits, chunk = decode_split_plan(k.shape[0], k.shape[1], k.shape[2],
                                      sm_count(q.device))
    out = ext.decode_attention(aligned16(q), aligned16(k), aligned16(v),
                               kv_len.to(torch.int32).contiguous(), splits,
                               chunk)
    launch_counts["decode_attention"] += 1
    return out
