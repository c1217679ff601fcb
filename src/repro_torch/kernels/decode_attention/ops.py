"""Public wrapper of decode attention: the CUDA kernel for a CUDA tensor,
the plain version for a CPU tensor (``kernels/mode.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention.ref import decode_attention_plain
from repro_torch.kernels.mode import (H100_SMS, MAX_CLUSTER, aligned16,
                                      launch_counts, sm_count, use_kernel)


# The kernel's tile and its shared memory (decode_attention.cu): K and V
# of up to 64 keys per stage (one key of K and V: 2 x 64 float32, or 2 x
# 64 int8 for the int8 instance, whose scales are loaded straight into
# registers), two stages for a longer range, up to ~8 KB more for q, the
# cluster's partials and the barriers; up to 8 blocks an SM.
_TILE_KEYS, _EXTRA_BYTES, _MAX_BLOCKS = 64, 8192, 8
KEY_BYTES_F32, KEY_BYTES_INT8 = 2 * 64 * 4, 2 * 64 * 1
_SMEM_PER_SM, _SMEM_PER_BLOCK_RESERVED = 228 * 1024, 1024


def decode_split_plan(b: int, hkv: int, t: int, sms: int = H100_SMS,
                      key_bytes: int = KEY_BYTES_F32) -> tuple[int, int]:
    """(splits, chunk): each (row, KV head) runs as a cluster of ``splits``
    blocks, block i owning keys [i chunk, min((i + 1) chunk, t)) (empty
    where it starts at or past t).  The most splits (at most 8, at most
    one per 16 keys) whose whole grid is resident on the card at once:
    a second wave of blocks costs more than the splits gain (at the serve
    shape, 2 splits: 320 blocks of two 64-key stages, 3 per SM).
    ``key_bytes`` is the shared memory of one key of K and V
    (``KEY_BYTES_INT8`` for the int8 instance)."""
    rows = max(1, b * hkv)
    best = 1
    for splits in range(2, min(MAX_CLUSTER, max(1, -(-t // 16))) + 1):
        chunk = -(-t // splits)
        tile = min(chunk, _TILE_KEYS)
        stages = 2 if chunk > tile else 1
        smem = stages * tile * key_bytes + _EXTRA_BYTES
        per_sm = min(_MAX_BLOCKS,
                     _SMEM_PER_SM // (smem + _SMEM_PER_BLOCK_RESERVED))
        if rows * splits <= sms * per_sm:
            best = splits
    return best, max(1, -(-t // best))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, H, D); k/v: (B, Hkv, T, D) f32, or int8 with ``k_scale``/
    ``v_scale`` (B, Hkv, T, 1) f32 (both or neither); kv_len: (B,) ->
    (B, H, D).  The two routes agree to float32 summation order.  The
    int8 instance counts under ``decode_attention_int8``."""
    assert (k_scale is None) == (v_scale is None)
    if not use_kernel(q):
        return decode_attention_plain(q, k, v, kv_len, k_scale, v_scale)
    from repro_torch.kernels.build import load_kernels
    ext = load_kernels()
    kvl = kv_len.to(torch.int32).contiguous()
    if k_scale is None:
        splits, chunk = decode_split_plan(k.shape[0], k.shape[1],
                                          k.shape[2], sm_count(q.device))
        out = ext.decode_attention(aligned16(q), aligned16(k), aligned16(v),
                                   kvl, splits, chunk)
        launch_counts["decode_attention"] += 1
        return out
    splits, chunk = decode_split_plan(k.shape[0], k.shape[1], k.shape[2],
                                      sm_count(q.device), KEY_BYTES_INT8)
    out = ext.decode_attention_int8(aligned16(q), aligned16(k), aligned16(v),
                                    k_scale.contiguous(),
                                    v_scale.contiguous(), kvl, splits, chunk)
    launch_counts["decode_attention_int8"] += 1
    return out
