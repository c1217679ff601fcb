"""Public wrapper of decode attention: the CUDA kernel for a CUDA tensor,
the plain version for a CPU tensor (``kernels/mode.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.decode_attention.ref import decode_attention_plain
from repro_torch.kernels.mode import (H100_SMS, MAX_CLUSTER, aligned16,
                                      launch_counts, launch_name, sm_count,
                                      use_kernel)


# The float32 instance's tiles and their shared memory
# (decode_attention.cu), per compiled head dim D: K and V of up to 64 keys
# per stage at D = 64 and 32 at D = 128 (one key of K and V: 2 x D
# float32), two stages for a longer range, up to ~8 KB more for q, the
# cluster's partials and the barriers; up to 8 blocks an SM at D = 64 and
# 4 at D = 128 (the instances' register caps).
_TILE_KEYS = {64: 64, 128: 32}
_MAX_BLOCKS = {64: 8, 128: 4}
_EXTRA_BYTES = 8192
_SMEM_PER_SM, _SMEM_PER_BLOCK_RESERVED = 228 * 1024, 1024
# The int8 instance's: 32 KB of K and V per stage (256 keys at D = 64, 128
# at D = 128) and the stage's two scale arrays (4 bytes a key); up to 2
# blocks of 8 warps an SM (its register cap).
INT8_TILE_KEYS = {64: 256, 128: 128}
_INT8_MAX_BLOCKS = 2


def bytes_per_key(head_dim: int, int8: bool = False) -> int:
    """Shared memory of one key of K and V (and, for ``int8``, its two
    scales) in the instance for ``head_dim``."""
    return 2 * head_dim + 8 if int8 else 8 * head_dim


def resident_blocks_per_sm(chunk: int, head_dim: int, int8: bool) -> int:
    """Resident blocks per SM of a plan with ranges of ``chunk`` keys: a
    range of one tile or less is one stage sized to it, a longer one two
    full stages."""
    tile_keys = (INT8_TILE_KEYS if int8 else _TILE_KEYS)[head_dim]
    tile = min(chunk, tile_keys)
    stages = 2 if chunk > tile else 1
    smem = stages * tile * bytes_per_key(head_dim, int8) + _EXTRA_BYTES
    cap = _INT8_MAX_BLOCKS if int8 else _MAX_BLOCKS[head_dim]
    return min(cap, _SMEM_PER_SM // (smem + _SMEM_PER_BLOCK_RESERVED))


# The query heads of one instance (decode_attention.cu): a larger GQA
# group runs as sub-groups of this many heads or fewer.
MAX_SUBGROUP = 8


def decode_subgroup(group: int) -> int:
    """Query heads of a sub-group for a GQA group of ``group`` heads: the
    largest divisor of ``group`` at most 8, the compiled instance that
    serves it (``decode_attention.cu::decode_attention_subgroup``; 16 ->
    8, 48 -> 8, 3 -> 3)."""
    g = max(1, min(group, MAX_SUBGROUP))
    while group % g:
        g -= 1
    return g


def decode_split_plan(b: int, hkv: int, t: int, sms: int = H100_SMS,
                      head_dim: int = 64, int8: bool = False,
                      group: int = 1) -> tuple[int, int]:
    """(splits, chunk): each (row, head slot) runs as a cluster of
    ``splits`` blocks, block i owning keys [i chunk, min((i + 1) chunk, t))
    (empty where it starts at or past t).  ``head_dim`` picks the instance
    (64 or 128), ``int8`` its int8 K/V.  A head slot is one sub-group of
    the KV head's ``group`` query heads (``decode_subgroup``): the grid has
    hkv x group / G' of them, G' the sub-group's heads.

    Float32: the most splits (at most 8, at most one per 16 keys) whose
    whole grid is resident on the card at once: a second wave of blocks
    costs more than the splits gain (at smollm-360m's serve shape, 2
    splits: 320 blocks of two 64-key stages, 3 per SM).

    int8: the fewest splits whose grid covers every SM (one split where
    the (row, KV head) clusters alone do), at most the most whose grid is
    resident: its blocks carry 32 KB tiles, and a cluster's fixed costs
    (a barrier, rank 0's merge) outweigh shorter ranges.  One split at
    both serve shapes (smollm-360m's 160 rows, granite-8b's 256), where 2
    splits measured 32-51 % slower and 4 splits 87-93 %
    (``tools/kernel_variants.py``)."""
    rows = max(1, b * hkv * (group // decode_subgroup(group)))
    most = min(MAX_CLUSTER, max(1, -(-t // 16)))
    resident = [s for s in range(1, most + 1)
                if rows * s <= sms * resident_blocks_per_sm(
                    -(-t // s), head_dim, int8)]
    best = max(resident, default=1)
    if int8:
        best = min([s for s in resident if rows * s >= sms] or [best])
    return best, max(1, -(-t // best))


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor,
                     k_scale: Optional[torch.Tensor] = None,
                     v_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q: (B, H, D); k/v: (B, Hkv, T, D) f32, or int8 with ``k_scale``/
    ``v_scale`` (B, Hkv, T, 1) f32 (both or neither); kv_len: (B,) ->
    (B, H, D), any GQA group H / Hkv (above 8 by sub-groups).  The two
    routes agree to float32 summation order.  Launches count under
    ``decode_launch_name``: ``decode_attention`` and
    ``decode_attention_int8`` at D = 64, ``..._d128`` at D = 128, and
    ``..._g<group>`` for a group above 8."""
    assert (k_scale is None) == (v_scale is None)
    if not use_kernel(q):
        return decode_attention_plain(q, k, v, kv_len, k_scale, v_scale)
    from repro_torch.kernels.build import load_kernels
    ext = load_kernels()
    kvl = kv_len.to(torch.int32).contiguous()
    d, int8 = q.shape[-1], k_scale is not None
    group = q.shape[1] // max(1, k.shape[1])
    # A head dim the kernel is not compiled for gets the smallest plan;
    # the binding then raises.
    splits, chunk = (decode_split_plan(
        k.shape[0], k.shape[1], k.shape[2], sm_count(q.device), d, int8,
        group) if d in _TILE_KEYS else (1, max(1, k.shape[2])))
    if not int8:
        out = ext.decode_attention(aligned16(q), aligned16(k), aligned16(v),
                                   kvl, splits, chunk)
    else:
        out = ext.decode_attention_int8(aligned16(q), aligned16(k),
                                        aligned16(v), aligned16(k_scale),
                                        aligned16(v_scale), kvl, splits,
                                        chunk)
    launch_counts[decode_launch_name(d, int8, group)] += 1
    return out


def decode_launch_name(head_dim: int, int8: bool, group: int) -> str:
    """The ``launch_counts`` key of a decode launch: ``launch_name``'s,
    with ``_g<group>`` for a group served by sub-groups (above 8:
    ``decode_attention_d128_g48``)."""
    name = launch_name("decode_attention", head_dim, int8)
    return name if group <= MAX_SUBGROUP else f"{name}_g{group}"


def decode_attention_paged(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, table: torch.Tensor,
                           kv_len: torch.Tensor,
                           k_scale_pages: Optional[torch.Tensor] = None,
                           v_scale_pages: Optional[torch.Tensor] = None, *,
                           buf_len: int) -> torch.Tensor:
    """Decode attention over a paged KV pool
    (``decode_attention/ops.py:24``): ``k_pages``/``v_pages`` (P, Hkv,
    page, D), the scales' pools (P, Hkv, page, 1) for int8, ``table``
    (B, n_lp) (0 = unmapped).  The table is resolved into a (B, Hkv,
    buf_len, D) view (``kernels/paged.py``) and ``decode_attention`` runs
    on it unchanged: on a CUDA tensor the kernel, launched and counted
    as on a contiguous arena."""
    from repro_torch.kernels.paged import gather_kv_pages
    k = gather_kv_pages(k_pages, table, buf_len)
    v = gather_kv_pages(v_pages, table, buf_len)
    ks = vs = None
    if k_scale_pages is not None:
        ks = gather_kv_pages(k_scale_pages, table, buf_len)
        vs = gather_kv_pages(v_scale_pages, table, buf_len)
    return decode_attention(q, k, v, kv_len, ks, vs)
