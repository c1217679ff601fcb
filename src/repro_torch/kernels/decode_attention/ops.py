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
# (decode_attention.cu), per compiled head dim D, for a GQA group of up to
# 8: K and V of up to 64 keys per stage at D = 64 and 32 at D = 128 (one
# key of K and V: 2 x D float32), two stages for a longer range, up to
# ~8 KB more for q, the cluster's partials and the barriers; up to 8
# blocks an SM at D = 64 and 4 at D = 128 (the instances' register caps).
_TILE_KEYS = {64: 64, 128: 32}
_MAX_BLOCKS = {64: 8, 128: 4}
_EXTRA_BYTES = 8192
_SMEM_PER_SM, _SMEM_PER_BLOCK_RESERVED = 228 * 1024, 1024
# A block's dynamic shared memory on the card (227 KB).
SMEM_PER_BLOCK = 227 * 1024
# The int8 instance's: 32 KB of K and V per stage (256 keys at D = 64, 128
# at D = 128) and the stage's two scale arrays (4 bytes a key); up to 2
# blocks of 8 warps an SM (its register cap).
INT8_TILE_KEYS = {64: 256, 128: 128}
_INT8_MAX_BLOCKS = 2
# The float32 instance for a group above 8 (``decode_attention.cu``'s
# group instance): one block, or one cluster of key splits, per (row, KV
# head) holding all the group's query heads as MT m-tiles of 16 on the
# tensor cores (at most 3: a group above 48 runs as head slots of at most
# 48 heads, ``group_slots``), MT x KS warps taking 32-key tiles in KS
# slices (``group_slices``); ``group_smem_bytes`` counts its shared
# memory.  Blocks an SM at most (the registers): 1 at MT = 3 (12 warps of
# 168), 5 and 2 below (2 and 4 warps of up to 185).
GROUP_TILE_KEYS, GROUP_SLOT_HEADS = 32, 48
_GROUP_MAX_BLOCKS = {1: 5, 2: 2, 3: 1}


def group_slots(group: int) -> tuple[int, int]:
    """(slots, heads): the group instance's head slots a KV head and the
    most query heads of one (``decode_attention.cu::decode_group_slots``):
    one slot of the whole group up to 48 heads, else the fewest slots of
    at most 48 (56 -> 2 of 28, 128 -> 3 of 43), each reading the K/V
    row."""
    slots = max(1, -(-group // GROUP_SLOT_HEADS))
    return slots, -(-group // slots)


def group_slices(group: int) -> tuple[int, int]:
    """(m-tiles, key slices) of the group instance for ``group`` query
    heads a KV head (``decode_attention.cu::group_slices``): 16 heads an
    m-tile of a slot; 4 slices at 3 m-tiles, else 2."""
    mt = -(-group_slots(group)[1] // 16)
    return mt, 4 if mt == 3 else 2


def group_smem_bytes(head_dim: int, group: int) -> int:
    """Dynamic shared memory of the group instance (``GLayout`` in
    ``decode_attention.cu``), whatever the plan: one stage a slice (K then
    V of 32 keys, D floats a row), over which the warps' partials (16
    heads a warp: m, l, two floats of padding and D accumulators) and the
    cluster's pushed partials (up to 16 MT + 8 heads) land; q of 16 MT
    heads in rows of D + 16 floats; then 2 mbarriers a stage."""
    mt, ks = group_slices(group)
    part = head_dim + 4
    area = max(ks * 2 * GROUP_TILE_KEYS * head_dim,
               (mt * ks * 16 + 16 * mt + MAX_CLUSTER) * part)
    floats = (area + 16 * mt * (head_dim + 16) + 1) & ~1
    return 4 * floats + 16 * ks


def group_blocks_per_sm(head_dim: int, group: int) -> int:
    """Resident blocks per SM of the group instance: its shared memory
    against the SM's, at most its register cap."""
    smem = group_smem_bytes(head_dim, group)
    return min(_GROUP_MAX_BLOCKS[group_slices(group)[0]],
               _SMEM_PER_SM // (smem + _SMEM_PER_BLOCK_RESERVED))


def bytes_per_key(head_dim: int, int8: bool = False) -> int:
    """Shared memory of one key of K and V (and, for ``int8``, its two
    scales) in the instance for ``head_dim`` (a group of up to 8)."""
    return 2 * head_dim + 8 if int8 else 8 * head_dim


def resident_blocks_per_sm(chunk: int, head_dim: int, int8: bool) -> int:
    """Resident blocks per SM of a plan with ranges of ``chunk`` keys (a
    group of up to 8, or int8 sub-groups): a range of one tile or less is
    one stage sized to it, a longer one two full stages."""
    tile_keys = (INT8_TILE_KEYS if int8 else _TILE_KEYS)[head_dim]
    tile = min(chunk, tile_keys)
    stages = 2 if chunk > tile else 1
    smem = stages * tile * bytes_per_key(head_dim, int8) + _EXTRA_BYTES
    cap = _INT8_MAX_BLOCKS if int8 else _MAX_BLOCKS[head_dim]
    return min(cap, _SMEM_PER_SM // (smem + _SMEM_PER_BLOCK_RESERVED))


# The query heads of one instance of the G <= 8 kernels
# (decode_attention.cu): the int8 branch runs a larger GQA group as
# sub-groups of this many heads or fewer.
MAX_SUBGROUP = 8


def decode_subgroup(group: int) -> int:
    """Query heads of a sub-group of the int8 branch for a GQA group of
    ``group`` heads: the largest divisor of ``group`` at most 8, the
    compiled instance that serves it
    (``decode_attention.cu::decode_attention_subgroup``; 16 -> 8, 48 ->
    8, 3 -> 3).  The float32 branch runs a group above 8 on its group
    instance, whole."""
    g = max(1, min(group, MAX_SUBGROUP))
    while group % g:
        g -= 1
    return g


def decode_split_plan(b: int, hkv: int, t: int, sms: int = H100_SMS,
                      head_dim: int = 64, int8: bool = False,
                      group: int = 1) -> tuple[int, int]:
    """(splits, chunk): each (row, KV head), or each head slot of the
    int8 branch's sub-groups, runs as a cluster of ``splits`` blocks,
    block i owning keys [i chunk, min((i + 1) chunk, t)) (empty where it
    starts at or past t).  ``head_dim`` picks the instance (64 or 128),
    ``int8`` its int8 K/V, ``group`` the query heads of a KV head.

    Float32, group of up to 8: the most splits (at most 8, at most one
    per 16 keys) whose whole grid is resident on the card at once: a
    second wave of blocks costs more than the splits gain (at
    smollm-360m's serve shape, 2 splits: 320 blocks of two 64-key stages,
    3 per SM).

    Float32, group above 8 (the group instance): a plan over the b x hkv
    (x ``group_slots``, above 48 heads) clusters.  One split while the
    row's 32-key tiles are no more than the block's key slices (its
    slices take them at once); else the most splits (the same caps)
    whose ranges still give every slice a tile and whose clusters fit
    three quarters of the blocks the SMs hold (a cluster takes its SMs in
    one GPC: at one block an SM the card held 30 clusters of 4, not 33).
    1 split at granite-34b's serve shape (3 tiles, 4 slices) and 3 of
    1,366 keys over 4,096 keys (32 clusters, one block an SM); 1 at
    llama3-405b's (256 clusters, 3 blocks an SM).

    int8: the fewest splits whose grid covers every SM (one split where
    the clusters alone do), at most the most whose grid is resident: its
    blocks carry 32 KB tiles, and a cluster's fixed costs (a barrier,
    rank 0's merge) outweigh shorter ranges.  One split at both serve
    shapes (smollm-360m's 160 rows, granite-8b's 256), where 2 splits
    measured 32-51 % slower and 4 splits 87-93 %
    (``tools/kernel_variants.py``).  A group above 8 plans over its head
    slots: hkv x group / G', G' the sub-group's heads."""
    most = min(MAX_CLUSTER, max(1, -(-t // 16)))
    if group > MAX_SUBGROUP and not int8:
        rows = max(1, b * hkv * group_slots(group)[0])
        slices = group_slices(group)[1]
        if -(-t // GROUP_TILE_KEYS) <= slices:
            return 1, max(1, t)
        cap = 3 * sms * group_blocks_per_sm(head_dim, group) // 4
        best = max([s for s in range(1, most + 1) if rows * s <= cap
                    and -(-t // s) >= slices * GROUP_TILE_KEYS], default=1)
        return best, max(1, -(-t // best))
    rows = max(1, b * hkv * (group // decode_subgroup(group)))
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
    (B, H, D).  Any GQA group H / Hkv: float32 above 8 on the group
    instance, one block or cluster per (row, KV head) holding the whole
    group on the tensor cores (3 TF32 products a product; above 48 heads,
    per head slot of at most 48), int8 above 8 by sub-groups of up to
    8.  The two
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
    with ``_g<group>`` for a group above 8 (``decode_attention_d128_g48``:
    the float32 group instance; ``decode_attention_int8_d128_g48``: the
    int8 sub-groups)."""
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
