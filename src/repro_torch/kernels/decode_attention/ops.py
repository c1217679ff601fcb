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
# The group instance for a group above 8 (``decode_attention.cu``'s
# ``decode_attention_group_kernel``, float32 or int8 K/V): one block, or one
# cluster of key splits, per (row, KV head slot) holding the slot's query
# heads as MT m-tiles of 16 on the tensor cores (at most 3: a group above
# 48 runs as head slots of at most 48 heads, ``group_slots``; the int8 plan
# takes slots of 16 heads over a short row), MT x KS warps taking 32-key
# tiles in KS slices (``group_slices``), 1 stage a slice for float32 K/V
# and ``GROUP_INT8_STAGES`` for int8; ``group_smem_bytes`` counts its
# shared memory.  Blocks an SM at most (the registers, by int8 and MT):
# float32 1 at MT = 3 (12 warps of 168), 5 and 2 below (2 and 4 warps of
# 183 registers at D = 64; at D = 128, 246, the shared memory binds
# first); int8 1 at MT = 3, 2 and 1 below (4 and 8 warps of up to 255).
GROUP_TILE_KEYS, GROUP_SLOT_HEADS, GROUP_INT8_STAGES = 32, 48, 2
_GROUP_MAX_BLOCKS = {False: {1: 5, 2: 2, 3: 1}, True: {1: 2, 2: 1, 3: 1}}


def group_slots(group: int, most: int = GROUP_SLOT_HEADS
                ) -> tuple[int, int]:
    """(slots, heads): the group instance's head slots a KV head and the
    most query heads of one: one slot of the whole group up to ``most``
    heads, else the fewest slots of at most ``most`` (48, the float32
    instance's, ``decode_attention.cu::decode_group_slots``: 56 -> 2 of
    28, 128 -> 3 of 43; 16, the int8 plan's over a short row: 48 -> 3 of
    16), each reading the K/V row."""
    slots = max(1, -(-group // most))
    return slots, -(-group // slots)


def group_slices(group: int, slots: int = 0,
                 int8: bool = False) -> tuple[int, int]:
    """(m-tiles, key slices) of the group instance for ``group`` query
    heads a KV head over ``slots`` head slots (default ``group_slots``'s)
    (``decode_attention.cu::group_slices``): 16 heads an m-tile of a slot;
    4 slices at 3 m-tiles and for int8 K/V, else 2."""
    heads = -(-group // (slots or group_slots(group)[0]))
    mt = -(-heads // 16)
    return mt, 4 if int8 or mt == 3 else 2


def group_smem_bytes(head_dim: int, group: int, int8: bool = False,
                     slots: int = 0) -> int:
    """Dynamic shared memory of the group instance (``GLayout`` in
    ``decode_attention.cu``), whatever the plan: stages of 32-key tiles
    (float32: 1 a slice, K then V, D floats a row; int8: 2 a slice, K and V
    of D bytes a row and the two scale spans of 36 floats), over which the
    warps' partials (16 heads a warp: m, l, two floats of padding and D
    accumulators) and the cluster's pushed partials (up to 16 MT + 8 heads)
    land; q of 16 MT heads in rows of D + 16 floats; then 2 mbarriers a
    stage."""
    mt, ks = group_slices(group, slots, int8)
    stages = ks * (GROUP_INT8_STAGES if int8 else 1)
    stage = (2 * GROUP_TILE_KEYS * head_dim + 8 * ((GROUP_TILE_KEYS + 6) & ~3)
             if int8 else 8 * GROUP_TILE_KEYS * head_dim)
    area = max(stages * stage,
               4 * (mt * ks * 16 + 16 * mt + MAX_CLUSTER) * (head_dim + 4))
    return ((area + 4 * 16 * mt * (head_dim + 16) + 7) & ~7) + 16 * stages


def group_blocks_per_sm(head_dim: int, group: int, int8: bool = False,
                        slots: int = 0) -> int:
    """Resident blocks per SM of the group instance: its shared memory
    against the SM's, at most its register cap."""
    smem = group_smem_bytes(head_dim, group, int8, slots)
    return min(_GROUP_MAX_BLOCKS[int8][group_slices(group, slots)[0]],
               _SMEM_PER_SM // (smem + _SMEM_PER_BLOCK_RESERVED))


def bytes_per_key(head_dim: int, int8: bool = False) -> int:
    """Shared memory of one key of K and V (and, for ``int8``, its two
    scales) in the instance for ``head_dim`` (a group of up to 8)."""
    return 2 * head_dim + 8 if int8 else 8 * head_dim


def resident_blocks_per_sm(chunk: int, head_dim: int, int8: bool) -> int:
    """Resident blocks per SM of a plan with ranges of ``chunk`` keys (a
    group of up to 8): a range of one tile or less is one stage sized to
    it, a longer one two full stages."""
    tile_keys = (INT8_TILE_KEYS if int8 else _TILE_KEYS)[head_dim]
    tile = min(chunk, tile_keys)
    stages = 2 if chunk > tile else 1
    smem = stages * tile * bytes_per_key(head_dim, int8) + _EXTRA_BYTES
    cap = _INT8_MAX_BLOCKS if int8 else _MAX_BLOCKS[head_dim]
    return min(cap, _SMEM_PER_SM // (smem + _SMEM_PER_BLOCK_RESERVED))


# The most query heads a KV head of the G <= 8 instances
# (decode_attention.cu); a larger group runs on the group instance.
MAX_SMALL_GROUP = 8


def decode_group_plan(b: int, hkv: int, t: int, sms: int = H100_SMS,
                      head_dim: int = 64, group: int = 9,
                      int8: bool = False) -> tuple[int, int, int]:
    """(slots, splits, chunk) of the group instance (a group above 8):
    ``slots`` head slots a KV head, each (row, slot) a cluster of
    ``splits`` blocks, block i owning keys [i chunk, min((i + 1) chunk,
    t)).  Depends on shapes only.

    Slots: float32 ``group_slots(group)`` (one slot up to 48 heads); int8
    the same, except over a short row, one whose 32-key tiles a 16-head
    block's stages hold at once (t <= 256): then slots of 16 heads (48 ->
    3), for three times the blocks over a row that L2 serves again
    (granite-34b's serve shape: 6.9 against 10.7 us in one slot,
    ``tools/kernel_variants.py``).

    Splits: one while the row's tiles are no more than the block's key
    slices (its slices take them at once); else the most (at most 8, one
    per 16 keys) whose ranges still give every slice a tile and whose
    clusters fit three quarters of the blocks the SMs hold (a cluster
    takes its SMs in one GPC: at one block an SM the card held 30 clusters
    of 4, not 33).  Float32: 1 split at granite-34b's serve shape (3
    tiles, 4 slices) and 3 of 1,366 keys over 4,096 keys (32 clusters, one
    block an SM); 1 at llama3-405b's (256 clusters, 3 blocks an SM)."""
    tiles = -(-t // GROUP_TILE_KEYS)
    slots = group_slots(group)[0]
    if int8:
        short = group_slots(group, 16)[0]
        if tiles <= group_slices(group, short, True)[1] * GROUP_INT8_STAGES:
            slots = short
    rows = max(1, b * hkv * slots)
    ks = group_slices(group, slots, int8)[1]
    if tiles <= ks:
        return slots, 1, max(1, t)
    most = min(MAX_CLUSTER, max(1, -(-t // 16)))
    cap = 3 * sms * group_blocks_per_sm(head_dim, group, int8, slots) // 4
    best = max([s for s in range(1, most + 1) if rows * s <= cap
                and -(-t // s) >= ks * GROUP_TILE_KEYS], default=1)
    return slots, best, max(1, -(-t // best))


def decode_split_plan(b: int, hkv: int, t: int, sms: int = H100_SMS,
                      head_dim: int = 64, int8: bool = False,
                      group: int = 1) -> tuple[int, int]:
    """(splits, chunk): each (row, KV head), or each (row, head slot) of
    the group instance, runs as a cluster of ``splits`` blocks, block i
    owning keys [i chunk, min((i + 1) chunk, t)) (empty where it starts at
    or past t).  ``head_dim`` picks the instance (64 or 128), ``int8`` its
    int8 K/V, ``group`` the query heads of a KV head.

    Float32, group of up to 8: the most splits (at most 8, at most one
    per 16 keys) whose whole grid is resident on the card at once: a
    second wave of blocks costs more than the splits gain (at
    smollm-360m's serve shape, 2 splits: 320 blocks of two 64-key stages,
    3 per SM).

    int8, group of up to 8: the fewest splits whose grid covers every SM
    (one split where the clusters alone do), at most the most whose grid
    is resident: its blocks carry 32 KB tiles, and a cluster's fixed
    costs (a barrier, rank 0's merge) outweigh shorter ranges.  One split
    at both serve shapes (smollm-360m's 160 rows, granite-8b's 256), where
    2 splits measured 32-51 % slower and 4 splits 87-93 %
    (``tools/kernel_variants.py``).

    A group above 8, float32 or int8, runs on the group instance:
    ``decode_group_plan``'s splits over its head slots."""
    if group > MAX_SMALL_GROUP:
        return decode_group_plan(b, hkv, t, sms, head_dim, group, int8)[1:]
    most = min(MAX_CLUSTER, max(1, -(-t // 16)))
    rows = max(1, b * hkv)
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
    (B, H, D).  Any GQA group H / Hkv: above 8 on the group instance, one
    block or cluster per (row, KV head slot) holding the slot's heads on
    the tensor cores (3 TF32 products a product for float32 K/V, 2 for
    int8; ``decode_group_plan``'s slots and splits).  The two routes
    agree to float32 summation order.  Launches count under
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
    b, hkv, t = k.shape[:3]
    group = q.shape[1] // max(1, hkv)
    # A head dim the kernel is not compiled for gets the smallest plan;
    # the binding then raises.
    slots, splits, chunk = 1, 1, max(1, t)
    if d in _TILE_KEYS and group > MAX_SMALL_GROUP:
        slots, splits, chunk = decode_group_plan(b, hkv, t, sm_count(q.device),
                                                 d, group, int8)
    elif d in _TILE_KEYS:
        splits, chunk = decode_split_plan(b, hkv, t, sm_count(q.device), d,
                                          int8, group)
    if not int8:
        out = ext.decode_attention(aligned16(q), aligned16(k), aligned16(v),
                                   kvl, splits, chunk)
    else:
        out = ext.decode_attention_int8(aligned16(q), aligned16(k),
                                        aligned16(v), aligned16(k_scale),
                                        aligned16(v_scale), kvl, splits,
                                        chunk, slots)
    launch_counts[decode_launch_name(d, int8, group)] += 1
    return out


def decode_launch_name(head_dim: int, int8: bool, group: int) -> str:
    """The ``launch_counts`` key of a decode launch: ``launch_name``'s,
    with ``_g<group>`` for a group above 8 (the group instance:
    ``decode_attention_d128_g48`` over float32 K/V,
    ``decode_attention_int8_d128_g48`` over int8)."""
    name = launch_name("decode_attention", head_dim, int8)
    return name if group <= MAX_SMALL_GROUP else f"{name}_g{group}"


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
