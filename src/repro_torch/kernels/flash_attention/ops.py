"""Public wrapper of flash attention: the CUDA kernel for a CUDA tensor,
the plain version for a CPU tensor (``kernels/mode.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ref import flash_attention_plain
from repro_torch.kernels.mode import (aligned16, launch_counts, launch_name,
                                      use_kernel)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_offset: Optional[torch.Tensor] = None,
                    kv_len: Optional[torch.Tensor] = None,
                    k_scale: Optional[torch.Tensor] = None,
                    v_scale: Optional[torch.Tensor] = None, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """Causal (or, ``causal=False``, non-causal) attention.  q: (B, H, S,
    D); k/v: (B, Hkv, T, D) f32, or int8 with ``k_scale``/``v_scale`` (B,
    Hkv, T, 1) f32 (both or neither); optional (B,) i32
    ``q_offset``/``kv_len`` (defaults: offset 0, full T) -> (B, H, S, D).
    The two routes agree to float32 summation order (the tensor-core
    instances, head dim 128 and int8 at 64, to float32 accuracy).
    Launches count under ``launch_name``: ``flash_attention`` and
    ``flash_attention_int8`` at D = 64, ``..._d128`` at D = 128."""
    assert (k_scale is None) == (v_scale is None)
    if not use_kernel(q):
        return flash_attention_plain(q, k, v, q_offset, kv_len, k_scale,
                                     v_scale, causal=causal, window=window)
    from repro_torch.kernels.build import load_kernels
    ext = load_kernels()
    b, t = q.shape[0], k.shape[2]
    dev = q.device
    if q_offset is None:
        q_offset = torch.zeros(b, dtype=torch.int32, device=dev)
    if kv_len is None:
        kv_len = torch.full((b,), t, dtype=torch.int32, device=dev)
    q_offset = q_offset.to(torch.int32).reshape(-1).expand(b).contiguous()
    kv_len = kv_len.to(torch.int32).reshape(-1).expand(b).contiguous()
    if k_scale is None:
        out = ext.flash_attention(aligned16(q), aligned16(k), aligned16(v),
                                  q_offset, kv_len, int(window),
                                  bool(causal))
    else:
        out = ext.flash_attention_int8(aligned16(q), aligned16(k),
                                       aligned16(v), k_scale.contiguous(),
                                       v_scale.contiguous(), q_offset,
                                       kv_len, int(window), bool(causal))
    launch_counts[launch_name("flash_attention", q.shape[-1],
                              k_scale is not None)] += 1
    return out


def flash_attention_paged(q: torch.Tensor, k_pages: torch.Tensor,
                          v_pages: torch.Tensor, table: torch.Tensor,
                          q_offset: Optional[torch.Tensor] = None,
                          kv_len: Optional[torch.Tensor] = None,
                          k_scale_pages: Optional[torch.Tensor] = None,
                          v_scale_pages: Optional[torch.Tensor] = None, *,
                          buf_len: int, causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """Flash attention over a paged KV pool
    (``flash_attention/ops.py:29``): the pools and ``table`` as in
    ``decode_attention_paged``; the table is resolved into a (B, Hkv,
    buf_len, D) view and ``flash_attention`` runs on it unchanged."""
    from repro_torch.kernels.paged import gather_kv_pages
    k = gather_kv_pages(k_pages, table, buf_len)
    v = gather_kv_pages(v_pages, table, buf_len)
    ks = vs = None
    if k_scale_pages is not None:
        ks = gather_kv_pages(k_scale_pages, table, buf_len)
        vs = gather_kv_pages(v_scale_pages, table, buf_len)
    return flash_attention(q, k, v, q_offset, kv_len, ks, vs, causal=causal,
                           window=window)
