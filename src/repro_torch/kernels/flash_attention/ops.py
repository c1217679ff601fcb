"""Public wrapper of flash attention: the CUDA kernel for a CUDA tensor,
the plain version for a CPU tensor (``kernels/mode.py``)."""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ref import flash_attention_plain
from repro_torch.kernels.mode import aligned16, launch_counts, use_kernel


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_offset: Optional[torch.Tensor] = None,
                    kv_len: Optional[torch.Tensor] = None, *,
                    window: int = 0) -> torch.Tensor:
    """Causal attention.  q: (B, H, S, D); k/v: (B, Hkv, T, D) f32;
    optional (B,) i32 ``q_offset``/``kv_len`` (defaults: offset 0, full
    T) -> (B, H, S, D).  The two routes agree to float32 summation
    order."""
    if not use_kernel(q):
        return flash_attention_plain(q, k, v, q_offset, kv_len,
                                     window=window)
    from repro_torch.kernels.build import load_kernels
    ext = load_kernels()
    b, t = q.shape[0], k.shape[2]
    dev = q.device
    if q_offset is None:
        q_offset = torch.zeros(b, dtype=torch.int32, device=dev)
    if kv_len is None:
        kv_len = torch.full((b,), t, dtype=torch.int32, device=dev)
    out = ext.flash_attention(
        aligned16(q), aligned16(k), aligned16(v),
        q_offset.to(torch.int32).reshape(-1).expand(b).contiguous(),
        kv_len.to(torch.int32).reshape(-1).expand(b).contiguous(),
        int(window))
    launch_counts["flash_attention"] += 1
    return out
