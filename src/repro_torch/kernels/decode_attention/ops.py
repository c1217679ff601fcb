"""Public wrapper of decode attention: the CUDA kernel for a CUDA tensor,
the plain version for a CPU tensor (``kernels/mode.py``)."""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention.ref import decode_attention_plain
from repro_torch.kernels.mode import launch_counts, use_kernel


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     kv_len: torch.Tensor) -> torch.Tensor:
    """q: (B, H, D); k/v: (B, Hkv, T, D) f32; kv_len: (B,) -> (B, H, D).
    The two routes agree to float32 summation order."""
    if not use_kernel(q):
        return decode_attention_plain(q, k, v, kv_len)
    from repro_torch.kernels.build import load_kernels
    ext = load_kernels()
    out = ext.decode_attention(q.contiguous(), k.contiguous(),
                               v.contiguous(),
                               kv_len.to(torch.int32).contiguous())
    launch_counts["decode_attention"] += 1
    return out
