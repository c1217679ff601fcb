"""Plain PyTorch version of the ``flash_attention`` kernel (the port's
counterpart of ``repro/kernels/flash_attention/ref.py``), with the same
masked-row contract (``masked_softmax``)."""

from __future__ import annotations

import math
from typing import Optional

import torch


def masked_softmax(scores: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over the last axis of the entries ``mask`` selects.  A row
    with at least one valid entry equals ``softmax`` over the -inf-masked
    scores; a fully masked row gives zeros (the max is pinned to 0 and
    the denominator floored at 1e-30), the kernels' contract."""
    neg_inf = torch.full((), float("-inf"), dtype=scores.dtype,
                         device=scores.device)
    neg = torch.where(mask, scores, neg_inf)
    m = torch.amax(neg, dim=-1, keepdim=True)
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.where(mask, torch.exp(neg - m_safe), torch.zeros_like(neg))
    return p / torch.clamp(p.sum(dim=-1, keepdim=True), min=1e-30)


def flash_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          q_offset: Optional[torch.Tensor] = None,
                          kv_len: Optional[torch.Tensor] = None,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None, *,
                          causal: bool = True,
                          window: int = 0) -> torch.Tensor:
    """Causal (or, ``causal=False``, non-causal) attention.  q: (B, H, S,
    D); k/v: (B, Hkv, T, D); optional (B,) per-row ``q_offset`` (position
    of row b's first query) and ``kv_len`` (valid key prefix).  Returns
    (B, H, S, D).

    ``k_scale``/``v_scale`` (B, Hkv, T, 1), both or neither: dequant
    scales of int8 k/v, ``k.float() * k_scale`` before the math
    (``repro/kernels/flash_attention/ref.py:76-112``)."""
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = h // hkv
    dev = q.device
    kf, vf = k.float(), v.float()
    if k_scale is not None:
        kf, vf = kf * k_scale, vf * v_scale
    qr = q.reshape(b, hkv, g, s, d).float()
    scores = torch.einsum("bhgsd,bhtd->bhgst", qr, kf) / math.sqrt(d)
    q_off = (torch.zeros(b, dtype=torch.int64, device=dev) if q_offset is None
             else q_offset.to(torch.int64).reshape(-1).expand(b))
    kvl = (torch.full((b,), t, dtype=torch.int64, device=dev) if kv_len is None
           else kv_len.to(torch.int64).reshape(-1).expand(b))
    q_pos = q_off[:, None] + torch.arange(s, device=dev)        # (B, S)
    k_pos = torch.arange(t, device=dev)
    mask = k_pos[None, None, :] < kvl[:, None, None]        # (B, S, T)
    if causal:
        mask = mask & (k_pos[None, None, :] <= q_pos[:, :, None])
    if window:
        mask = mask & (k_pos[None, None, :] > q_pos[:, :, None] - window)
    w = masked_softmax(scores, mask[:, None, None])
    out = torch.einsum("bhgst,bhtd->bhgsd", w, vf)
    return out.reshape(b, h, s, d).to(q.dtype)
