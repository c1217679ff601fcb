"""Plain PyTorch version of the ``decode_attention`` kernel.

It follows the KERNEL's contract (``repro/kernels/decode_attention/
kernel.py``): a masked softmax whose max is pinned to 0 on a fully
masked row and whose denominator is floored at 1e-30, so a row with
``kv_len == 0`` gives zeros.  The JAX reference ``decode_attention_ref``
uses a plain softmax and gives NaN there; on every row with at least
one live key the two agree."""

from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels.flash_attention.ref import masked_softmax


def decode_attention_plain(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, kv_len: torch.Tensor,
                           k_scale: Optional[torch.Tensor] = None,
                           v_scale: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """q: (B, H, D); k/v: (B, Hkv, T, D); kv_len: (B,) -> (B, H, D).

    ``k_scale``/``v_scale`` (B, Hkv, T, 1), both or neither: dequant
    scales of int8 k/v, ``k.float() * k_scale`` before the math
    (``repro/kernels/decode_attention/ref.py:11-34``)."""
    b, h, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = h // hkv
    kf, vf = k.float(), v.float()
    if k_scale is not None:
        kf, vf = kf * k_scale, vf * v_scale
    qr = q.reshape(b, hkv, g, d).float()
    scores = torch.einsum("bhgd,bhtd->bhgt", qr, kf) / math.sqrt(d)
    valid = (torch.arange(t, device=q.device)[None, :]
             < kv_len.to(torch.int64)[:, None])                # (B, T)
    w = masked_softmax(scores, valid[:, None, None, :])
    out = torch.einsum("bhgt,bhtd->bhgd", w, vf)
    return out.reshape(b, h, d).to(q.dtype)
