"""Shared layers of the attention families: RMSNorm and LayerNorm, RoPE
(split-half layout), GQA attention with its two kernel routes and the
dense path (an optional sliding window), SwiGLU and the GELU MLP,
the attention projections and the init helpers -- the port's
counterpart of ``repro/models/layers.py``.

Parameters are plain dictionaries of tensors in the JAX layout: every
matmul weight is ``(in, out)`` and applied as ``x @ w``, so converted
JAX trees (``models/convert.py``) compute the same function.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Initializers (an explicit torch.Generator; the draws are the port's own,
# not JAX's -- tests that compare the two convert one tree into the other)
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               device) -> torch.Tensor:
    w = torch.randn((in_dim, out_dim), generator=gen, dtype=torch.float32,
                    device=device)
    # In place: no second copy of a giant's lm_head on the card.
    return w.mul_(1.0 / math.sqrt(in_dim)).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype,
               device) -> torch.Tensor:
    w = torch.randn((vocab, dim), generator=gen, dtype=torch.float32,
                    device=device)
    return w.mul_(0.02).to(dtype)


def remat(fn, on: bool, *args):
    """``fn(*args)``, rematerialized on the backward pass when ``on`` and
    autograd is recording: ``torch.utils.checkpoint`` with
    ``use_reentrant=False``, the counterpart of ``scan_blocks``'
    ``jax.checkpoint`` per layer (``repro/models/stack.py:35``).  It
    changes memory, not numbers."""
    if on and torch.is_grad_enabled():
        from torch.utils.checkpoint import checkpoint
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def dense(x: torch.Tensor, w) -> torch.Tensor:
    """``x @ w``, or the W8A8 ``qdot`` for a ``{"q", "s"}`` weight
    (``serving.quant.quantize_params``), so every layer serves both
    float32 and int8 parameter trees (``repro/models/layers.py:30-38``)."""
    if isinstance(w, dict):
        from repro_torch.serving.quant import qdot
        return qdot(x, w)
    return x @ w


# ---------------------------------------------------------------------------
# Norms and RoPE
# ---------------------------------------------------------------------------


def rmsnorm_params(dim: int, dtype, device) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device)}


def rmsnorm(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * params["scale"].float()).to(x.dtype)


def layernorm_params(dim: int, dtype, device) -> dict:
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(params: dict, x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm in float32 (``layers.py:79-86``): the population
    variance, ``rsqrt(var + eps)``, then scale and bias."""
    x32 = x.float()
    mu = torch.mean(x32, dim=-1, keepdim=True)
    centered = x32 - mu
    var = torch.mean(centered * centered, dim=-1, keepdim=True)
    out = centered * torch.rsqrt(var + eps)
    out = out * params["scale"].float() + params["bias"].float()
    return out.to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device) -> torch.Tensor:
    half = head_dim // 2
    expo = torch.arange(half, dtype=torch.float32, device=device) / half
    # A Python-scalar base: float32 pow on the device, with no blocking
    # host-to-device copy (which would wait for all queued device work).
    return 1.0 / torch.pow(float(theta), expo)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, D) with D even; positions: (..., S) integer.  The
    split-half layout of the JAX package (``layers.py:99-106``)."""
    freqs = rope_frequencies(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


def _per_row(val, b: int, device) -> torch.Tensor:
    """Scalar or (B,) -> (B,) int32 tensor."""
    t = torch.as_tensor(val, device=device)
    return t.to(torch.int32).reshape(-1).expand(b).contiguous()


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, q_offset=0, kv_len=None, window: int = 0,
              k_scale=None, v_scale=None,
              use_kernel: bool = False) -> torch.Tensor:
    """GQA attention: q (B, H, S, D), k/v (B, Hkv, T, D) -> (B, H, S, D).

    Per-row ``q_offset``/``kv_len`` (scalar or (B,)) serve cache arenas
    where each batch row sits at its own position.  ``use_kernel``
    routes two cases through the kernels, as the JAX package does
    (``layers.py:164-178``):

      * the single-query decode case (s == 1, non-causal,
        ``kv_len``-masked) through ``kernels/decode_attention``;
      * the causal multi-token case (s > 1) through
        ``kernels/flash_attention``.

    A sliding ``window`` (query at position p sees keys at positions
    above p - window, ``layers.py:199-200``) never takes a kernel route,
    as in JAX (``:164``, ``:171``): the windowed families (mixtral's
    sliding window, recurrentgemma's local attention) run the dense
    path.  Both kernels are compiled for head dims 64 (smollm-360m) and
    128 (granite-8b), decode at any GQA group (above 8 query heads per
    KV head, float32 or int8, on its tensor-core group instance); on the
    card any other head dim raises (there
    is no fallback to the dense path), on the CPU every head dim takes
    the kernels' plain versions.

    Both are online-softmax streams, equal to the dense path up to
    float32 summation order.  Everything else takes the dense path.

    int8 KV arenas pass ``k_scale``/``v_scale`` (B, Hkv, T, 1): the
    kernel routes dequantize in the kernel, the dense path up front, and
    the result lands in q's dtype (``layers.py:179-181,210-212``).
    """
    b, h, s, d = q.shape
    if (use_kernel and s == 1 and not causal and not window
            and kv_len is not None):
        from repro_torch.kernels.decode_attention.ops import decode_attention
        out = decode_attention(q[:, :, 0], k, v, _per_row(kv_len, b, q.device),
                               k_scale, v_scale)
        return out[:, :, None, :]
    if use_kernel and s > 1 and causal and not window:
        from repro_torch.kernels.flash_attention.ops import flash_attention
        kvl = None if kv_len is None else _per_row(kv_len, b, q.device)
        return flash_attention(q, k, v, _per_row(q_offset, b, q.device), kvl,
                               k_scale, v_scale)
    out_dtype = q.dtype
    if k_scale is not None:
        k = k.float() * k_scale
        v = v.float() * v_scale
    hkv = k.shape[1]
    g = h // hkv
    qr = q.reshape(b, hkv, g, s, d)
    scores = torch.einsum("bhgsd,bhtd->bhgst", qr, k) / math.sqrt(d)
    t = k.shape[2]
    q_pos = torch.arange(s, device=q.device)[None, :]
    if isinstance(q_offset, torch.Tensor):
        q_pos = q_offset.to(torch.int64).reshape(-1, 1) + q_pos
    else:
        q_pos = q_pos + int(q_offset)
    k_pos = torch.arange(t, device=q.device)
    mask = torch.ones((1, s, t), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos[None, None, :] <= q_pos[:, :, None])
    if window:
        mask = mask & (k_pos[None, None, :] > q_pos[:, :, None] - window)
    if isinstance(kv_len, torch.Tensor):
        mask = mask & (k_pos[None, None, :]
                       < kv_len.to(torch.int64).reshape(-1, 1, 1))
    elif kv_len is not None:
        mask = mask & (k_pos[None, None, :] < int(kv_len))
    scores = scores.masked_fill(~mask[:, None, None], float("-inf"))
    w = torch.softmax(scores, dim=-1)
    # Fully masked rows give NaN; zero them, as the JAX dense path does.
    w = torch.nan_to_num(w, nan=0.0)
    out = torch.einsum("bhgst,bhtd->bhgsd", w.to(v.dtype), v)
    return out.reshape(b, h, s, d).to(out_dtype)


def attention_paged(q: torch.Tensor, k_pages: torch.Tensor,
                    v_pages: torch.Tensor, table: torch.Tensor, *,
                    buf_len: int, causal: bool = True, q_offset=0,
                    kv_len=None, k_scale_pages=None, v_scale_pages=None,
                    use_kernel: bool = False) -> torch.Tensor:
    """``attention`` over a paged KV pool (``layers.py:215``,
    ``gqa_attention_paged``): k/v pools (P, Hkv, page, D), the int8
    scales' pools (P, Hkv, page, 1), ``table`` (B, n_lp) (0 = unmapped).
    The table is resolved into a contiguous (B, Hkv, buf_len, D) view
    (``kernels/paged.py``) and ``attention`` runs on it unchanged, the
    kernel routes included: unmapped pages read zeros beyond ``kv_len``,
    masked like any dead position."""
    from repro_torch.kernels.paged import gather_kv_pages
    k = gather_kv_pages(k_pages, table, buf_len)
    v = gather_kv_pages(v_pages, table, buf_len)
    ks = vs = None
    if k_scale_pages is not None:
        ks = gather_kv_pages(k_scale_pages, table, buf_len)
        vs = gather_kv_pages(v_scale_pages, table, buf_len)
    return attention(q, k, v, causal=causal, q_offset=q_offset,
                     kv_len=kv_len, k_scale=ks, v_scale=vs,
                     use_kernel=use_kernel)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, q_offset: int = 0,
                      window: int = 0,
                      kv_block: int = 1024) -> torch.Tensor:
    """Online-softmax GQA attention streaming K/V in blocks of
    ``kv_block`` keys (``layers.py:252-320``): q (B, H, S, D), k/v
    (B, Hkv, T, D) -> (B, H, S, D), memory O(S * kv_block) instead of
    O(S * T).  A ragged last block is zero-padded and its pad keys
    masked; query i sits at position ``q_offset + i``.  Rows with no key
    yet (every score -inf) are guarded, and a row masked throughout
    comes out zero, as ``attention``'s does.  ``window`` keeps the keys
    above position ``q_pos - window`` (``layers.py:296-297``).  Plain
    PyTorch, on the card too: JAX runs it outside any Pallas kernel."""
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    g = h // hkv
    pad = -t % kv_block
    if pad:
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
    qr = q.reshape(b, hkv, g, s, d)
    scale = np.float32(1.0) / np.sqrt(np.float32(d))
    q_pos = q_offset + torch.arange(s, device=q.device)
    m = torch.full((b, hkv, g, s), float("-inf"), device=q.device)
    l = torch.zeros((b, hkv, g, s), device=q.device)
    acc = torch.zeros((b, hkv, g, s, d), device=q.device)
    zero = torch.zeros((), device=q.device)
    for start in range(0, t + pad, kv_block):
        kb = k[:, :, start:start + kv_block]
        vb = v[:, :, start:start + kv_block]
        scores = torch.einsum("bhgsd,bhtd->bhgst", qr.float(),
                              kb.float()) * float(scale)
        k_pos = start + torch.arange(kv_block, device=q.device)
        mask = (k_pos < t)[None, :].expand(s, kv_block)
        if causal:
            mask = mask & (k_pos[None, :] <= q_pos[:, None])
        if window:
            mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
        scores = scores.masked_fill(~mask, float("-inf"))
        m_new = torch.maximum(m, scores.amax(dim=-1))
        # Rows masked so far keep m = -inf: shift them by 0 instead.
        m_safe = torch.where(torch.isfinite(m_new), m_new, zero)
        p = torch.exp(scores - m_safe[..., None])
        p = torch.where(torch.isfinite(scores), p, zero)
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_safe), zero)
        l = l * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgst,bhtd->bhgsd", p, vb.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(b, h, s, d).to(q.dtype)


# ---------------------------------------------------------------------------
# MLP and attention projections
# ---------------------------------------------------------------------------


def swiglu_params(gen: torch.Generator, d_model: int, d_ff: int, dtype,
                  device) -> dict:
    return {
        "w_gate": dense_init(gen, d_model, d_ff, dtype, device),
        "w_up": dense_init(gen, d_model, d_ff, dtype, device),
        "w_down": dense_init(gen, d_ff, d_model, dtype, device),
    }


def swiglu(params: dict, x: torch.Tensor) -> torch.Tensor:
    gate = F.silu(dense(x, params["w_gate"]))
    return dense(gate * dense(x, params["w_up"]), params["w_down"])


def gelu_mlp_params(gen: torch.Generator, d_model: int, d_ff: int, dtype,
                    device) -> dict:
    return {
        "w_in": dense_init(gen, d_model, d_ff, dtype, device),
        "b_in": torch.zeros((d_ff,), dtype=dtype, device=device),
        "w_out": dense_init(gen, d_ff, d_model, dtype, device),
        "b_out": torch.zeros((d_model,), dtype=dtype, device=device),
    }


def gelu_mlp(params: dict, x: torch.Tensor) -> torch.Tensor:
    """Whisper's MLP (``layers.py:360-362``).  ``jax.nn.gelu`` defaults
    to the tanh approximation, so this is ``approximate="tanh"``, not
    torch's exact erf."""
    h = F.gelu(x @ params["w_in"] + params["b_in"], approximate="tanh")
    return h @ params["w_out"] + params["b_out"]


def attn_params(gen: torch.Generator, d_model: int, num_heads: int,
                kv_heads: int, head_dim: int, dtype, device) -> dict:
    return {
        "wq": dense_init(gen, d_model, num_heads * head_dim, dtype, device),
        "wk": dense_init(gen, d_model, kv_heads * head_dim, dtype, device),
        "wv": dense_init(gen, d_model, kv_heads * head_dim, dtype, device),
        "wo": dense_init(gen, num_heads * head_dim, d_model, dtype, device),
    }


def project_qkv(params: dict, x: torch.Tensor, num_heads: int, kv_heads: int,
                head_dim: int):
    b, s, _ = x.shape
    q = dense(x, params["wq"]).reshape(b, s, num_heads, head_dim)
    k = dense(x, params["wk"]).reshape(b, s, kv_heads, head_dim)
    v = dense(x, params["wv"]).reshape(b, s, kv_heads, head_dim)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def split_heads(x: torch.Tensor, n: int, head_dim: int) -> torch.Tensor:
    """(B, S, n * head_dim) -> (B, n, S, head_dim)."""
    return x.reshape(x.shape[0], x.shape[1], n, head_dim).transpose(1, 2)


def project_out(params: dict, attn_out: torch.Tensor) -> torch.Tensor:
    b, h, s, d = attn_out.shape
    return dense(attn_out.transpose(1, 2).reshape(b, s, h * d), params["wo"])
