"""Whisper-style encoder-decoder transformer (arXiv:2212.04356) -- the
port's counterpart of ``repro/models/encdec.py``.

The audio frontend (mel spectrogram and conv feature extractor) is a
stub, as in JAX: ``batch["frames"]`` carries precomputed frame
embeddings (B, S_enc, d_model).  A bidirectional encoder (sinusoidal
positions) feeds a causal decoder (learned positions, clipped at
``max_decoder_len - 1``) with cross-attention; LayerNorm, GELU MLPs,
full MHA, no RoPE.  The LM head is tied to ``embed``.

Parameters: ``{"embed", "pos_dec", "encoder": [layer, ...], "enc_norm",
"decoder": [layer, ...], "dec_norm"}``.  A cache is ``{"k", "v"
(layers, B, H, max_decoder_len, hd), "ck", "cv" (layers, B, H, S_enc,
hd), "pos"}`` (``pos`` a host int): ``prefill`` runs the encoder once,
writes the decoder's self-attention keys in place and REPLACES ``ck``/
``cv`` by the cross keys and values it computed (JAX's prefill returns
them, whatever length ``init_cache`` gave the zeros); ``decode_step``
writes the self-cache slot ``min(pos, T - 1)`` and attends the first
``min(pos + 1, T)`` keys, as JAX does.

JAX runs no kernel here (``L.attention``/``L.chunked_attention`` without
``use_kernel``); nor does the port: above 2,048 frames the encoder and
the full-sequence cross-attention stream through ``chunked_attention``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

# XLA's float32 ``exp`` on the CPU: the Cephes polynomial, evaluated with
# fused multiply-adds after a Cody-Waite reduction by ln 2.  Every
# constant is a float32 value.
_f32 = lambda v: float(np.float32(v))  # noqa: E731
_EXP_LOG2E = _f32(1.44269504088896341)
_EXP_LN2 = (_f32(0.693359375), _f32(-2.12194440e-4))
_EXP_POLY = tuple(_f32(c) for c in (
    1.9875691500e-4, 1.3981999507e-3, 8.3334519073e-3, 4.1665795894e-2,
    1.6666665459e-1, 5.0000001201e-1))
_EXP_CLAMP = _f32(88.3762626647949)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once (the product is exact in
    float64)."""
    return (a.double() * b + c).float()


def _exp_f32(x: torch.Tensor) -> torch.Tensor:
    """``exp`` of a float32 tensor, bit for bit the JAX package's on the
    CPU.  ``sinusoids`` needs the frequencies bit-equal: at position 2,000
    one ulp of a frequency moves the angle by 1e-4."""
    x = torch.clamp(x, -_EXP_CLAMP, _EXP_CLAMP)
    n = torch.floor(x * _EXP_LOG2E + 0.5)
    r = _fma(n, -_EXP_LN2[0], x)
    r = _fma(n, -_EXP_LN2[1], r)
    y = torch.full_like(r, _EXP_POLY[0])
    for c in _EXP_POLY[1:]:
        y = _fma(y, r, c)
    y = _fma(y, r * r, r) + 1.0
    return y * torch.exp2(n)


def sinusoids(length: int, channels: int, device) -> torch.Tensor:
    """Whisper's sinusoidal positions (``encdec.py:33-38``), (length,
    channels) float32, formed as JAX forms them: the timescale step
    ``log(10000) / (channels / 2 - 1)`` in float32."""
    half = channels // 2
    step = np.float32(np.log(np.float32(10000.0))) / np.float32(half - 1)
    inv = _exp_f32(torch.arange(half, dtype=torch.float32, device=device)
                   * -float(step))
    scaled = (torch.arange(length, dtype=torch.float32, device=device)[:, None]
              * inv[None, :])
    return torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=1)


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def _attn(gen, cfg: ModelConfig, device) -> dict:
    return L.attn_params(gen, cfg.d_model, cfg.num_heads, cfg.kv_heads,
                         cfg.resolved_head_dim, cfg.torch_dtype, device)


def _enc_block_init(gen, cfg: ModelConfig, device) -> dict:
    dt = cfg.torch_dtype
    return {
        "attn_norm": L.layernorm_params(cfg.d_model, dt, device),
        "attn": _attn(gen, cfg, device),
        "mlp_norm": L.layernorm_params(cfg.d_model, dt, device),
        "mlp": L.gelu_mlp_params(gen, cfg.d_model, cfg.d_ff, dt, device),
    }


def _dec_block_init(gen, cfg: ModelConfig, device) -> dict:
    dt = cfg.torch_dtype
    return {
        "self_norm": L.layernorm_params(cfg.d_model, dt, device),
        "self_attn": _attn(gen, cfg, device),
        "cross_norm": L.layernorm_params(cfg.d_model, dt, device),
        "cross_attn": _attn(gen, cfg, device),
        "mlp_norm": L.layernorm_params(cfg.d_model, dt, device),
        "mlp": L.gelu_mlp_params(gen, cfg.d_model, cfg.d_ff, dt, device),
    }


def init_params(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    """Random weights drawn from ``gen`` in JAX's distributions
    (``encdec.py:41-84``): normal / sqrt(fan_in) matmuls, 0.02 normal
    token and decoder-position embeddings, unit LayerNorm scales and
    zero biases; no ``lm_head`` (tied to ``embed``)."""
    dt = cfg.torch_dtype
    return {
        "embed": L.embed_init(gen, cfg.padded_vocab, cfg.d_model, dt, device),
        "pos_dec": L.embed_init(gen, cfg.max_decoder_len, cfg.d_model, dt,
                                device),
        "encoder": [_enc_block_init(gen, cfg, device)
                    for _ in range(cfg.encoder_layers)],
        "enc_norm": L.layernorm_params(cfg.d_model, dt, device),
        "decoder": [_dec_block_init(gen, cfg, device)
                    for _ in range(cfg.num_layers)],
        "dec_norm": L.layernorm_params(cfg.d_model, dt, device),
    }


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


def _enc_block(p, cfg: ModelConfig, x, chunked: bool):
    """One encoder layer (``encdec.py:92``): bidirectional attention."""
    xn = L.layernorm(p["attn_norm"], x, cfg.norm_eps)
    q, k, v = L.project_qkv(p["attn"], xn, cfg.num_heads, cfg.kv_heads,
                            cfg.resolved_head_dim)
    attend = L.chunked_attention if chunked else L.attention
    x = x + L.project_out(p["attn"], attend(q, k, v, causal=False))
    return x + L.gelu_mlp(p["mlp"], L.layernorm(p["mlp_norm"], x,
                                                cfg.norm_eps))


def encode(params: dict, cfg: ModelConfig, frames: torch.Tensor, *,
           chunked: Optional[bool] = None) -> torch.Tensor:
    """frames (B, S_enc, d_model) stub embeddings -> encoder states
    (``encdec.py:109``).  ``chunked`` (default: S_enc > 2,048) streams the
    attention through ``chunked_attention``."""
    s = frames.shape[1]
    if chunked is None:
        chunked = s > T.MAX_DENSE_FORWARD
    x = frames + sinusoids(s, cfg.d_model, frames.device).to(
        frames.dtype)[None]
    for p in params["encoder"]:
        x = _enc_block(p, cfg, x, chunked)
    return L.layernorm(params["enc_norm"], x, cfg.norm_eps)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------


def _dec_embed(params: dict, cfg: ModelConfig, tokens, positions):
    """Token embeddings plus the learned positions, clipped to
    ``max_decoder_len - 1`` (``encdec.py:123-124``)."""
    pos = torch.clamp(positions, 0, cfg.max_decoder_len - 1)
    return T._embed(params, tokens) + params["pos_dec"][pos][None]


def _cross_query(p, cfg: ModelConfig, x):
    xn = L.layernorm(p["cross_norm"], x, cfg.norm_eps)
    return L.split_heads(xn @ p["cross_attn"]["wq"], cfg.num_heads,
                  cfg.resolved_head_dim)


def _mlp_residual(p, cfg: ModelConfig, x):
    return x + L.gelu_mlp(p["mlp"], L.layernorm(p["mlp_norm"], x,
                                                cfg.norm_eps))


def _dec_block_full(p, cfg: ModelConfig, x, enc, chunked: bool,
                    cache_l: Optional[dict] = None):
    """One decoder layer over the whole sequence (``encdec.py:127``):
    causal self-attention, cross-attention to ``enc``, the MLP.  With
    ``cache_l`` (the layer's {"k", "v"} views) the first ``min(S, T)``
    self keys and values are written at time 0 in place, and the cross
    keys and values are put in ``cache_l["ck"]``/``["cv"]``."""
    hd = cfg.resolved_head_dim
    xn = L.layernorm(p["self_norm"], x, cfg.norm_eps)
    q, k, v = L.project_qkv(p["self_attn"], xn, cfg.num_heads, cfg.kv_heads,
                            hd)
    x = x + L.project_out(p["self_attn"], L.attention(q, k, v, causal=True))
    qc = _cross_query(p, cfg, x)
    kc = L.split_heads(enc @ p["cross_attn"]["wk"], cfg.kv_heads, hd)
    vc = L.split_heads(enc @ p["cross_attn"]["wv"], cfg.kv_heads, hd)
    attend = L.chunked_attention if chunked else L.attention
    x = x + L.project_out(p["cross_attn"], attend(qc, kc, vc, causal=False))
    if cache_l is not None:
        t = cache_l["k"].shape[2]
        n = min(k.shape[2], t)
        cache_l["k"][:, :, :n].copy_(k[:, :, :n])
        cache_l["v"][:, :, :n].copy_(v[:, :, :n])
        cache_l["ck"], cache_l["cv"] = kc, vc
    return _mlp_residual(p, cfg, x)


def _decoder_input(params, cfg: ModelConfig, batch: dict):
    enc = encode(params, cfg, batch["frames"])
    tokens = batch["tokens"]
    x = _dec_embed(params, cfg, tokens,
                   torch.arange(tokens.shape[1], device=tokens.device))
    return x, enc, enc.shape[1] > T.MAX_DENSE_FORWARD


def forward(params: dict, cfg: ModelConfig, batch: dict, *,
            remat: bool = True, return_hidden: bool = False) -> torch.Tensor:
    """frames (B, S_enc, d) + tokens (B, S) -> logits (B, S, Vpad) over
    the tied head, or with ``return_hidden`` the final normed decoder
    state (``encdec.py:169``).  ``remat`` recomputes each decoder layer
    on the backward pass; the encoder's are kept, as JAX's
    ``encode`` scans without a checkpoint."""
    x, enc, chunked = _decoder_input(params, cfg, batch)
    for p in params["decoder"]:
        x = L.remat(_dec_block_full, remat, p, cfg, x, enc, chunked)
    x = L.layernorm(params["dec_norm"], x, cfg.norm_eps)
    return x if return_hidden else x @ params["embed"].T


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    """A zeroed cache at position 0 (``encdec.py:191``).  ``max_len`` is
    the ENCODER length (``ck``/``cv``); the decoder self-cache holds
    ``max_decoder_len`` slots."""
    hd, dt = cfg.resolved_head_dim, cfg.torch_dtype
    z = lambda t: torch.zeros((cfg.num_layers, batch, cfg.kv_heads, t, hd),
                              dtype=dt, device=device)
    return {"k": z(cfg.max_decoder_len), "v": z(cfg.max_decoder_len),
            "ck": z(max_len), "cv": z(max_len), "pos": 0}


def prefill(params: dict, cfg: ModelConfig, batch: dict, cache: dict):
    """Encode ``batch["frames"]`` and prefill the decoder over
    ``batch["tokens"]`` from position 0 (``encdec.py:206``) -> (last
    logits (B, Vpad), the cache with the self keys, the cross keys and
    values it computed and ``pos`` = S)."""
    x, enc, chunked = _decoder_input(params, cfg, batch)
    cks, cvs = [], []
    for li, p in enumerate(params["decoder"]):
        c = {"k": cache["k"][li], "v": cache["v"][li]}
        x = _dec_block_full(p, cfg, x, enc, chunked, c)
        cks.append(c["ck"])
        cvs.append(c["cv"])
    cache["ck"], cache["cv"] = torch.stack(cks), torch.stack(cvs)
    cache["pos"] = batch["tokens"].shape[1]
    x = L.layernorm(params["dec_norm"], x[:, -1:], cfg.norm_eps)
    return (x @ params["embed"].T)[:, 0], cache


def _dec_block_step(p, cfg: ModelConfig, x, cache_l: dict, slot: int,
                    kv_len: int):
    """One decoder layer for one token (``encdec.py:223``): the self key
    at ``slot``, attention over the first ``kv_len`` self keys, then over
    every cached cross key."""
    hd = cfg.resolved_head_dim
    xn = L.layernorm(p["self_norm"], x, cfg.norm_eps)
    q, k, v = L.project_qkv(p["self_attn"], xn, cfg.num_heads, cfg.kv_heads,
                            hd)
    cache_l["k"][:, :, slot:slot + 1].copy_(k)
    cache_l["v"][:, :, slot:slot + 1].copy_(v)
    out = L.attention(q, cache_l["k"], cache_l["v"], causal=False,
                      kv_len=kv_len)
    x = x + L.project_out(p["self_attn"], out)
    outc = L.attention(_cross_query(p, cfg, x), cache_l["ck"],
                       cache_l["cv"], causal=False)
    x = x + L.project_out(p["cross_attn"], outc)
    return _mlp_residual(p, cfg, x)


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                cache: dict):
    """One token per row at the shared position (``encdec.py:254``):
    tokens (B, 1) -> (logits (B, Vpad), the cache one position on).
    Past the self-cache's end the key overwrites its last slot and the
    position embedding stays at ``max_decoder_len - 1``, as in JAX."""
    pos = int(cache["pos"])
    t = cache["k"].shape[3]
    x = _dec_embed(params, cfg, tokens,
                   torch.full((1,), pos, device=tokens.device))
    for li, p in enumerate(params["decoder"]):
        x = _dec_block_step(p, cfg, x,
                            {kk: cache[kk][li] for kk in ("k", "v", "ck",
                                                          "cv")},
                            min(pos, t - 1), min(pos + 1, t))
    x = L.layernorm(params["dec_norm"], x, cfg.norm_eps)
    cache["pos"] = pos + 1
    return (x @ params["embed"].T)[:, 0], cache
