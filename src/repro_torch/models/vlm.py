"""Llama-3.2-Vision-style VLM -- the port's counterpart of
``repro/models/vlm.py``: a llama-family text decoder (the dense family's
blocks, ``transformer.py``) with a gated cross-attention layer closing
every ``cross_attn_period`` layers (llama-3.2-vision-11b: 40 layers, 8
of them cross-attention).

The vision encoder and projector are a stub, as in JAX:
``batch["images"]`` carries precomputed patch embeddings (B,
num_image_tokens, d_model).  The cross-attention keys and values over
the image tokens are computed once at prefill and read at every decode
step.  A cross block's residuals are scaled by ``tanh`` of its float32
gates ``gate_attn`` and ``gate_mlp`` (0 at init, so a fresh block adds
nothing), cast to the activation dtype.

Layout (``layout``): ``num_layers // period`` units of ``period - 1``
self-attention blocks and one cross block.  Parameters: ``{"embed",
"units": [{"self": [block, ...], "cross": block}, ...], "final_norm",
"lm_head"}``.  A cache is ``{"k", "v" (n_units, period - 1, B, Hkv, T,
hd), "ck", "cv" (n_units, B, Hkv, num_image_tokens, hd), "pos"}``:
``prefill`` writes the self keys in place and REPLACES ``ck``/``cv`` by
the image keys and values it computed, as JAX's prefill returns them.

JAX runs no kernel here (its calls pass no ``use_kernel``); nor does the
port: every attention is the plain path, chunked above 2,048 tokens in
the self-attention layers' full-sequence passes.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def layout(cfg: ModelConfig) -> tuple[int, int]:
    """(n_units, self-attention blocks per unit) (``vlm.py:27``)."""
    period = cfg.cross_attn_period
    assert cfg.num_layers % period == 0, "vlm: num_layers % period != 0"
    return cfg.num_layers // period, period - 1


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def _cross_block_init(gen, cfg: ModelConfig, device) -> dict:
    dt = cfg.torch_dtype
    return {
        "norm": L.rmsnorm_params(cfg.d_model, dt, device),
        "attn": L.attn_params(gen, cfg.d_model, cfg.num_heads, cfg.kv_heads,
                              cfg.resolved_head_dim, dt, device),
        "gate_attn": torch.zeros((), dtype=torch.float32, device=device),
        "gate_mlp": torch.zeros((), dtype=torch.float32, device=device),
        "mlp_norm": L.rmsnorm_params(cfg.d_model, dt, device),
        "mlp": L.swiglu_params(gen, cfg.d_model, cfg.d_ff, dt, device),
    }


def init_params(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    """Random weights drawn from ``gen`` in JAX's distributions
    (``vlm.py:33-64``); the gates start at 0."""
    n_units, n_self = layout(cfg)
    dt = cfg.torch_dtype
    embed = L.embed_init(gen, cfg.padded_vocab, cfg.d_model, dt, device)
    units = [{"self": [T._block_init(gen, cfg, device)
                       for _ in range(n_self)],
              "cross": _cross_block_init(gen, cfg, device)}
             for _ in range(n_units)]
    return {
        "embed": embed,
        "units": units,
        "final_norm": L.rmsnorm_params(cfg.d_model, dt, device),
        "lm_head": L.dense_init(gen, cfg.d_model, cfg.padded_vocab, dt,
                                device),
    }


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _cross_apply(p, cfg: ModelConfig, x, images=None, kv=None):
    """The gated cross-attention block (``vlm.py:67``) over ``images``
    (its keys and values computed here) or the cached ``kv`` = (k, v):
    (x, k, v)."""
    hd = cfg.resolved_head_dim
    xn = L.rmsnorm(p["norm"], x, cfg.norm_eps)
    q = L.split_heads(xn @ p["attn"]["wq"], cfg.num_heads, hd)
    if kv is None:
        k = L.split_heads(images @ p["attn"]["wk"], cfg.kv_heads, hd)
        v = L.split_heads(images @ p["attn"]["wv"], cfg.kv_heads, hd)
    else:
        k, v = kv
    out = L.attention(q, k, v, causal=False)
    g_attn = torch.tanh(p["gate_attn"]).to(x.dtype)
    g_mlp = torch.tanh(p["gate_mlp"]).to(x.dtype)
    x = x + g_attn * L.project_out(p["attn"], out)
    x = x + g_mlp * L.swiglu(p["mlp"], L.rmsnorm(p["mlp_norm"], x,
                                                 cfg.norm_eps))
    return x, k, v


def _unit_train(p_u, cfg: ModelConfig, x, positions, images, chunked: bool):
    """One unit of the full-sequence pass (``vlm.py:90``)."""
    for p in p_u["self"]:
        x = T._block_train(p, cfg, x, positions, chunked)
    return _cross_apply(p_u["cross"], cfg, x, images=images)[0]


def forward(params: dict, cfg: ModelConfig, batch: dict, *,
            remat: bool = True, return_hidden: bool = False) -> torch.Tensor:
    """tokens (B, S) + images (B, N_img, d) -> logits (B, S, Vpad), or
    with ``return_hidden`` the final normed hidden state
    (``vlm.py:103``); ``remat`` recomputes each unit on the backward
    pass, as JAX's ``scan_blocks`` checkpoints a unit."""
    tokens, images = batch["tokens"], batch["images"]
    b, s = tokens.shape
    positions = T._full_positions(b, s, tokens.device)
    x = T._embed(params, tokens)
    for p_u in params["units"]:
        x = L.remat(_unit_train, remat, p_u, cfg, x, positions, images,
                    s > T.MAX_DENSE_FORWARD)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x if return_hidden else x @ params["lm_head"]


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    """A zeroed cache at position 0 (``vlm.py:118``): self keys and
    values for each (unit, self block), ``T.cache_len`` slots; image keys
    and values at ``num_image_tokens``."""
    n_units, n_self = layout(cfg)
    hd, dt = cfg.resolved_head_dim, cfg.torch_dtype
    t = T.cache_len(cfg, max_len)
    z = lambda *shape: torch.zeros(shape, dtype=dt, device=device)
    return {"k": z(n_units, n_self, batch, cfg.kv_heads, t, hd),
            "v": z(n_units, n_self, batch, cfg.kv_heads, t, hd),
            "ck": z(n_units, batch, cfg.kv_heads, cfg.num_image_tokens, hd),
            "cv": z(n_units, batch, cfg.kv_heads, cfg.num_image_tokens, hd),
            "pos": 0}


def _self_cache(cache: dict, ui: int, si: int) -> dict:
    return {"k": cache["k"][ui, si], "v": cache["v"][ui, si]}


def prefill(params: dict, cfg: ModelConfig, batch: dict, cache: dict):
    """Prefill from position 0 (``vlm.py:151``) -> (last logits (B,
    Vpad), the cache with the self keys, the image keys and values and
    ``pos`` = S)."""
    tokens, images = batch["tokens"], batch["images"]
    b, s = tokens.shape
    positions = T._full_positions(b, s, tokens.device)
    x = T._embed(params, tokens)
    cks, cvs = [], []
    for ui, p_u in enumerate(params["units"]):
        for si, p in enumerate(p_u["self"]):
            x = T._block_prefill(p, cfg, x, positions,
                                 _self_cache(cache, ui, si),
                                 s > T.MAX_DENSE_FORWARD)
        x, k, v = _cross_apply(p_u["cross"], cfg, x, images=images)
        cks.append(k)
        cvs.append(v)
    cache["ck"], cache["cv"] = torch.stack(cks), torch.stack(cvs)
    cache["pos"] = s
    x = L.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return (x @ params["lm_head"])[:, 0], cache


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                cache: dict):
    """One token per row at the shared position (``vlm.py:185``): the
    self blocks through ``transformer._block_decode``, the cross blocks
    over the cached image keys and values -> (logits (B, Vpad), the cache
    one position on)."""
    pos = int(cache["pos"])
    x = T._embed(params, tokens)
    for ui, p_u in enumerate(params["units"]):
        for si, p in enumerate(p_u["self"]):
            x = T._block_decode(p, cfg, x, pos, _self_cache(cache, ui, si))
        x, _, _ = _cross_apply(p_u["cross"], cfg, x,
                               kv=(cache["ck"][ui], cache["cv"][ui]))
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    cache["pos"] = pos + 1
    return (x @ params["lm_head"])[:, 0], cache
