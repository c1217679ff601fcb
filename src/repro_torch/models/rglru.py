"""RecurrentGemma / Griffin hybrid (arXiv:2402.19427) -- the port's
counterpart of ``repro/models/rglru.py``: residual blocks cycle
(recurrent, recurrent, local attention); a recurrent block is a gated
branch through a short causal conv and the RG-LRU, a local-attention
block is MQA over a window of keys (a ring cache of ``local_window``
slots); each is followed by its own SwiGLU MLP.

RG-LRU (per channel, diagonal):
  r_t = sigmoid(W_a x_t); i_t = sigmoid(W_x x_t)
  log a_t = -c softplus(Lambda) r_t          (c = 8)
  h_t = a_t h_{t-1} + sqrt(1 - a_t^2) (i_t x_t)

Layout (``layout``): ``num_layers`` blocks = ``n_units`` units of
``pattern_rec`` recurrent blocks and one attention block, then the
trailing recurrent blocks ``extra_rec`` (recurrentgemma-2b: 8 units and
2).  Parameters: ``{"embed", "units": [{"rec": [block, ...], "attn":
block}, ...], "extra_rec": [block, ...], "final_norm", "lm_head"}``.  A
cache keeps JAX's stacked layout, ``{"units": {"rec": {"conv" (n_units,
pattern_rec, B, 3, W), "h" (n_units, pattern_rec, B, W) f32}, "attn":
{"k", "v" (n_units, B, Hkv, T, hd)}}, "extra_rec": {"conv", "h"},
"pos"}``, updated in place.

JAX runs no kernel here (``L.attention`` without ``use_kernel``); nor
does the port: the attention is the plain path on the card too, at head
dim 256, and the full-sequence RG-LRU is a log-depth scan in PyTorch.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.mamba2 import causal_conv, softplus

LRU_C = 8.0
CONV_WIDTH = 4


def _lru_width(cfg: ModelConfig) -> int:
    return cfg.lru_width or cfg.d_model


def layout(cfg: ModelConfig) -> tuple[int, int]:
    """(n_units, n_extra_rec) covering ``cfg.num_layers`` blocks."""
    unit = cfg.pattern_rec + 1
    n_units = cfg.num_layers // unit
    return n_units, cfg.num_layers - n_units * unit


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def _rec_block_init(gen, cfg: ModelConfig, device) -> dict:
    dt = cfg.torch_dtype
    w = _lru_width(cfg)
    return {
        "norm": L.rmsnorm_params(cfg.d_model, dt, device),
        "w_x": L.dense_init(gen, cfg.d_model, w, dt, device),
        "w_gate": L.dense_init(gen, cfg.d_model, w, dt, device),
        "conv_w": (torch.randn((CONV_WIDTH, w), generator=gen,
                               dtype=torch.float32, device=device)
                   * 0.1).to(dt),
        "conv_b": torch.zeros((w,), dtype=dt, device=device),
        "lru_wa": L.dense_init(gen, w, w, dt, device),
        "lru_wx": L.dense_init(gen, w, w, dt, device),
        "lru_lambda": torch.full((w,), 1.0, dtype=torch.float32,
                                 device=device),
        "w_out": L.dense_init(gen, w, cfg.d_model, dt, device),
        "mlp_norm": L.rmsnorm_params(cfg.d_model, dt, device),
        "mlp": L.swiglu_params(gen, cfg.d_model, cfg.d_ff, dt, device),
    }


def _attn_block_init(gen, cfg: ModelConfig, device) -> dict:
    dt = cfg.torch_dtype
    return {
        "norm": L.rmsnorm_params(cfg.d_model, dt, device),
        "attn": L.attn_params(gen, cfg.d_model, cfg.num_heads, cfg.kv_heads,
                              cfg.resolved_head_dim, dt, device),
        "mlp_norm": L.rmsnorm_params(cfg.d_model, dt, device),
        "mlp": L.swiglu_params(gen, cfg.d_model, cfg.d_ff, dt, device),
    }


def init_params(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    """Random weights drawn from ``gen`` in JAX's distributions
    (``rglru.py:44-105``): normal / sqrt(fan_in) matmuls, 0.1 normal conv
    taps, Lambda = 1, 0.02 normal embeddings."""
    n_units, extra = layout(cfg)
    dt = cfg.torch_dtype
    embed = L.embed_init(gen, cfg.padded_vocab, cfg.d_model, dt, device)
    units = [{"rec": [_rec_block_init(gen, cfg, device)
                      for _ in range(cfg.pattern_rec)],
              "attn": _attn_block_init(gen, cfg, device)}
             for _ in range(n_units)]
    return {
        "embed": embed,
        "units": units,
        "extra_rec": [_rec_block_init(gen, cfg, device)
                      for _ in range(extra)],
        "final_norm": L.rmsnorm_params(cfg.d_model, dt, device),
        "lm_head": L.dense_init(gen, cfg.d_model, cfg.padded_vocab, dt,
                                device),
    }


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------


def _lru_gates(p: dict, x: torch.Tensor):
    """x: (..., W) branch input -> (log_a, gated input), both float32."""
    r = torch.sigmoid((x @ p["lru_wa"]).float())
    i = torch.sigmoid((x @ p["lru_wx"]).float())
    log_a = -LRU_C * softplus(p["lru_lambda"]) * r
    beta = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-6))
    return log_a, beta * i * x.float()


def rg_lru_scan(p: dict, x: torch.Tensor, h0=None):
    """Full-sequence RG-LRU (``rglru.py:124``): x (B, S, W) -> (y (B, S,
    W) in x's dtype, the last state (B, W) float32).

    An inclusive scan of JAX's combine, (a1, u1) . (a2, u2) = (a1 + a2,
    u1 exp(a2) + u2), in log2(S) doubling steps (Hillis-Steele) in
    float32: the same function as JAX's ``associative_scan``, summed in
    another order."""
    log_a, u = _lru_gates(p, x)
    s = x.shape[1]
    off = 1
    while off < s:
        a_prev, u_prev = log_a[:, :-off], u[:, :-off]
        u = torch.cat([u[:, :off], u_prev * torch.exp(log_a[:, off:])
                       + u[:, off:]], dim=1)
        log_a = torch.cat([log_a[:, :off], a_prev + log_a[:, off:]], dim=1)
        off *= 2
    h = u
    if h0 is not None:
        h = h + torch.exp(log_a) * h0[:, None, :].float()
    return h.to(x.dtype), h[:, -1]


def rg_lru_step(p: dict, x: torch.Tensor, h_prev: torch.Tensor):
    """One step (``rglru.py:140``): x (B, 1, W), h_prev (B, W) float32 ->
    (y (B, 1, W), h (B, W))."""
    log_a, u = _lru_gates(p, x)
    h = torch.exp(log_a[:, 0]) * h_prev + u[:, 0]
    return h.to(x.dtype)[:, None, :], h


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------


def _mlp_residual(p, cfg, x):
    return x + L.swiglu(p["mlp"], L.rmsnorm(p["mlp_norm"], x, cfg.norm_eps))


def _rec_apply(p, cfg, x, cache=None, decode=False):
    """Recurrent block + MLP (``rglru.py:152``).  ``cache`` {"conv" (B,
    3, W), "h" (B, W)} views are written in place.  The full-sequence
    path starts from a zero state, as JAX's does (it ignores the cache's
    ``h``)."""
    xn = L.rmsnorm(p["norm"], x, cfg.norm_eps)
    branch = xn @ p["w_x"]
    gate = F.gelu(xn @ p["w_gate"], approximate="tanh")
    branch, new_conv = causal_conv(
        p["conv_w"], p["conv_b"], branch,
        state=cache["conv"] if decode else None)
    if decode:
        y, h_new = rg_lru_step(p, branch, cache["h"])
    else:
        y, h_new = rg_lru_scan(p, branch)
    x = _mlp_residual(p, cfg, x + (y * gate) @ p["w_out"])
    if cache is not None:
        cache["conv"].copy_(new_conv)
        cache["h"].copy_(h_new)
    return x


def _attn_apply(p, cfg, x, positions=None, cache=None, pos=None):
    """Local-attention block + MLP (``rglru.py:177``): the full sequence
    (windowed causal attention, chunked above 2,048 tokens; with a cache,
    its ring written as the dense prefill writes it), or with ``pos`` one
    decode step into the ring at slot ``pos % T``."""
    hd = cfg.resolved_head_dim
    xn = L.rmsnorm(p["norm"], x, cfg.norm_eps)
    q, k, v = L.project_qkv(p["attn"], xn, cfg.num_heads, cfg.kv_heads, hd)
    if pos is None:
        q = L.apply_rope(q, positions, cfg.rope_theta)
        k = L.apply_rope(k, positions, cfg.rope_theta)
        attend = (L.chunked_attention if x.shape[1] > T.MAX_DENSE_FORWARD
                  else L.attention)
        out = attend(q, k, v, causal=True, window=cfg.local_window)
        if cache is not None:
            T._install_prefill(cache["k"], k)
            T._install_prefill(cache["v"], v)
    else:
        posb = torch.full((x.shape[0], 1, 1), pos, device=x.device)
        q = L.apply_rope(q, posb, cfg.rope_theta)
        k = L.apply_rope(k, posb, cfg.rope_theta)
        t = cache["k"].shape[2]
        slot = pos % t
        cache["k"][:, :, slot:slot + 1].copy_(k)
        cache["v"][:, :, slot:slot + 1].copy_(v)
        out = L.attention(q, cache["k"], cache["v"], causal=False,
                          kv_len=min(pos + 1, t))
    return _mlp_residual(p, cfg, x + L.project_out(p["attn"], out))


def _rec_cache(cache, *idx):
    if cache is None:
        return None
    return {"conv": cache["conv"][idx], "h": cache["h"][idx]}


def _run(params, cfg, x, positions=None, cache=None, pos=None,
         remat: bool = False):
    """Every block in order; ``pos`` given: one decode step.  ``remat``
    (the cacheless full-sequence pass of ``forward``) recomputes each
    block on the backward pass."""
    decode = pos is not None
    units = cache["units"] if cache is not None else None
    for ui, unit in enumerate(params["units"]):
        for ri, p in enumerate(unit["rec"]):
            c = None if units is None else _rec_cache(units["rec"], ui, ri)
            x = L.remat(_rec_apply, remat, p, cfg, x, c, decode)
        c = None if units is None else {kk: units["attn"][kk][ui]
                                        for kk in ("k", "v")}
        x = L.remat(_attn_apply, remat, unit["attn"], cfg, x, positions, c,
                    pos)
    for ei, p in enumerate(params["extra_rec"]):
        c = _rec_cache(cache["extra_rec"], ei) if cache is not None else None
        x = L.remat(_rec_apply, remat, p, cfg, x, c, decode)
    return x


# ---------------------------------------------------------------------------
# Registry calls
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    """A zeroed cache at position 0 (``rglru.py:242``): conv and RG-LRU
    states per recurrent block, a ring of ``min(max_len, local_window)``
    slots per attention block."""
    n_units, extra = layout(cfg)
    w = _lru_width(cfg)
    t = min(max_len, cfg.local_window)
    dt, f32 = cfg.torch_dtype, torch.float32
    z = lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=device)
    rec = cfg.pattern_rec
    return {
        "units": {
            "rec": {"conv": z((n_units, rec, batch, CONV_WIDTH - 1, w), dt),
                    "h": z((n_units, rec, batch, w), f32)},
            "attn": {kk: z((n_units, batch, cfg.kv_heads, t,
                            cfg.resolved_head_dim), dt) for kk in ("k", "v")},
        },
        "extra_rec": {"conv": z((extra, batch, CONV_WIDTH - 1, w), dt),
                      "h": z((extra, batch, w), f32)},
        "pos": 0,
    }


def forward(params: dict, cfg: ModelConfig, batch: dict, *,
            remat: bool = True, return_hidden: bool = False) -> torch.Tensor:
    """Full-sequence pass (``rglru.py:316``): tokens (B, S) -> logits
    (B, S, Vpad), or the final normed hidden state; ``remat`` recomputes
    each block on the backward pass."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = T._embed(params, tokens)
    x = _run(params, cfg, x, T._full_positions(b, s, tokens.device),
             remat=remat)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x if return_hidden else x @ params["lm_head"]


def prefill(params: dict, cfg: ModelConfig, batch: dict, cache: dict):
    """Prefill from position 0 (``rglru.py:345``): (last logits (B,
    Vpad), the cache with every block's state and ``pos`` = S)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = T._embed(params, tokens)
    x = _run(params, cfg, x, T._full_positions(b, s, tokens.device), cache)
    x = L.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    cache["pos"] = s
    return (x @ params["lm_head"])[:, 0], cache


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                cache: dict):
    """One token per row at the shared position (``rglru.py:359``) ->
    (logits (B, Vpad), the cache one position on)."""
    pos = int(cache["pos"])
    x = _run(params, cfg, T._embed(params, tokens), cache=cache, pos=pos)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    cache["pos"] = pos + 1
    return (x @ params["lm_head"])[:, 0], cache
