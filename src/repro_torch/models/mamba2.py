"""Mamba-2 (SSD -- state-space duality, arXiv:2405.21060), attention-free
-- the port's counterpart of ``repro/models/mamba2.py``.

The full-sequence path (``forward``, ``prefill``) runs the chunked SSD
(``kernels/ssd_chunk/ops.py::ssd_chunked``): the intra-chunk quadratic
part in the ``ssd_chunk`` kernel on the card, the inter-chunk state
recurrence in PyTorch.  Decode is the O(1) per-token recurrence
(``ssd_step``), which launches no kernel.

Per block (n_groups = 1):
  in_proj: d -> [z (d_in), x (d_in), B (d_state), C (d_state), dt (H)]
  depthwise causal conv (width 4) over [x, B, C]
  SSD: h_t = exp(A dt_t) h_{t-1} + dt_t * B_t (x) x_t;  y_t = C_t . h_t + D x_t
  out = out_proj(rmsnorm(y * silu(z)))

A Python loop over layers replaces ``scan_blocks``.  Parameters are a
dict ``{"embed", "layers": [per-layer dict, ...], "final_norm",
"lm_head"}`` with matmul weights in the JAX ``(in, out)`` layout.  A
cache is ``{"conv" (layers, B, W-1, conv_dim), "ssm" (layers, B, H, P,
N) f32, "pos"}``; the serving calls return a new cache, as JAX does.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.ssd_chunk.ops import ssd_chunked
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def _dims(cfg: ModelConfig):
    d_in = cfg.ssm_d_inner
    h = cfg.ssm_num_heads
    ds = cfg.ssm_state
    return d_in, h, ds, d_in + 2 * ds


# ---------------------------------------------------------------------------
# Params
# ---------------------------------------------------------------------------


def _block_init(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    d_in, h, ds, conv_dim = _dims(cfg)
    dt = cfg.torch_dtype
    proj_out = 2 * d_in + 2 * ds + h
    in_proj = L.dense_init(gen, cfg.d_model, proj_out, dt, device)
    conv_w = (torch.randn((cfg.ssm_conv_width, conv_dim), generator=gen,
                          dtype=torch.float32, device=device) * 0.1).to(dt)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "norm": L.rmsnorm_params(cfg.d_model, dt, device),
        "in_proj": in_proj,
        "conv_w": conv_w,
        "conv_b": torch.zeros((conv_dim,), dtype=dt, device=device),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)),
        "dt_bias": torch.zeros((h,), **f32),
        "d_skip": torch.ones((h,), **f32),
        "y_norm": L.rmsnorm_params(d_in, dt, device),
        "out_proj": L.dense_init(gen, d_in, cfg.d_model, dt, device),
    }


def init_params(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    """Random weights drawn from ``gen`` (a generator on ``device``), in
    the JAX init's distributions (``mamba2.py:39-67``): normal /
    sqrt(fan_in) projections, 0.02 normal embeddings, 0.1 normal conv
    taps, ``a_log = log(linspace(1, 16, H))``, zero dt bias, unit skip."""
    dt = cfg.torch_dtype
    embed = L.embed_init(gen, cfg.padded_vocab, cfg.d_model, dt, device)
    layers = [_block_init(gen, cfg, device) for _ in range(cfg.num_layers)]
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": L.rmsnorm_params(cfg.d_model, dt, device),
        "lm_head": L.dense_init(gen, cfg.d_model, cfg.padded_vocab, dt,
                                device),
    }


# ---------------------------------------------------------------------------
# Depthwise causal conv1d and the single-token recurrence
# ---------------------------------------------------------------------------


def causal_conv(w: torch.Tensor, b: torch.Tensor, x: torch.Tensor,
                state: torch.Tensor | None = None):
    """x: (B, S, C); w: (W, C) depthwise (``mamba2.py:75``).  Returns
    (silu(conv + b), new_state), the state being the last W-1 inputs."""
    width = w.shape[0]
    if state is None:
        x_pad = F.pad(x, (0, 0, width - 1, 0))
    else:
        x_pad = torch.cat([state.to(x.dtype), x], dim=1)
    s = x.shape[1]
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(width):
        y = y + x_pad[:, i:i + s].float() * w[i].float()
    y = F.silu(y + b.float()).to(x.dtype)
    return y, x_pad[:, x_pad.shape[1] - (width - 1):]


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` = ``logaddexp(x, 0)``: max(x, 0) +
    log1p(exp(-|x|)), with no large-input threshold."""
    return torch.clamp(x, min=0) + torch.log1p(torch.exp(-torch.abs(x)))


def ssd_step(x, dt, a, b_in, c_in, h_prev):
    """Single-token recurrence (``mamba2.py:178``).  x: (B, H, P); dt:
    (B, H); b/c: (B, N); h_prev: (B, H, P, N) -> (y (B, H, P), h)."""
    decay = torch.exp(dt * a[None, :])
    dx = (x * dt[..., None]).float()
    h = (h_prev * decay[:, :, None, None]
         + torch.einsum("bhp,bn->bhpn", dx, b_in.float()))
    y = torch.einsum("bhpn,bn->bhp", h, c_in.float())
    return y.to(x.dtype), h


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------


def _split_proj(cfg: ModelConfig, proj: torch.Tensor):
    d_in, h, ds, _ = _dims(cfg)
    return torch.split(proj, [d_in, d_in, ds, ds, h], dim=-1)


def _in(p, cfg: ModelConfig, x, conv_state=None):
    """The block up to the SSD: norm, in_proj, causal conv, dt and a."""
    d_in, _, ds, _ = _dims(cfg)
    xn = L.rmsnorm(p["norm"], x, cfg.norm_eps)
    z, xx, b_in, c_in, dt = _split_proj(cfg, xn @ p["in_proj"])
    conv_out, conv_state = causal_conv(
        p["conv_w"], p["conv_b"], torch.cat([xx, b_in, c_in], dim=-1),
        state=conv_state)
    xx, b_in, c_in = torch.split(conv_out, [d_in, ds, ds], dim=-1)
    a = -torch.exp(p["a_log"])
    return z, xx, b_in, c_in, dt, a, conv_state


def _out(p, cfg: ModelConfig, res, y, z):
    y = L.rmsnorm(p["y_norm"], y * F.silu(z), cfg.norm_eps)
    return res + y @ p["out_proj"]


def _block_apply(p, x, cfg: ModelConfig):
    """Full-sequence path (``mamba2.py:201``): returns (x, conv_state,
    h_final)."""
    d_in, h, _, _ = _dims(cfg)
    bsz, s, _ = x.shape
    z, xx, b_in, c_in, dt, a, conv_state = _in(p, cfg, x)
    xh = xx.reshape(bsz, s, h, d_in // h)
    dt = softplus(dt.float() + p["dt_bias"][None, None, :])
    y, h_final = ssd_chunked(xh, dt, a, b_in, c_in, cfg.ssm_chunk)
    y = y + xh.float().to(y.dtype) * p["d_skip"].to(y.dtype)[None, None, :,
                                                             None]
    return _out(p, cfg, x, y.reshape(bsz, s, d_in), z), conv_state, h_final


def _logits(params, cfg, x):
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return x @ params["lm_head"]


def _block_train(p, x, cfg: ModelConfig):
    return _block_apply(p, x, cfg)[0]


def forward(params: dict, cfg: ModelConfig, batch: dict, *,
            remat: bool = True, return_hidden: bool = False) -> torch.Tensor:
    """tokens (B, S) -> logits (B, S, Vpad), or with ``return_hidden``
    the final normed hidden state (``mamba2.py:232``); one ``ssd_chunk``
    launch per layer on the card, and one more per layer on the backward
    pass under ``remat`` (the layer's recomputation)."""
    x = params["embed"][batch["tokens"].to(torch.int64)]
    for p in params["layers"]:
        x = L.remat(_block_train, remat, p, x, cfg)
    if return_hidden:
        return L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, cfg, x)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    """A zeroed cache (``mamba2.py:251``); ``max_len`` is unused (the
    state is O(1) in the sequence)."""
    d_in, h, ds, conv_dim = _dims(cfg)
    return {
        "conv": torch.zeros((cfg.num_layers, batch, cfg.ssm_conv_width - 1,
                             conv_dim), dtype=cfg.torch_dtype, device=device),
        "ssm": torch.zeros((cfg.num_layers, batch, h, d_in // h, ds),
                           dtype=torch.float32, device=device),
        "pos": 0,
    }


def prefill(params: dict, cfg: ModelConfig, batch: dict, cache: dict):
    """(``mamba2.py:269``) tokens (B, S) -> (last logits (B, Vpad), cache
    holding each layer's conv tail and final SSD state).  The SSD starts
    from a zero state, as JAX's does, whatever ``cache`` holds."""
    tokens = batch["tokens"]
    x = params["embed"][tokens.to(torch.int64)]
    convs, ssms = [], []
    for p in params["layers"]:
        x, conv_state, h_final = _block_apply(p, x, cfg)
        convs.append(conv_state.to(cache["conv"].dtype))
        ssms.append(h_final.to(cache["ssm"].dtype))
    logits = _logits(params, cfg, x[:, -1:])[:, 0]
    return logits, {"conv": torch.stack(convs), "ssm": torch.stack(ssms),
                    "pos": int(tokens.shape[1])}


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                cache: dict):
    """(``mamba2.py:310``) tokens (B, 1) -> (logits (B, Vpad), cache)."""
    d_in, h, _, _ = _dims(cfg)
    x = params["embed"][tokens.to(torch.int64)]
    bsz = x.shape[0]
    convs, ssms = [], []
    for li, p in enumerate(params["layers"]):
        z, xx, b_in, c_in, dt, a, conv_state = _in(
            p, cfg, x, conv_state=cache["conv"][li])
        xh = xx[:, 0].reshape(bsz, h, d_in // h)
        dt = softplus(dt[:, 0].float() + p["dt_bias"][None, :])
        y, h_new = ssd_step(xh, dt, a, b_in[:, 0], c_in[:, 0],
                            cache["ssm"][li])
        y = y + xh * p["d_skip"].to(xh.dtype)[None, :, None]
        x = _out(p, cfg, x, y.reshape(bsz, 1, d_in), z)
        convs.append(conv_state.to(cache["conv"].dtype))
        ssms.append(h_new)
    logits = _logits(params, cfg, x)[:, 0]
    return logits, {"conv": torch.stack(convs), "ssm": torch.stack(ssms),
                    "pos": cache["pos"] + 1}

