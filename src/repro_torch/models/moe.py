"""Mixture-of-Experts family (mixtral-8x22b: 8 experts top-2 and
sliding-window attention; granite-moe-1b-a400m: 32 experts top-8) -- the
port's counterpart of ``repro/models/moe.py``.

Routing is JAX's capacity-based top-k in groups of up to 256 tokens: a
(token, choice) pair takes the next free position of its expert's buffer
in token-major order over the group, and pairs past the expert's
capacity are dropped.  JAX forms the dispatch and combine as one-hot
einsums; here they are index scatters and gathers of the same values
(each expert slot holds at most one token, so the dispatch is exact; the
combine sums a token's kept choices in another order than JAX's
contraction).  The expert matmuls are batched ``torch.matmul``s, as JAX
leaves them to XLA: no Pallas kernel, no kernel here.  The attention and
its cache are the dense family's (``transformer.py``), sliding window
and ring included; like JAX's, the MoE calls run the plain attention,
no kernel route.

A Python loop over layers replaces ``scan_blocks``.  A layer is the
dense layer's ``attn_norm``/``attn``/``mlp_norm`` plus ``router`` (d,
E) and ``experts`` {``w_gate``, ``w_up`` (E, d, f), ``w_down`` (E, f,
d)}.  The serving calls update the cache in place, as the dense ones do.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig

CAPACITY_FACTOR = 1.25        # forward (training): dropped-token routing
SERVING_CAPACITY_FACTOR = 2.0  # prefill / decode_step (``moe.py:23-24``)
ROUTING_GROUP = 256           # tokens per routing group

init_cache = T.init_cache
cache_len = T.cache_len


def init_params(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    """Random weights drawn from ``gen`` in JAX's distributions
    (``moe.py:30-55``): the dense layer's, a float32 router and E SwiGLU
    experts stacked on a leading axis."""
    dt = cfg.torch_dtype
    hd = cfg.resolved_head_dim
    embed = L.embed_init(gen, cfg.padded_vocab, cfg.d_model, dt, device)
    layers = []
    for _ in range(cfg.num_layers):
        experts = [L.swiglu_params(gen, cfg.d_model, cfg.d_ff, dt, device)
                   for _ in range(cfg.num_experts)]
        layers.append({
            "attn_norm": L.rmsnorm_params(cfg.d_model, dt, device),
            "attn": L.attn_params(gen, cfg.d_model, cfg.num_heads,
                                  cfg.kv_heads, hd, dt, device),
            "mlp_norm": L.rmsnorm_params(cfg.d_model, dt, device),
            "router": L.dense_init(gen, cfg.d_model, cfg.num_experts,
                                   torch.float32, device),
            "experts": {w: torch.stack([e[w] for e in experts])
                        for w in ("w_gate", "w_up", "w_down")},
        })
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": L.rmsnorm_params(cfg.d_model, dt, device),
        "lm_head": L.dense_init(gen, cfg.d_model, cfg.padded_vocab, dt,
                                device),
    }


def _group_size(num_tokens: int) -> int:
    """The largest divisor of ``num_tokens`` at most ``ROUTING_GROUP``."""
    g = min(num_tokens, ROUTING_GROUP)
    while num_tokens % g:
        g -= 1
    return g


def capacity(cfg: ModelConfig, group: int, cf: float) -> int:
    """Buffer positions of each expert in a group of ``group`` tokens."""
    cap = int(group * cfg.experts_per_token * cf / cfg.num_experts)
    return min(max(cap, cfg.experts_per_token), group)


def top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k`` over the last axis: the k largest values in
    descending order, the lower index first among equal values (a
    stable sort; ``torch.topk`` does not promise the order of ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_mlp(params_l: dict, cfg: ModelConfig, x: torch.Tensor,
            cf: float = CAPACITY_FACTOR):
    """Capacity-based top-k MoE with group-wise routing
    (``moe.py:73``): x (B, S, D) -> (out (B, S, D), the load-balance
    loss E * sum_e f_e p_e).  Rows share routing groups, so a row's
    output depends on the other rows of its group."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.experts_per_token
    t = b * s
    group = _group_size(t)
    g = t // group
    cap = capacity(cfg, group, cf)
    xt = x.reshape(g, group, d)
    logits = torch.matmul(xt.float(), params_l["router"].float())  # (G,t,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k(probs, k)                          # (G,t,k)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    # Position of each (token, choice) in its expert's buffer: the count
    # of earlier pairs of the group (token-major, then choice) that chose
    # the same expert.
    onehot = F.one_hot(gate_idx, e)                                # (G,t,k,E)
    flat = onehot.reshape(g, group * k, e)
    before = (torch.cumsum(flat, dim=1) - flat).reshape(g, group, k, e)
    pos = torch.gather(before, -1, gate_idx[..., None])[..., 0]    # (G,t,k)
    keep = pos < cap
    # Dropped pairs go to a trash position `cap`, cut off after the
    # scatter (no boolean mask: that would be a host sync on the card).
    slot = torch.where(keep, pos, torch.full_like(pos, cap))
    gi = torch.arange(g, device=x.device)[:, None, None].expand_as(slot)
    expert_in = torch.zeros((e, g, cap + 1, d), dtype=x.dtype,
                            device=x.device)
    expert_in.index_put_(
        (gate_idx, gi, slot),
        xt[:, :, None, :].expand(g, group, k, d))
    expert_in = expert_in[:, :, :cap].reshape(e, g * cap, d)
    w = params_l["experts"]
    gate = F.silu(torch.matmul(expert_in, w["w_gate"]))
    up = torch.matmul(expert_in, w["w_up"])
    expert_out = torch.matmul(gate * up, w["w_down"]).reshape(e, g, cap, d)
    picked = expert_out[gate_idx, gi, torch.clamp(pos, max=cap - 1)]
    weight = torch.where(keep, gate_vals, torch.zeros_like(gate_vals))
    out = torch.sum(picked * weight.to(x.dtype)[..., None], dim=2)

    frac_tokens = torch.mean(onehot.sum(dim=2).float(), dim=(0, 1)) / k
    frac_probs = torch.mean(probs, dim=(0, 1))
    aux = e * torch.sum(frac_tokens * frac_probs)
    return out.reshape(b, s, d), aux


def _moe_residual(p, cfg, x, cf):
    m, aux = moe_mlp(p, cfg, L.rmsnorm(p["mlp_norm"], x, cfg.norm_eps), cf)
    return x + m, aux


def _block_train(p, cfg, x, positions, chunked: bool):
    """One layer of the full-sequence pass (``moe.py:125``): (x, the
    layer's load-balance loss)."""
    h, _, _ = T._self_attention(p, cfg, x, positions, chunked)
    return _moe_residual(p, cfg, x + h, CAPACITY_FACTOR)


def forward(params: dict, cfg: ModelConfig, batch: dict, *,
            remat: bool = True, return_aux: bool = False,
            return_hidden: bool = False):
    """Full-sequence causal pass (``moe.py:138``) at the training
    capacity factor: tokens (B, S) -> logits (B, S, Vpad) (the final
    normed hidden state with ``return_hidden``), and with ``return_aux``
    the mean load-balance loss over the layers.  Chunked attention above
    2,048 tokens; the window is the config's; ``remat`` recomputes each
    layer on the backward pass."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = T._full_positions(b, s, tokens.device)
    chunked = s > T.MAX_DENSE_FORWARD
    x = T._embed(params, tokens)
    aux = torch.zeros((), device=x.device)
    for p in params["layers"]:
        x, aux_l = L.remat(_block_train, remat, p, cfg, x, positions,
                           chunked)
        aux = aux + aux_l
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    out = x if return_hidden else x @ params["lm_head"]
    if return_aux:
        return out, aux / cfg.num_layers
    return out


def prefill(params: dict, cfg: ModelConfig, batch: dict, cache: dict):
    """Prefill from position 0 (``moe.py:169``) at the serving capacity
    factor: (last logits (B, Vpad), the cache with ``pos`` = S; a ring
    cache keeps the last T keys at their slots p % T)."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = T._full_positions(b, s, tokens.device)
    x = T._embed(params, tokens)
    for li, p in enumerate(params["layers"]):
        h, k, v = T._self_attention(p, cfg, x, positions,
                                    s > T.MAX_DENSE_FORWARD)
        x, _ = _moe_residual(p, cfg, x + h, SERVING_CAPACITY_FACTOR)
        T._install_prefill(cache["k"][li], k)
        T._install_prefill(cache["v"][li], v)
    x = L.rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
    return (x @ params["lm_head"])[:, 0], {"k": cache["k"], "v": cache["v"],
                                           "pos": s}


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                cache: dict):
    """One token per row at the shared position (``moe.py:222``): the key
    at slot ``pos % T``, the attention over the first ``min(pos + 1, T)``
    slots (the whole ring once it has wrapped), the serving capacity
    factor over the B tokens."""
    pos = int(cache["pos"])
    t = cache["k"].shape[3]
    slot = pos % t
    positions = torch.full((tokens.shape[0], 1, 1), pos,
                           device=tokens.device)
    x = T._embed(params, tokens)
    for li, p in enumerate(params["layers"]):
        q, k, v = T._qkv(p, cfg, x, positions)
        ck, cv = cache["k"][li], cache["v"][li]
        ck[:, :, slot:slot + 1].copy_(k)
        cv[:, :, slot:slot + 1].copy_(v)
        out = L.attention(q, ck, cv, causal=False, kv_len=min(pos + 1, t))
        x, _ = _moe_residual(p, cfg, x + L.project_out(p["attn"], out),
                             SERVING_CAPACITY_FACTOR)
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return (x @ params["lm_head"])[:, 0], {"k": cache["k"], "v": cache["v"],
                                           "pos": pos + 1}
