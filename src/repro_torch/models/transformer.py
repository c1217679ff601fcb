"""Dense llama-family decoder (GQA + RoPE + SwiGLU + RMSNorm) -- the
port's counterpart of ``repro/models/transformer.py``: ``init_params``,
the full-sequence ``forward`` (chunked attention above 2,048 tokens),
the dense serving calls of the registry (``init_cache``, ``prefill``,
``decode_step``, ``verify_step``: one cache position shared by every
row, the host-driven kv round's per-request admission; a
sliding-window config keeps a ring of ``window`` slots, written at
``pos % T`` by ``prefill`` and ``decode_step``) and the slot
calls of the cache arenas (``prefill_slots``, ``decode_step_slots``,
``verify_step_slots``) and their paged twins (``*_slots_paged``: the
same layer code on each layer's view gathered through a page table,
``models/paged.py``).

A Python loop over layers replaces ``scan_blocks``.  Parameters are a
dict ``{"embed", "layers": [per-layer dict, ...], "final_norm",
"lm_head"}``; a KV cache is ``{"k", "v"}`` of shape
``(layers, rows, kv_heads, T, head_dim)``, plus the shared position
``"pos"`` (a host int) for the dense calls.

The serving calls UPDATE THE CACHE IN PLACE and return it: the port's
stand-in for the JAX package's donated, functionally updated arenas.
Two JAX semantics are copied exactly because the serving path relies on
them:

* ``jax.lax.dynamic_update_slice`` clamps its start so the update fits
  (``transformer.py:222``): a row's write of m positions starting at p
  lands at ``min(p, T - m)``;
* ``prefill_slots``' masked write drops rows outside the admission wave
  and chunk tails past T (``transformer.py:236-241``): those arena rows
  stay bit-untouched.

An int8 arena (``CachePool(quant=True)``) adds f32 scale leaves
``k_s``/``v_s`` of shape ``(layers, rows, kv_heads, T, 1)``: the slots
calls quantize the fresh keys and values per KV vector on write
(``_maybe_quantize_kv``, ``transformer.py:206-216``), write the scales
through the same index plan as the int8 leaves, and pass them to the
attention, which dequantizes as it reads.  The dense calls keep float
caches, as JAX's do (``CachePool.write_prefill`` quantizes on install).
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from repro_torch.device import to_device
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def init_params(gen: torch.Generator, cfg: ModelConfig, device) -> dict:
    """Random weights drawn from ``gen`` (a generator on ``device``),
    in the JAX init's distributions (normal / sqrt(fan_in); embeddings
    0.02 normal; unit norm scales)."""
    dt = cfg.torch_dtype
    hd = cfg.resolved_head_dim
    layers = []
    embed = L.embed_init(gen, cfg.padded_vocab, cfg.d_model, dt, device)
    for _ in range(cfg.num_layers):
        layers.append({
            "attn_norm": L.rmsnorm_params(cfg.d_model, dt, device),
            "attn": L.attn_params(gen, cfg.d_model, cfg.num_heads,
                                  cfg.kv_heads, hd, dt, device),
            "mlp_norm": L.rmsnorm_params(cfg.d_model, dt, device),
            "mlp": L.swiglu_params(gen, cfg.d_model, cfg.d_ff, dt, device),
        })
    return {
        "embed": embed,
        "layers": layers,
        "final_norm": L.rmsnorm_params(cfg.d_model, dt, device),
        "lm_head": L.dense_init(gen, cfg.d_model, cfg.padded_vocab, dt,
                                device),
    }


def cache_len(cfg: ModelConfig, max_len: int) -> int:
    """Time slots of a cache for ``max_len`` tokens (``transformer.py:
    113``): all of them at full attention, at most the window for a
    sliding-window config, whose cache is a ring (position p at slot
    p % T)."""
    if cfg.sliding_window:
        return min(max_len, cfg.sliding_window)
    return max_len


def _non_ring(cfg: ModelConfig, call: str) -> None:
    """The slot and verify calls write T-long windows at a position: a
    ring cache has no such window (``transformer.py:303,413,467``)."""
    if cfg.sliding_window:
        raise ValueError(f"{call}: non-ring caches only")


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device) -> dict:
    """A zeroed KV cache at position 0 (``transformer.py:117``), sized
    by ``cache_len``."""
    shape = (cfg.num_layers, batch, cfg.kv_heads, cache_len(cfg, max_len),
             cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.torch_dtype, device=device),
            "pos": 0}


def _rowwise_cache_write(cache_k, cache_v, k, v, starts) -> None:
    """In place: row b's (H, m, hd) keys/values land at time offset
    ``clamp(starts[b], 0, T - m)`` -- ``dynamic_update_slice``'s clamp.
    cache_k/v: (B, H, T, hd) views; k/v: (B, H, m, hd); starts: (B,)."""
    b, _, t, _ = cache_k.shape
    m = k.shape[2]
    start = torch.clamp(starts.to(torch.int64), 0, t - m)
    ti = start[:, None] + torch.arange(m, device=k.device)       # (B, m)
    bi = torch.arange(b, device=k.device)[:, None].expand(b, m)
    cache_k.transpose(1, 2).index_put_((bi, ti), k.transpose(1, 2))
    cache_v.transpose(1, 2).index_put_((bi, ti), v.transpose(1, 2))


def _maybe_quantize_kv(cache: dict, k: torch.Tensor, v: torch.Tensor):
    """Quantize-on-write for int8 arenas: with scale leaves in ``cache``
    the fresh k/v become int8 plus per-vector scales; otherwise they pass
    through and the scales are None."""
    if "k_s" not in cache:
        return k, v, None, None
    from repro_torch.serving.quant import quantize_kv
    kq, ks = quantize_kv(k)
    vq, vs = quantize_kv(v)
    return kq, vq, ks, vs


def _masked_write_index(pos: np.ndarray, write: np.ndarray, m: int, t: int,
                        device):
    """Host-side scatter plan of ``prefill_slots``' masked write: the
    (row, chunk column, time) triples that land inside the arena.  Rows
    with ``write`` False and columns at or past T are dropped."""
    rows, cols = np.nonzero(write[:, None]
                            & (pos[:, None] + np.arange(m)[None, :] < t))
    times = pos[rows] + cols
    return tuple(to_device(a.astype(np.int64), device)
                 for a in (rows, cols, times))


def _embed(params, tokens):
    return params["embed"][tokens.to(torch.int64)]


def _mlp_residual(p, cfg, x):
    return x + L.swiglu(p["mlp"], L.rmsnorm(p["mlp_norm"], x, cfg.norm_eps))


def _qkv(p, cfg, x, positions):
    hd = cfg.resolved_head_dim
    xin = L.rmsnorm(p["attn_norm"], x, cfg.norm_eps)
    q, k, v = L.project_qkv(p["attn"], xin, cfg.num_heads, cfg.kv_heads, hd)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _logits(params, cfg, x):
    x = L.rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return L.dense(x, params["lm_head"])


def _self_attention(p, cfg, x, positions, chunked: bool):
    """One block's full-sequence causal self-attention
    (``transformer.py:60``): (projected output, k, v)."""
    q, k, v = _qkv(p, cfg, x, positions)
    attend = L.chunked_attention if chunked else L.attention
    out = attend(q, k, v, causal=True, window=cfg.sliding_window)
    return L.project_out(p["attn"], out), k, v


# Above this length ``forward`` and ``prefill`` stream the attention
# through ``chunked_attention`` (``transformer.py:96,157``).
MAX_DENSE_FORWARD = 2048


def _full_positions(b: int, s: int, device) -> torch.Tensor:
    return torch.arange(s, device=device)[None, None, :].expand(b, 1, s)


def forward(params: dict, cfg: ModelConfig, batch: dict, *,
            chunked: Optional[bool] = None) -> torch.Tensor:
    """Full-sequence causal pass (``transformer.py:91``): tokens (B, S)
    -> logits (B, S, Vpad).  ``chunked`` (default: S > 2,048) streams the
    attention through ``chunked_attention``.  The reference engine
    scores its token buffers with it."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    if chunked is None:
        chunked = s > MAX_DENSE_FORWARD
    positions = _full_positions(b, s, tokens.device)
    x = _embed(params, tokens)
    for p in params["layers"]:
        h, _, _ = _self_attention(p, cfg, x, positions, chunked)
        x = _mlp_residual(p, cfg, x + h)
    return _logits(params, cfg, x)


def _install_prefill(leaf: torch.Tensor, new: torch.Tensor) -> None:
    """In place: a layer's (B, H, S, hd) prefill keys into its (B, H, T,
    hd) cache (``transformer.py:140-151``): at time 0 when S < T, else
    the last T positions at their ring slots (position p at p % T)."""
    t, s = leaf.shape[2], new.shape[2]
    if s < t:
        leaf[:, :, :s].copy_(new)
    else:
        leaf.copy_(torch.roll(new[:, :, s - t:], s % t, dims=2))


def prefill(params: dict, cfg: ModelConfig, batch: dict, cache: dict):
    """Dense prefill (``transformer.py:155``): tokens (B, S) from
    position 0 -> (last logits (B, Vpad), the cache with their keys and
    values and ``pos`` = S).  Chunked attention above 2,048 tokens."""
    tokens = batch["tokens"]
    b, s = tokens.shape
    positions = _full_positions(b, s, tokens.device)
    x = _embed(params, tokens)
    for li, p in enumerate(params["layers"]):
        h, k, v = _self_attention(p, cfg, x, positions,
                                  s > MAX_DENSE_FORWARD)
        x = _mlp_residual(p, cfg, x + h)
        _install_prefill(cache["k"][li], k)
        _install_prefill(cache["v"][li], v)
    logits = _logits(params, cfg, x[:, -1:])[:, 0]
    return logits, {"k": cache["k"], "v": cache["v"], "pos": s}


def decode_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                cache: dict):
    """One token per row at the cache's shared position
    (``transformer.py:192``): tokens (B, 1) -> (logits (B, Vpad), the
    cache one position on).  The key lands at ``pos % T``; the attention
    reads the first ``min(pos + 1, T)`` keys."""
    pos = int(cache["pos"])
    t = cache["k"].shape[3]
    slot = pos % t
    positions = torch.full((tokens.shape[0], 1, 1), pos,
                           device=tokens.device)
    x = _embed(params, tokens)
    for li, p in enumerate(params["layers"]):
        q, k, v = _qkv(p, cfg, x, positions)
        ck, cv = cache["k"][li], cache["v"][li]
        ck[:, :, slot:slot + 1].copy_(k)
        cv[:, :, slot:slot + 1].copy_(v)
        out = L.attention(q, ck, cv, causal=False, kv_len=min(pos + 1, t))
        x = _mlp_residual(p, cfg, x + L.project_out(p["attn"], out))
    return (_logits(params, cfg, x)[:, 0],
            {"k": cache["k"], "v": cache["v"], "pos": pos + 1})


def verify_step(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                cache: dict):
    """The verify chunk at the cache's shared position
    (``transformer.py:407``): tokens (B, m), the pending token and m - 1
    drafts -> (logits (B, m, Vpad), the cache m positions on), column j
    scoring the continuation after ``tokens[:, :j+1]``.  A quantized
    tree (``serving.quant.quantize_params``) runs its matmuls W8A8
    (``serving.quant.verify_step_q``).  Non-ring caches only."""
    _non_ring(cfg, "verify_step")
    pos = int(cache["pos"])
    b, m = tokens.shape
    t = cache["k"].shape[3]
    start = min(max(pos, 0), t - m)      # dynamic_update_slice's clamp
    positions = (pos + torch.arange(m, device=tokens.device))[
        None, None, :].expand(b, 1, m)
    x = _embed(params, tokens)
    for li, p in enumerate(params["layers"]):
        q, k, v = _qkv(p, cfg, x, positions)
        ck, cv = cache["k"][li], cache["v"][li]
        ck[:, :, start:start + m].copy_(k)
        cv[:, :, start:start + m].copy_(v)
        out = L.attention(q, ck, cv, causal=True, q_offset=pos,
                          kv_len=pos + m)
        x = _mlp_residual(p, cfg, x + L.project_out(p["attn"], out))
    return (_logits(params, cfg, x),
            {"k": cache["k"], "v": cache["v"], "pos": pos + m})




# ---------------------------------------------------------------------------
# Slot calls of the cache arenas, contiguous and paged
# ---------------------------------------------------------------------------
#
# Each slot call's per-layer body is one function of (layer params, x,
# the layer's cache leaves) that writes the leaves in place, shared by
# the contiguous call (the leaves are views of the arena's layer) and
# the paged one (``models/paged.py::paged_block``: the layer's view is
# gathered through the page table, the same body runs on it, and the
# leaves are scattered back), as JAX's ``_block_*_slots`` are shared
# through ``paged_block`` (``transformer.py:481-551``).


def _run_layers(params: dict, block, x: torch.Tensor, cache: dict,
                paged=None) -> torch.Tensor:
    """``block(params_l, x, cache_l) -> x`` over the layers.  ``paged``
    = (table, buf_len) runs it on paged storage ``cache`` = {leaf:
    (layers, P + 2, H, page, d)}."""
    if paged is not None:
        from repro_torch.models.paged import paged_block
        block = paged_block(block, *paged)
    for li, p in enumerate(params["layers"]):
        x = block(p, x, {kk: leaf[li] for kk, leaf in cache.items()
                         if kk != "pos"})
    return x


def _attend(p, cfg, x, q, cache_l, **kw):
    """The block's attention over its (written) layer cache, then the
    output projection and the MLP residual."""
    out = L.attention(q, cache_l["k"], cache_l["v"],
                      k_scale=cache_l.get("k_s"), v_scale=cache_l.get("v_s"),
                      **kw)
    x = x + L.project_out(p["attn"], out)
    return _mlp_residual(p, cfg, x)


def _prefill_block(p, x, cache_l, *, cfg, positions, pos_d, m, plan,
                   use_kernel):
    rows, cols, times = plan
    q, k, v = _qkv(p, cfg, x, positions)
    k, v, ks, vs = _maybe_quantize_kv(cache_l, k, v)
    for kk, new in (("k", k), ("v", v), ("k_s", ks), ("v_s", vs)):
        if new is not None:
            cache_l[kk].transpose(1, 2).index_put_(
                (rows, times), new.transpose(1, 2)[rows, cols])
    return _attend(p, cfg, x, q, cache_l, causal=True, q_offset=pos_d,
                   kv_len=pos_d + m, use_kernel=use_kernel)


def _decode_block(p, x, cache_l, *, cfg, pos, kv_len, t, use_kernel):
    q, k, v = _qkv(p, cfg, x, pos[:, None, None])
    k, v, ks, vs = _maybe_quantize_kv(cache_l, k, v)
    _rowwise_cache_write(cache_l["k"], cache_l["v"], k, v, pos % t)
    if ks is not None:
        _rowwise_cache_write(cache_l["k_s"], cache_l["v_s"], ks, vs, pos % t)
    return _attend(p, cfg, x, q, cache_l, causal=False, kv_len=kv_len,
                   use_kernel=use_kernel)


def _verify_block(p, x, cache_l, *, cfg, pos, m):
    positions = pos[:, None, None] + torch.arange(m, device=pos.device)
    q, k, v = _qkv(p, cfg, x, positions)
    k, v, ks, vs = _maybe_quantize_kv(cache_l, k, v)
    _rowwise_cache_write(cache_l["k"], cache_l["v"], k, v, pos)
    if ks is not None:
        _rowwise_cache_write(cache_l["k_s"], cache_l["v_s"], ks, vs, pos)
    return _attend(p, cfg, x, q, cache_l, causal=True, q_offset=pos,
                   kv_len=pos + m)


def _prefill_slots(params, cfg, tokens, cache, pos, write, t, use_kernel,
                   paged=None) -> None:
    _non_ring(cfg, "prefill_slots")
    b, m = tokens.shape
    pos = np.asarray(pos, np.int64)
    write = (np.ones(b, bool) if write is None
             else np.asarray(write, bool))
    dev = tokens.device
    pos_d = to_device(pos, dev)
    block = functools.partial(
        _prefill_block, cfg=cfg,
        positions=pos_d[:, None, None] + torch.arange(m, device=dev),
        pos_d=pos_d, m=m, plan=_masked_write_index(pos, write, m, t, dev),
        use_kernel=use_kernel)
    _run_layers(params, block, _embed(params, tokens), cache, paged)


def prefill_slots(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                  cache: dict, pos: np.ndarray,
                  write: Optional[np.ndarray] = None, *,
                  use_kernel: bool = False) -> dict:
    """Admission prefill straight into the arena (``transformer.py:284``):
    tokens (B, m) land at per-row offsets ``pos`` (B,); rows with
    ``write`` False are bit-untouched.  ``pos``/``write`` are the host
    admission plan (numpy), so the masked scatter needs no device sync.
    No logits are computed.  ``use_kernel`` routes the chunk attention
    through ``kernels/flash_attention``."""
    _prefill_slots(params, cfg, tokens, cache, pos, write,
                   cache["k"].shape[3], use_kernel)
    return cache


def prefill_slots_paged(params: dict, cfg: ModelConfig,
                        tokens: torch.Tensor, pages: dict,
                        table: torch.Tensor, pos: np.ndarray,
                        write: Optional[np.ndarray] = None, *, buf_len: int,
                        use_kernel: bool = False) -> dict:
    """``prefill_slots`` against paged storage (``transformer.py:495``):
    pages {leaf: (layers, P + 2, H, page, d)} written in place through
    ``table`` (rows, n_lp) at view length ``buf_len``.  Written rows'
    pages must be reserved through ``pos + m``; masked rows' and
    unmapped positions' writes are dropped."""
    _prefill_slots(params, cfg, tokens, pages, pos, write, buf_len,
                   use_kernel, paged=(table, buf_len))
    return pages


def _decode_step_slots(params, cfg, tokens, cache, pos, t, use_kernel,
                       return_logits, paged=None):
    pos = pos.to(torch.int64)
    block = functools.partial(_decode_block, cfg=cfg, pos=pos,
                              kv_len=torch.clamp(pos + 1, max=t), t=t,
                              use_kernel=use_kernel)
    x = _run_layers(params, block, _embed(params, tokens), cache, paged)
    if not return_logits:
        return None
    return _logits(params, cfg, x)[:, 0]


def decode_step_slots(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                      cache: dict, pos: torch.Tensor, *,
                      use_kernel: bool = False,
                      return_logits: bool = True):
    """Per-row-position decode (``transformer.py:357``): tokens (B, 1),
    pos (B,) -> logits (B, Vpad) (None with ``return_logits=False``, for
    callers that only need the cache write).  Row b writes its KV at
    ``pos[b] % T`` and attends the first ``min(pos[b] + 1, T)`` keys.
    ``use_kernel`` streams the attention through
    ``kernels/decode_attention``."""
    return _decode_step_slots(params, cfg, tokens, cache, pos,
                              cache["k"].shape[3], use_kernel, return_logits)


def decode_step_slots_paged(params: dict, cfg: ModelConfig,
                            tokens: torch.Tensor, pages: dict,
                            table: torch.Tensor, pos: torch.Tensor, *,
                            buf_len: int, use_kernel: bool = False,
                            return_logits: bool = True):
    """``decode_step_slots`` against paged storage
    (``transformer.py:517``), the pages written in place; the kernel
    route runs on each layer's gathered view."""
    return _decode_step_slots(params, cfg, tokens, pages, pos, buf_len,
                              use_kernel, return_logits,
                              paged=(table, buf_len))


def _verify_step_slots(params, cfg, tokens, cache, pos, paged=None):
    _non_ring(cfg, "verify_step_slots")
    block = functools.partial(_verify_block, cfg=cfg,
                              pos=pos.to(torch.int64), m=tokens.shape[1])
    x = _run_layers(params, block, _embed(params, tokens), cache, paged)
    return _logits(params, cfg, x)


def verify_step_slots(params: dict, cfg: ModelConfig, tokens: torch.Tensor,
                      cache: dict, pos: torch.Tensor) -> torch.Tensor:
    """Per-row-position verify chunk (``transformer.py:459``): tokens
    (B, m), pos (B,) -> logits (B, m, Vpad), row b's column j scoring
    the continuation after its cache prefix and ``tokens[b, :j+1]``.
    The attention is the dense path, as in the JAX package (which
    passes no ``use_kernel`` here).  A quantized parameter tree
    (``serving.quant.quantize_params``) runs its matmuls W8A8."""
    return _verify_step_slots(params, cfg, tokens, cache, pos)


def verify_step_slots_paged(params: dict, cfg: ModelConfig,
                            tokens: torch.Tensor, pages: dict,
                            table: torch.Tensor, pos: torch.Tensor, *,
                            buf_len: int) -> torch.Tensor:
    """``verify_step_slots`` against paged storage
    (``transformer.py:535``), the pages written in place."""
    return _verify_step_slots(params, cfg, tokens, pages, pos,
                              paged=(table, buf_len))
