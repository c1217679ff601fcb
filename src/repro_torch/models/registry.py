"""Family registry of the port: one model API over the dense, MoE, SSM
and hybrid families -- the counterpart of ``repro/models/registry.py``.

  init_params(gen, cfg, device)               -> params
  forward(params, cfg, batch, **kw)           -> logits (B, S, Vpad)
  init_cache(cfg, batch, max_len, device)     -> cache
  prefill(params, cfg, batch, cache)          -> (last logits (B, Vpad), cache)
  decode_step(params, cfg, tokens (B,1), cache) -> (logits (B, Vpad), cache)
"""

from __future__ import annotations

from types import ModuleType

from repro_torch.models.config import ModelConfig


def family_module(cfg: ModelConfig) -> ModuleType:
    from repro_torch.models import mamba2, moe, rglru, transformer
    return {"dense": transformer, "moe": moe, "ssm": mamba2,
            "hybrid": rglru}[cfg.family]


def init_params(gen, cfg: ModelConfig, device):
    return family_module(cfg).init_params(gen, cfg, device)


def forward(params, cfg: ModelConfig, batch: dict, **kw):
    return family_module(cfg).forward(params, cfg, batch, **kw)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    return family_module(cfg).init_cache(cfg, batch, max_len, device)


def prefill(params, cfg: ModelConfig, batch: dict, cache: dict):
    return family_module(cfg).prefill(params, cfg, batch, cache)


def decode_step(params, cfg: ModelConfig, tokens, cache: dict):
    return family_module(cfg).decode_step(params, cfg, tokens, cache)
