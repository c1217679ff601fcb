"""Family registry of the port: one model API over the dense and SSM
families -- the counterpart of ``repro/models/registry.py``.

  init_params(gen, cfg, device)               -> params
  forward(params, cfg, batch)                 -> logits (B, S, Vpad)
  init_cache(cfg, batch, max_len, device)     -> cache
  prefill(params, cfg, batch, cache)          -> (last logits (B, Vpad), cache)
  decode_step(params, cfg, tokens (B,1), cache) -> (logits (B, Vpad), cache)

The port serves dense models through the slot calls of ``transformer``
(``prefill_slots``, ``decode_step_slots``, ``verify_step_slots``), so
their ``prefill``/``decode_step`` raise here.
"""

from __future__ import annotations

from types import ModuleType

from repro_torch.models.config import ModelConfig


def family_module(cfg: ModelConfig) -> ModuleType:
    from repro_torch.models import mamba2, transformer
    return {"dense": transformer, "ssm": mamba2}[cfg.family]


def init_params(gen, cfg: ModelConfig, device):
    return family_module(cfg).init_params(gen, cfg, device)


def forward(params, cfg: ModelConfig, batch: dict):
    return family_module(cfg).forward(params, cfg, batch)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device):
    return family_module(cfg).init_cache(cfg, batch, max_len, device)


def _dense_serving_raises(cfg: ModelConfig, what: str) -> None:
    if cfg.family == "dense":
        raise NotImplementedError(
            f"dense {what} is not ported: the port serves dense models "
            "through prefill_slots / decode_step_slots (ROADMAP queue 1, "
            "item 11)")


def prefill(params, cfg: ModelConfig, batch: dict, cache: dict):
    _dense_serving_raises(cfg, "prefill")
    return family_module(cfg).prefill(params, cfg, batch, cache)


def decode_step(params, cfg: ModelConfig, tokens, cache: dict):
    _dense_serving_raises(cfg, "decode_step")
    return family_module(cfg).decode_step(params, cfg, tokens, cache)
