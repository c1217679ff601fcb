"""Architecture registry of the port (``--arch <id>``): the dense, MoE,
SSM and hybrid configurations of the JAX registry, and the paper-scale
spec-dec pair.  whisper-small and llama-3.2-vision-11b (the encdec and
vlm families) wait for their slice (ROADMAP queue 1, item 15b)."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "smollm-360m": "smollm_360m",
    "granite-8b": "granite_8b",
    "mamba2-370m": "mamba2_370m",
    "granite-34b": "granite_34b",
    "llama3-405b": "llama3_405b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "mixtral-8x22b": "mixtral_8x22b",
    "recurrentgemma-2b": "recurrentgemma_2b",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


def all_configs() -> dict:
    return {name: get_config(name) for name in ARCH_NAMES}


# Paper-scale speculative decoding pair (``repro/configs/__init__.py:
# 47-56``): a ~100M-class llama target and a ~20M-class drafter.
PAPER_TARGET = ModelConfig(
    name="gls-target-100m", family="dense", num_layers=12, d_model=768,
    num_heads=12, num_kv_heads=4, head_dim=64, d_ff=2048,
    vocab_size=8192, dtype="float32",
)
PAPER_DRAFTER = ModelConfig(
    name="gls-drafter-20m", family="dense", num_layers=4, d_model=384,
    num_heads=6, num_kv_heads=2, head_dim=64, d_ff=1024,
    vocab_size=8192, dtype="float32",
)

__all__ = ["ARCH_NAMES", "PAPER_DRAFTER", "PAPER_TARGET", "all_configs",
           "get_config"]
