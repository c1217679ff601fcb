"""Architecture registry of the port (``--arch <id>``).  Only the
configurations the port serves are listed (dense and SSM); the other
families of the JAX registry wait for their slice (ROADMAP queue 1,
item 15)."""

from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig

_MODULES = {
    "smollm-360m": "smollm_360m",
    "granite-8b": "granite_8b",
    "mamba2-370m": "mamba2_370m",
}

ARCH_NAMES = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; choose from {ARCH_NAMES}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG


__all__ = ["ARCH_NAMES", "get_config"]
