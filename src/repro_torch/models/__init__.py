"""Dense-family model code of the port (see ``transformer.py``)."""

from repro_torch.models.cache_pool import CachePool
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.models.transformer import (
    decode_step_slots,
    init_cache,
    init_params,
    prefill_slots,
    verify_step_slots,
)

__all__ = [
    "CachePool",
    "ModelConfig",
    "decode_step_slots",
    "init_cache",
    "init_params",
    "params_from_jax",
    "prefill_slots",
    "verify_step_slots",
]
