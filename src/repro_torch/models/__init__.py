"""Model code of the port: the dense family (``transformer.py``), the
MoE family (``moe.py``), Mamba-2 (``mamba2.py``), the RG-LRU hybrid
(``rglru.py``) and the family registry (``registry.py``), whose
dispatching ``init_params``/``forward``/``init_cache``/``prefill``/
``decode_step`` are this package's, the slot arenas (``cache_pool.py``,
contiguous and paged) and the paged storage (``paged.py``)."""

from repro_torch.models.cache_pool import (
    CachePool,
    PagedCachePool,
    PagePoolExhausted,
)
from repro_torch.models.config import ModelConfig
from repro_torch.models.convert import params_from_jax
from repro_torch.models.registry import (
    decode_step,
    forward,
    init_cache,
    init_params,
    prefill,
)
from repro_torch.models.transformer import (
    decode_step_slots,
    decode_step_slots_paged,
    prefill_slots,
    prefill_slots_paged,
    verify_step_slots,
    verify_step_slots_paged,
)

__all__ = [
    "CachePool",
    "ModelConfig",
    "PagePoolExhausted",
    "PagedCachePool",
    "decode_step",
    "decode_step_slots",
    "decode_step_slots_paged",
    "forward",
    "init_cache",
    "init_params",
    "params_from_jax",
    "prefill",
    "prefill_slots",
    "prefill_slots_paged",
    "verify_step_slots",
    "verify_step_slots_paged",
]
