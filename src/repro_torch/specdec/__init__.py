"""Speculative-decoding serving of the port: the race-family verifiers,
fused block verification, the KV-cached engine's fused rounds, the
reference engine and the FIFO scheduler (``cache_mode="kv_fused"`` and
``"reprefill"``)."""

from repro_torch.specdec.block_verify import (
    BACKENDS,
    block_verify_batched,
)
from repro_torch.specdec.engine import (
    STRATEGIES,
    BlockOutcome,
    GenerationStats,
    SpecDecConfig,
    SpecDecEngine,
    autoregressive_reference,
    block_randomness,
    probs_from_logits,
)
from repro_torch.specdec.engine_cached import CachedSpecDecEngine
from repro_torch.specdec.scheduler import Request, ServerMetrics, SpecDecServer

__all__ = [
    "BACKENDS",
    "STRATEGIES",
    "BlockOutcome",
    "CachedSpecDecEngine",
    "GenerationStats",
    "Request",
    "ServerMetrics",
    "SpecDecConfig",
    "SpecDecEngine",
    "SpecDecServer",
    "autoregressive_reference",
    "block_randomness",
    "block_verify_batched",
    "probs_from_logits",
]
