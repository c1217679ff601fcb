"""Speculative-decoding serving of the port: the six step verifiers,
fused block verification and the legacy host loop, the KV-cached
engine's fused and host-driven rounds over contiguous or paged arenas,
the reference engine and the scheduler (FIFO and v2 policies;
``cache_mode`` "kv_fused", "kv" and "reprefill")."""

from repro_torch.specdec.block_verify import (
    BACKENDS,
    RS_STRATEGIES,
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
from repro_torch.specdec.verify import (
    single_draft_verify,
    specinfer_verify,
    spectr_verify,
)

__all__ = [
    "BACKENDS",
    "RS_STRATEGIES",
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
    "single_draft_verify",
    "specinfer_verify",
    "spectr_verify",
]
