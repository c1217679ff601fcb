"""Speculative-decoding configuration and the shared per-block pieces --
the port's counterpart of ``repro/specdec/engine.py:52-169``
(``SpecDecConfig``, ``probs_from_logits``, ``block_randomness``,
``BlockOutcome``).  The reference re-prefill engine ``SpecDecEngine`` is
a later slice (ROADMAP)."""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import random as R
from repro_torch.specdec.block_verify import BACKENDS, RACE_STRATEGIES

STRATEGIES = RACE_STRATEGIES
# Strategies of the JAX package that this port does not run yet.
DEFERRED_STRATEGIES = ("specinfer", "spectr", "single")


@dataclasses.dataclass(frozen=True)
class SpecDecConfig:
    num_drafts: int = 8           # K
    draft_len: int = 4            # L
    strategy: str = "gls"
    target_temp: float = 1.0
    draft_temp: float = 1.0       # one temperature for all K drafts
    top_k: int = 50
    max_new_tokens: int = 64
    # "torch" (the JAX "xla" twin) or "kernel" (the JAX "pallas" twin:
    # the gls_row_race CUDA kernel on the card).
    verifier_backend: str = "torch"
    # Route the drafter's decode attention through the decode_attention
    # kernel / admission prefill through the flash_attention kernel.
    # On a CPU tensor each takes its kernel's plain version.
    decode_kernel: bool = False
    prefill_kernel: bool = False

    def __post_init__(self):
        if self.strategy in DEFERRED_STRATEGIES:
            raise NotImplementedError(
                f"strategy {self.strategy!r} is not ported yet: the "
                "rejection-sampling verifiers are ROADMAP queue 1, item 9")
        if self.strategy not in STRATEGIES:
            raise ValueError(f"unknown strategy {self.strategy!r}")
        if self.verifier_backend not in BACKENDS:
            raise ValueError(
                f"unknown verifier backend {self.verifier_backend!r}")


@dataclasses.dataclass
class GenerationStats:
    output: np.ndarray            # accepted token ids
    blocks: int                   # target model calls
    accepted_drafts: int          # accepted DRAFT tokens (excl. bonus)
    host_syncs: int = 0           # device->host transfers


class BlockOutcome(NamedTuple):
    """Host-side outcome of one speculative block for one request."""
    new_tokens: list              # emitted tokens (accepted + 1 of them)
    accepted: int                 # accepted draft tokens
    verify_syncs: int             # host transfers spent verifying
    active: np.ndarray            # (K,) final active mask


def probs_from_logits(logits: torch.Tensor, temp: float, top_k: int,
                      vocab_size: int) -> torch.Tensor:
    """Temperature + top-k filtered probabilities over the TRUE vocab:
    the padded-vocab logits are sliced to ``vocab_size`` first, the k-th
    largest value is the threshold (ties at it are kept), then softmax."""
    logits = logits[..., :vocab_size].float()
    if temp <= 0:
        return torch.nn.functional.one_hot(
            torch.argmax(logits, -1), vocab_size).float()
    logits = logits / temp
    if top_k and top_k < vocab_size:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits >= kth, logits,
                             torch.full((), float("-inf"),
                                        dtype=logits.dtype,
                                        device=logits.device))
    return torch.softmax(logits, dim=-1)


def block_randomness(sub: torch.Tensor, draft_len: int, num_drafts: int,
                     vocab: int):
    """Shared log-uniforms + strategy key stream for one block, per key:
    sub (..., 2) -> (log_u (..., L+1, K, N), strat_keys (..., L+1, 2)).
    The uniforms are ``jax.random.uniform(minval=tiny, maxval=1)`` bit
    for bit; the log may differ from XLA's in the last ulp."""
    keys = R.split(sub)
    k_unif, k_strat = keys[..., 0, :], keys[..., 1, :]
    u = R.uniform(k_unif, (draft_len + 1, num_drafts, vocab),
                  minval=float(np.finfo(np.float32).tiny), maxval=1.0)
    return torch.log(u), R.split(k_strat, draft_len + 1)
