"""Batched request scheduler for speculative-decoding serving -- the port's
counterpart of ``repro/specdec/scheduler.py`` with the FIFO policy and
three cache modes:

* ``cache_mode="kv_fused"`` (default here) over a ``CachedSpecDecEngine``:
  fused rounds.  Under bucketed admission (the default) requests
  admitted in a step only prefill (overlapped with the round advancing
  the earlier ones) and emit from the next step on;
* ``cache_mode="kv"``: the same engine and pool with the host-driven
  round (``gen_blocks(..., fused=False)``);
* ``cache_mode="reprefill"`` over the reference ``SpecDecEngine``: every
  block re-scores the whole prefix, so admitted requests advance in the
  step that admits them; ``batched=True`` (the default) stacks all live
  requests into (R*K, T) forwards (``gen_blocks``), ``batched=False``
  runs one block per request, as JAX's default does.  This is how an SSM target (Mamba-2) is served, as in
  JAX, where the cached engine is dense-only.

``admission`` picks the cached engine's prefill path: ``"bucketed"``
waves of stacked ``prefill_slots`` or ``"per_request"`` dense prefills
(``CachedSpecDecEngine.admit``); only kv_fused with bucketed admission
overlaps admission with the round, so under ``kv`` (and per-request
kv_fused) requests admitted in a step advance in that step.

Up to ``max_batch`` live requests advance one speculative block per
round.  Per-request randomness is
``fold_in(fold_in(key, uid), blocks)`` -- nested folds, the SAME key
every round -- so a request's stream depends only on (uid, blocks),
exactly as in the JAX scheduler; the keys are derived on the host (a few
dozen integer ops) and uploaded with the round's inputs.

Buffer lengths grow monotonically to the largest live requirement
(``_required_buf``, as JAX's), so a request's buffer -- and therefore
its tokens -- never depend on the mode that ran it.

The v2 policy (eviction, preemption, priorities) and the fault/journal
layers are later slices (ROADMAP).
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from repro_torch import random as R


class InvalidRequest(ValueError):
    """A malformed ``submit()``, rejected at the API boundary."""


def validate_prompt(prompt, max_new, vocab: Optional[int]) -> np.ndarray:
    """The port's copy of ``serving/guard.py::validate_prompt``."""
    arr = np.asarray(prompt)
    if arr.ndim != 1:
        raise InvalidRequest(
            f"prompt must be a 1-D token sequence, got shape {arr.shape}")
    if arr.size == 0:
        raise InvalidRequest("prompt must contain at least one token")
    if not np.issubdtype(arr.dtype, np.integer):
        raise InvalidRequest(
            f"prompt must have an integer dtype, got {arr.dtype}")
    if not isinstance(max_new, (int, np.integer)) or max_new < 1:
        raise InvalidRequest(f"max_new must be an int >= 1, got {max_new!r}")
    if vocab is not None:
        lo, hi = int(arr.min()), int(arr.max())
        if lo < 0 or hi >= vocab:
            raise InvalidRequest(
                f"prompt token ids must lie in [0, {vocab}), got "
                f"range [{lo}, {hi}]")
    return arr.astype(np.int32)


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray
    max_new: int
    output: list = dataclasses.field(default_factory=list)
    blocks: int = 0
    accepted: int = 0
    t_submit: float = 0.0
    t_first: Optional[float] = None

    @property
    def done(self) -> bool:
        return len(self.output) >= self.max_new

    @property
    def block_efficiency(self) -> float:
        return len(self.output) / max(self.blocks, 1)

    @property
    def ttft_ms(self) -> Optional[float]:
        if self.t_first is None:
            return None
        return (self.t_first - self.t_submit) * 1e3


@dataclasses.dataclass
class ServerMetrics:
    completed: int = 0
    total_tokens: int = 0
    total_blocks: int = 0
    rounds: int = 0
    target_forwards: int = 0
    # kv_fused: host waits on the card, counted by ``device.SyncCounter``:
    # in the rounds' packed fetches (one per round; the CPU counts the
    # fetch as one), and while rounds and admissions are queued (0 when
    # fused).  kv: on the card the waits counted the same way, in each
    # request's verification and in the sweeps' draft fetches (L per
    # round); on the CPU the fetches, as JAX counts them.  reprefill: the
    # engine's fetches, verification's (one per request per block) and
    # the draft tokens' (one per draft step).
    host_syncs: int = 0
    draft_syncs: int = 0
    wall_s: float = 0.0

    @property
    def tokens_per_s(self) -> float:
        return self.total_tokens / max(self.wall_s, 1e-9)

    @property
    def mean_block_efficiency(self) -> float:
        return self.total_tokens / max(self.total_blocks, 1)


CACHE_MODES = ("reprefill", "kv", "kv_fused")
ADMISSION_MODES = ("bucketed", "per_request")


class SpecDecServer:
    """FIFO block scheduler: over a ``CachedSpecDecEngine`` with fused
    rounds (``cache_mode="kv_fused"``, the JAX server's
    ``policy="fifo"``) or host-driven ones (``"kv"``), admitting through
    bucketed waves or per request (``admission``), or over a reference
    ``SpecDecEngine`` (``cache_mode="reprefill"``, sequential or
    ``batched``)."""

    def __init__(self, engine, max_batch: int = 8, batched: bool = True,
                 cache_mode: str = "kv_fused", admission: str = "bucketed"):
        if cache_mode not in CACHE_MODES:
            raise ValueError(f"unknown cache_mode {cache_mode!r}")
        if admission not in ADMISSION_MODES:
            raise ValueError(f"unknown admission mode {admission!r}")
        if cache_mode in ("kv", "kv_fused"):
            if not hasattr(engine, "admit"):
                raise TypeError(
                    f"cache_mode={cache_mode!r} needs a CachedSpecDecEngine")
            if engine.pool_slots < max_batch:
                raise ValueError(
                    f"engine pool has {engine.pool_slots} slots < "
                    f"max_batch={max_batch}")
        elif not hasattr(engine, "gen_blocks"):
            raise TypeError("cache_mode='reprefill' needs a SpecDecEngine")
        self.engine = engine
        self.max_batch = max_batch
        self.batched = batched
        self.cache_mode = cache_mode
        self.admission = admission
        self.queue: deque = deque()
        self.live: list = []
        self._uid = 0
        self._buf_len = 0
        self.metrics = ServerMetrics()

    def submit(self, prompt: np.ndarray, max_new: int = 32) -> int:
        prompt = validate_prompt(prompt, max_new, self.engine.vocab)
        self._uid += 1
        self.queue.append(Request(uid=self._uid, prompt=prompt,
                                  max_new=int(max_new),
                                  t_submit=time.time()))
        return self._uid

    def _admit(self) -> list:
        newly = []
        while self.queue and len(self.live) < self.max_batch:
            req = self.queue.popleft()
            self.live.append(req)
            newly.append(req)
        return newly

    def _required_buf(self, req: Request) -> int:
        return len(req.prompt) + req.max_new + self.engine.cfg.draft_len + 2

    def step(self, key: torch.Tensor) -> list:
        """Advance every live request by one block (``scheduler.py:678``);
        returns the requests that finished this round."""
        t0 = time.perf_counter()
        try:
            newly = self._admit()
            if not self.live:
                return []
            self._buf_len = max([self._buf_len]
                                + [self._required_buf(r) for r in self.live])
            overlap = (self.cache_mode == "kv_fused"
                       and self.admission == "bucketed")
            new_ids = {id(r) for r in newly}
            advancing = [r for r in self.live if id(r) not in new_ids] \
                if overlap else list(self.live)
            key = key.cpu()
            subs = [R.fold_in(R.fold_in(key, r.uid), r.blocks)
                    for r in advancing]
            fw0 = self.engine.num_target_forwards
            ds0 = self.engine.num_draft_syncs
            outs = self._engine_round(subs, advancing, newly, overlap)
            if advancing:
                self.metrics.rounds += 1
            self.metrics.target_forwards += \
                self.engine.num_target_forwards - fw0
            self.metrics.draft_syncs += self.engine.num_draft_syncs - ds0
            return self._commit(advancing, outs)
        finally:
            self.metrics.wall_s += time.perf_counter() - t0

    def _engine_round(self, subs, advancing, newly, overlap) -> list:
        """One engine round (``scheduler.py:741``)."""
        if overlap:
            tails = [int(r.output[-1]) if r.output else int(r.prompt[-1])
                     for r in advancing]
            return self.engine.round_with_admission(
                subs, [r.uid for r in advancing],
                [(r.uid, np.concatenate([r.prompt,
                                         np.asarray(r.output, np.int32)]))
                 for r in newly], self._buf_len, tails=tails)
        prefixes = [np.concatenate([r.prompt,
                                    np.asarray(r.output, np.int32)])
                    for r in advancing]
        if self.cache_mode in ("kv", "kv_fused"):
            return self.engine.gen_blocks(
                subs, prefixes, self._buf_len,
                uids=[r.uid for r in advancing],
                fused=self.cache_mode == "kv_fused",
                admission=self.admission)
        if self.batched:
            return self.engine.gen_blocks(subs, prefixes, self._buf_len)
        return [self.engine.gen_block(sub, prefix, self._buf_len)
                for sub, prefix in zip(subs, prefixes)]

    def _commit(self, advancing, outs) -> list:
        finished = []
        t_commit = time.time()
        for req, out in zip(advancing, outs):
            emit = list(out.new_tokens)[:req.max_new - len(req.output)]
            req.output.extend(emit)
            req.blocks += 1
            req.accepted += out.accepted
            self.metrics.host_syncs += out.verify_syncs
            if req.t_first is None:
                req.t_first = t_commit
            if req.done:
                finished.append(req)
        for req in finished:
            self.live.remove(req)
            if self.cache_mode in ("kv", "kv_fused"):
                self.engine.release(req.uid)
            self.metrics.completed += 1
            self.metrics.total_tokens += len(req.output)
            self.metrics.total_blocks += req.blocks
        return finished

    def run(self, key: torch.Tensor) -> list:
        """Drain the queue; returns the completed requests in finish
        order.  The SAME key feeds every round."""
        done = []
        while self.queue or self.live:
            done.extend(self.step(key))
        return done
