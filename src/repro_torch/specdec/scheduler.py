"""Batched request scheduler for speculative-decoding serving -- the port's
counterpart of ``repro/specdec/scheduler.py``: the FIFO and v2 policies
over three cache modes:

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

``policy="v2"`` (``scheduler.py:264-292``, DESIGN.md §12), over kv or
kv_fused: queued requests admit in (priority desc, evictions asc, submit
order); a candidate that does not fit (the batch is full, or, under a
fixed page budget, its lifetime pages would oversubscribe the pool) may
displace strictly lower-priority live requests.  On a paged engine the
displaced request SUSPENDS (its pages detach into a handle and resume
re-attaches them, no recompute); page pressure may strip a handle,
demoting its holder to a hard eviction that re-admits through a
re-prefill of prompt + output, the only path of a contiguous engine.
``preempt_tokens=N`` also preempts a live request that has emitted N
tokens since its admission while an outranking request waits.
Randomness is (uid, blocks)-keyed, so a suspend and resume (the same
bytes) is token-invisible, and so is a re-prefill where it rebuilds the
decode-built KV bit for bit (the CPU's plain routes; on the card an int8
re-prefill can round differently, ROADMAP queue 3).  ``min_buf_len``
pins the starting buffer, whose length (the reduction shapes) would
otherwise depend on which requests are live together.
``submit(..., on_token=)`` streams each token at the round that commits
it; a raising callback fails only its own request (``failed``).

Deadlines, shedding, rate limits, faults, the journal and the
degradation ladder are a later slice (ROADMAP item 18); ``_order``
keeps JAX's key with no deadline, so such traffic orders as JAX's does.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable, Optional

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
    # v2 inputs: a higher priority admits first and is never evicted for
    # a lower one; ``on_token(uid, token)`` streams tokens as they commit.
    priority: int = 0
    on_token: Optional[Callable] = None
    output: list = dataclasses.field(default_factory=list)
    blocks: int = 0
    accepted: int = 0
    t_submit: float = 0.0
    t_first: Optional[float] = None
    t_done: Optional[float] = None
    # Eviction accounting: ``t_submit`` is never reset, so TTFT and
    # ``wall_s`` include time spent evicted; ``evicted_s`` is that time,
    # and ``token_times`` stamps every emitted token.
    evictions: int = 0
    evicted_s: float = 0.0
    token_times: list = dataclasses.field(default_factory=list)
    tokens_since_admit: int = 0
    t_admit: Optional[float] = None
    error: Optional[str] = None
    _t_evict: Optional[float] = None
    # A suspended request's page handle (paged engines).
    _kv_handle: Optional[dict] = None

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

    @property
    def wall_s(self) -> Optional[float]:
        """Submission to completion, eviction time included."""
        if self.t_done is None:
            return None
        return self.t_done - self.t_submit

    @property
    def itl_ms(self) -> list:
        """Inter-token gaps (ms); a round's tokens share a stamp."""
        t = self.token_times
        return [(b - a) * 1e3 for a, b in zip(t, t[1:])]


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
    evictions: int = 0           # capacity evictions (v2)
    preemptions: int = 0         # preempt_tokens rotations (v2)
    callback_errors: int = 0     # on_token callbacks that raised
    wall_s: float = 0.0

    @property
    def tokens_per_s(self) -> float:
        return self.total_tokens / max(self.wall_s, 1e-9)

    @property
    def mean_block_efficiency(self) -> float:
        return self.total_tokens / max(self.total_blocks, 1)


CACHE_MODES = ("reprefill", "kv", "kv_fused")
ADMISSION_MODES = ("bucketed", "per_request")
POLICIES = ("fifo", "v2")


class SpecDecServer:
    """Block scheduler: over a ``CachedSpecDecEngine`` with fused rounds
    (``cache_mode="kv_fused"``) or host-driven ones (``"kv"``), admitting
    through bucketed waves or per request (``admission``), or over a
    reference ``SpecDecEngine`` (``cache_mode="reprefill"``, sequential
    or ``batched``); ``policy`` "fifo" or "v2" (module docstring), with
    ``preempt_tokens`` and ``min_buf_len``."""

    def __init__(self, engine, max_batch: int = 8, batched: bool = True,
                 cache_mode: str = "kv_fused", admission: str = "bucketed",
                 policy: str = "fifo", preempt_tokens: Optional[int] = None,
                 min_buf_len: int = 0):
        if cache_mode not in CACHE_MODES:
            raise ValueError(f"unknown cache_mode {cache_mode!r}")
        if admission not in ADMISSION_MODES:
            raise ValueError(f"unknown admission mode {admission!r}")
        if policy not in POLICIES:
            raise ValueError(f"unknown policy {policy!r}")
        if policy == "v2" and cache_mode not in ("kv", "kv_fused"):
            raise ValueError(
                "policy='v2' needs cache_mode 'kv' or 'kv_fused' — "
                "eviction releases engine sessions")
        if preempt_tokens is not None:
            if policy != "v2":
                raise ValueError("preempt_tokens needs policy='v2'")
            if preempt_tokens < 1:
                raise ValueError("preempt_tokens must be >= 1")
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
        self.policy = policy
        self.preempt_tokens = preempt_tokens
        self.queue: deque = deque()
        self.live: list = []
        self._uid = 0
        self._buf_len = max(0, int(min_buf_len))
        self.metrics = ServerMetrics()
        # Requests whose ``on_token`` callback raised.
        self.failed: list = []

    def submit(self, prompt: np.ndarray, max_new: int = 32, *,
               priority: int = 0, on_token: Optional[Callable] = None) -> int:
        """Queue a request.  ``priority`` orders v2 admission (fifo
        ignores it); ``on_token(uid, token)`` is called once per emitted
        token, in order, at the round commit that produced it.  A
        malformed request raises ``InvalidRequest`` here."""
        prompt = validate_prompt(prompt, max_new, self.engine.vocab)
        self._uid += 1
        self.queue.append(Request(uid=self._uid, prompt=prompt,
                                  max_new=int(max_new), priority=priority,
                                  on_token=on_token, t_submit=time.time()))
        return self._uid

    # ---- admission / eviction policy (``scheduler.py:484-627``) --------

    @staticmethod
    def _order(req: Request):
        """v2 queue order: priority, then evicted requests behind
        same-priority waiters, then JAX's deadline term (none here: the
        deadline-free key), then submission order."""
        return (-req.priority, req.evictions, np.inf, req.t_submit, req.uid)

    def _mark_admitted(self, req: Request, now: float) -> None:
        if req._t_evict is not None:
            req.evicted_s += now - req._t_evict
            req._t_evict = None
        req.t_admit = now
        req.tokens_since_admit = 0

    def _evict(self, req: Request, now: float) -> None:
        """Displace ``req`` and requeue it: a paged engine suspends it
        (the pages stay, resume re-attaches them), any other releases it
        (re-admission re-prefills prompt + output)."""
        self.live.remove(req)
        if self.engine.has_session(req.uid):
            if self.engine.can_suspend():
                req._kv_handle = self.engine.suspend(req.uid)
            else:
                self.engine.evict(req.uid)
        req.evictions += 1
        req._t_evict = now
        self.queue.append(req)

    def _lifetime_pages(self, req: Request) -> int:
        """The pages ``req`` holds once fully decoded: admission against
        lifetime commitments keeps mid-round reservations inside a fixed
        budget."""
        return self.engine.request_pages(len(req.prompt) + req.max_new)

    def _pick_victim(self, below_priority: int, protect: set):
        """The lowest-priority live request strictly below
        ``below_priority``, not admitted this step, shortest prefix
        first (the cheapest re-prefill)."""
        cands = [r for r in self.live
                 if r.priority < below_priority and id(r) not in protect]
        if not cands:
            return None
        return min(cands, key=lambda r: (r.priority,
                                         len(r.prompt) + len(r.output),
                                         r.uid))

    def _admit_v2(self, now: float) -> list:
        page_state = self.engine.page_state()
        fixed = bool(page_state and page_state.get("fixed"))
        newly: list = []
        protect: set = set()
        while self.queue:
            cand = min(self.queue, key=self._order)
            blocked_by_pages = False
            if fixed:
                # Live requests count their lifetime pages; suspended
                # queue entries their handles' actual pages.
                committed = sum(self._lifetime_pages(r) for r in self.live)
                committed += sum(self.engine.handle_pages(q._kv_handle)
                                 for q in self.queue
                                 if q._kv_handle is not None and q is not cand)
                need = self._lifetime_pages(cand)
                if need > page_state["total"]:
                    raise ValueError(
                        f"request uid={cand.uid} needs {need} pages but "
                        f"the pool only has {page_state['total']}")
                blocked_by_pages = committed + need > page_state["total"]
            if len(self.live) >= self.max_batch or blocked_by_pages:
                # Page pressure strips the worst-ranked handle behind
                # ``cand`` first, without touching the live set.
                if blocked_by_pages and len(self.live) < self.max_batch:
                    holders = [q for q in self.queue
                               if q._kv_handle is not None and q is not cand
                               and self._order(q) > self._order(cand)]
                    if holders:
                        worst = max(holders, key=self._order)
                        self.engine.drop_handle(worst._kv_handle)
                        worst._kv_handle = None
                        self.metrics.evictions += 1
                        continue
                victim = self._pick_victim(cand.priority, protect)
                if victim is None:
                    break
                self._evict(victim, now)
                self.metrics.evictions += 1
                continue
            self.queue.remove(cand)
            self.live.append(cand)
            protect.add(id(cand))
            self._mark_admitted(cand, now)
            if cand._kv_handle is not None:
                # Resume: the KV is resident, so the request advances
                # this round (randomness is (uid, blocks)-keyed).
                self.engine.resume(cand.uid, cand._kv_handle)
                cand._kv_handle = None
            else:
                newly.append(cand)
        return newly

    def _preempt(self, now: float) -> None:
        """Fairness rotation: while requests wait, evict live requests
        that emitted ``preempt_tokens`` or more since their admission,
        if some waiter would outrank them once displaced."""
        if not self.preempt_tokens or not self.queue:
            return
        for req in list(self.live):
            if req.done or req.tokens_since_admit < self.preempt_tokens:
                continue
            # JAX's tuple, compared against ``_order``'s as it is there.
            displaced = (-req.priority, req.evictions + 1,
                         req.t_submit, req.uid)
            if not any(self._order(q) < displaced for q in self.queue):
                continue
            self._evict(req, now)
            self.metrics.preemptions += 1

    def _admit(self) -> list:
        """Move queued requests into the live set; returns the newly
        admitted ones (resumed requests are not among them)."""
        now = time.time()
        if self.policy == "v2":
            self._preempt(now)
            return self._admit_v2(now)
        newly = []
        while self.queue and len(self.live) < self.max_batch:
            req = self.queue.popleft()
            self.live.append(req)
            newly.append(req)
            self._mark_admitted(req, now)
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
        """Commit a round (``scheduler.py:854-918``, without the
        journal): emit tokens, stream them, retire finished requests,
        and fail only the request whose callback raised."""
        finished, cb_failed, emits = [], [], []
        t_commit = time.time()
        for req, out in zip(advancing, outs):
            emit = list(out.new_tokens)[:req.max_new - len(req.output)]
            emits.append(emit)
            req.output.extend(emit)
            req.blocks += 1
            req.accepted += out.accepted
            req.tokens_since_admit += len(emit)
            self.metrics.host_syncs += out.verify_syncs
            if req.t_first is None:
                req.t_first = t_commit
        for req, emit in zip(advancing, emits):
            for tok in emit:
                req.token_times.append(t_commit)
                if req.on_token is not None:
                    try:
                        req.on_token(req.uid, int(tok))
                    except Exception as e:
                        req.on_token = None
                        req.error = f"on_token callback raised: {e!r}"
                        cb_failed.append(req)
                        self.metrics.callback_errors += 1
            if req.error is None and req.done:
                req.t_done = t_commit
                finished.append(req)
        for req in cb_failed:
            # Its slot and pages are freed; its tokens stay on record.
            self.live.remove(req)
            if hasattr(self.engine, "has_session") \
                    and self.engine.has_session(req.uid):
                self.engine.release(req.uid)
            self.failed.append(req)
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
