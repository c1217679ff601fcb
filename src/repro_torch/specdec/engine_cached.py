"""KV-cached speculative decoding, fused rounds -- the port's counterpart
of ``repro/specdec/engine_cached.py`` on its ``kv_fused`` path.

One round advances every live request of the slot arena (DESIGN.md §8):

  1. per-slot shared uniforms and strategy keys (``block_randomness``);
  2. the L-step drafter sweep over the whole arena (``decode_step_slots``,
     drafted tokens stay on the device);
  3. ONE stacked target verify chunk (``verify_step_slots``);
  4. block verification, batched over slots (``block_verify_batched``:
     Algorithm 2 for the race family; the rejection-sampling strategies
     also read the sweep's drafter distributions);
  5. rollback: every row of a slot becomes its surviving row;
  6. the unconditional drafter catch-up step;
  7. ONE packed device-to-host fetch of {tokens, accepted, active, pos}.

PyTorch runs eagerly, so "one program" becomes: every step of the round
is queued on the device without a host round-trip, and the packed fetch
is the round's only device-to-host transfer.  On the card the engine
counts the host's actual waits (``device.SyncCounter``): those before
the fetch go to ``num_draft_syncs`` (0: drafts never leave the card),
those in the fetch to the round's ``verify_syncs`` (1).  The arenas are
updated in place.

Admission (§9): ``admit_batch`` drains a wave into power-of-two length
buckets and issues one stacked ``prefill_slots`` per (chunk round,
bucket) per model; ``round_with_admission`` queues those prefills after
the round and before its packed fetch, so they overlap the round.
``admit`` is the per-request path (``admission="per_request"``): the
dense ``prefill`` of the prompt into a temporary K-row cache, installed
by ``CachePool.write_prefill``.

``gen_blocks(..., fused=False)`` (the scheduler's ``cache_mode="kv"``)
runs the host-driven round instead (``_block_cached``,
``engine_cached.py:884-1041``): L drafter sweeps over the arena, each
fetching the live rows' drafted tokens to the host; one stacked verify
chunk; block verification per request with the config's backend
(``legacy`` included), one fetch each; the rollback gather; and a
catch-up sweep only when some slot accepted all L drafts.  It gives the
fused round's tokens.  On the card its waits are counted as they
happen: L in the sweeps (``num_draft_syncs``), and each request's
verification (its ``verify_syncs``).

Quantized serving (``SpecDecConfig.quant``, ``engine_cached.py:384-392``):
the pool holds int8 arenas (quantize-on-write, dequantize-in-kernel
reads) and both rounds' verify chunk runs the target's W8A8 tree
(``serving.quant.quantize_params``, quantized once here); admission
prefill keeps the float32 target tree and the drafter stays float32.

Paged arenas (``SpecDecConfig.paged``, DESIGN.md §12): the pool is a
``PagedCachePool`` (``pool_pages``: a fixed page budget, or None to
grow on demand).  The fused round runs the unchanged contiguous program
on a persistent contiguous VIEW of the pages (``_fused_view``): gathered
once, mutated in place by every later round, written back to the pages
per slot only at events (a suspend, a switch to the host-driven round,
buffer growth), so the steady-state round pays no paging cost.  The
host-driven round and admission without a view run the ``*_slots_paged``
calls, which gather each layer's view through the table and scatter it
back around the layer.  The v2 scheduler's capacity oracle
(``page_state``, ``request_pages``, ``held_pages``) and its eviction
calls (``evict``, ``suspend``/``resume``: a request's pages detach into
a handle and re-attach to any free slot, no KV copy) live here.

Tensor parallelism is a later slice (ROADMAP).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch import random as R
from repro_torch.device import SyncCounter, resolve_device, to_device
from repro_torch.models import (
    CachePool,
    PagedCachePool,
    decode_step_slots,
    decode_step_slots_paged,
    init_cache,
    prefill,
    prefill_slots,
    prefill_slots_paged,
    verify_step_slots,
    verify_step_slots_paged,
)
from repro_torch.models import paged as paged_kv
from repro_torch.specdec import verify as V
from repro_torch.specdec.block_verify import (
    RS_STRATEGIES,
    block_verify_batched,
    run_block_verify,
)
from repro_torch.specdec.engine import (
    BlockOutcome,
    GenerationStats,
    SpecDecConfig,
    block_randomness,
    probs_from_logits,
)

_MIN_BUCKET = 16


class GuardViolation(AssertionError):
    """A round's packed fetch violates a serving invariant (the port's
    copy of ``repro/serving/guard.py::GuardViolation``)."""

    def __init__(self, msg: str, uid=None):
        super().__init__(msg)
        self.uid = uid


def check_packed(host: dict, slot_uids: Sequence, vocab: int,
                 draft_len: int) -> None:
    """Validate a fused round's packed fetch per advancing session
    (``serving/guard.py::check_packed``): token ids in [0, vocab),
    ``0 <= accepted <= L``, and the rollback invariant (accepted > 0
    implies some active row)."""
    for uid, slot in slot_uids:
        acc = int(host["accepted"][slot])
        if not 0 <= acc <= draft_len:
            raise GuardViolation(
                f"uid {uid}: packed accepted={acc} outside "
                f"[0, {draft_len}]", uid=uid)
        toks = np.asarray(host["tokens"][slot][:acc + 1])
        if toks.size and (int(toks.min()) < 0 or int(toks.max()) >= vocab):
            raise GuardViolation(
                f"uid {uid}: packed fetch: token ids outside [0, {vocab}) "
                f"(range [{int(toks.min())}, {int(toks.max())}])", uid=uid)
        if acc > 0 and not np.asarray(host["active"][slot]).any():
            raise GuardViolation(
                f"rollback invariant violated: num_accepted={acc} "
                "but no draft row is active", uid=uid)


def _max_bucket(buf_len: int) -> int:
    """Largest admission bucket: the largest power of two <= buf_len,
    floored at _MIN_BUCKET."""
    b = _MIN_BUCKET
    while b * 2 <= buf_len:
        b *= 2
    return b


def _bucket_plan(n: int, max_bucket: int) -> list:
    """Chunk an n-token prefill into ``[(offset, length, bucket), ...]``:
    full ``max_bucket`` chunks first, then the remainder in the smallest
    power-of-two bucket that holds it."""
    chunks = []
    off = 0
    while n - off > max_bucket:
        chunks.append((off, max_bucket, max_bucket))
        off += max_bucket
    rem = n - off
    if rem > 0:
        bucket = _MIN_BUCKET
        while bucket < rem:
            bucket *= 2
        chunks.append((off, rem, bucket))
    return chunks


def _select_rollback_row(active: np.ndarray, num_accepted: int) -> int:
    """The surviving draft row of a host-verified block
    (``engine_cached.py:143``): row 0 when no draft was accepted (every
    row holds the shared pending token), else the first active row; an
    accepted draft with no active row is a verifier fault and raises."""
    active = np.asarray(active)
    if num_accepted <= 0:
        return 0
    hits = np.flatnonzero(active)
    if hits.size == 0:
        raise AssertionError(
            f"rollback invariant violated: num_accepted={num_accepted} "
            "but no draft row is active")
    return int(hits[0])


def build_round_core(cfg: SpecDecConfig, t_cfg, d_cfg, vocab: int,
                     num_slots: int):
    """The fused speculative round (``engine_cached.py:164-297``):

    ``(t_params, d_params, t_kv, d_kv, pos, pending, live, subs) ->
    (new_pos, packed)``

    ``t_kv``/``d_kv`` are updated in place.  ``pos`` (S,) int32,
    ``pending`` (S,), ``live`` (S,) bool and ``subs`` (S, 2) keys are
    device tensors.  ``packed`` is one (S, L+1 + 1 + K + 1) int64 tensor
    holding tokens | accepted | active | new_pos, so the caller's fetch
    is a single transfer.  Each phase runs under a ``round/<phase>``
    profiler range (``launch/profile_round.py`` reads them; a range costs
    about a microsecond of host time when no profiler is active)."""
    K, L, N = cfg.num_drafts, cfg.draft_len, vocab
    S = num_slots
    rows = S * K
    # The rejection-sampling verifiers read the drafter's distributions:
    # (S, K, L, N) floats, kept only for them.
    need_probs = cfg.strategy in RS_STRATEGIES

    def round_core(t_params, d_params, t_kv, d_kv, pos, pending, live,
                   subs):
        dev = pos.device
        slot_of = torch.arange(S, device=dev).repeat_interleave(K)
        row_ids = torch.arange(rows, device=dev)
        pos = pos.to(torch.int64)
        live_row = live.repeat_interleave(K)
        # Rows of slots not advancing this round ride along as dead rows
        # at their own position (free slots sit at 0); their writes land
        # where the next real round or admission overwrites them.
        row_pos = pos.repeat_interleave(K)
        zero = torch.zeros((), dtype=torch.int64, device=dev)
        with record_function("round/randomness"):
            log_u, strat_keys = block_randomness(subs, L, K, N)

        with record_function("round/draft_sweep"):
            # L decode steps; the drafted tokens stay on the device.
            cur = torch.where(live_row,
                              pending.to(torch.int64).repeat_interleave(K),
                              zero)
            cur0 = cur
            toks, p_steps = [], []
            for j in range(L):
                logits = decode_step_slots(d_params, d_cfg, cur[:, None],
                                           d_kv, row_pos + j,
                                           use_kernel=cfg.decode_kernel)
                p_all = probs_from_logits(logits, cfg.temps[0],
                                          cfg.top_k, N)
                tok = V.draft_token_from_uniforms(
                    log_u[:, j].reshape(rows, N), p_all)
                cur = torch.where(live_row, tok, zero)
                toks.append(cur)
                if need_probs:
                    p_steps.append(p_all)
            toks = torch.stack(toks, dim=1)              # (rows, L)
            d_tokens = toks.reshape(S, K, L)
            d_probs = (torch.stack(p_steps, dim=1).reshape(S, K, L, N)
                       if need_probs else None)

        with record_function("round/verify_chunk"):
            # ONE stacked target verify chunk over the arena.
            chunk = torch.cat([cur0[:, None], toks], dim=1)
            t_logits = verify_step_slots(t_params, t_cfg, chunk, t_kv,
                                         row_pos)
            q = probs_from_logits(t_logits, cfg.target_temp, cfg.top_k,
                                  N).reshape(S, K, L + 1, N)

        with record_function("round/block_verify"):
            # Algorithm 2, batched over slots.
            res = block_verify_batched(log_u, d_tokens, d_probs, q,
                                       strat_keys, strategy=cfg.strategy,
                                       backend=cfg.verifier_backend)
            a = torch.where(live, res.num_accepted, zero)
            k_star = torch.where(
                a > 0, torch.argmax(res.active.to(torch.uint8), dim=1), zero)

        with record_function("round/rollback"):
            # Every row of a live slot becomes its surviving row.
            surv = slot_of * K + k_star[slot_of]
            row_src = torch.where(live_row, surv, row_ids)
            for arena in (t_kv, d_kv):
                for leaf in arena.values():
                    leaf.copy_(leaf.index_select(1, row_src))
            new_pos = torch.where(live, pos + 1 + a, pos)

        with record_function("round/catch_up"):
            # Fully accepted slots write Y_L at pos + L; every other row
            # decodes a dummy token at its post-rollback position, which
            # the next sweep overwrites before it is read.
            full = live & (a == L)
            y_l = res.tokens[:, L - 1]
            extra_tok = torch.where(full[slot_of], y_l[slot_of], zero)
            extra_pos = torch.where(full, pos + L, new_pos)
            decode_step_slots(d_params, d_cfg, extra_tok[:, None], d_kv,
                              extra_pos.repeat_interleave(K),
                              use_kernel=cfg.decode_kernel,
                              return_logits=False)

        packed = torch.cat([res.tokens, a[:, None],
                            res.active.to(torch.int64), new_pos[:, None]],
                           dim=1)
        return new_pos.to(torch.int32), packed

    return round_core


def unpack(packed: np.ndarray, draft_len: int, num_drafts: int) -> dict:
    L, K = draft_len, num_drafts
    return {"tokens": packed[:, :L + 1],
            "accepted": packed[:, L + 1],
            "active": packed[:, L + 2:L + 2 + K].astype(bool),
            "pos": packed[:, L + 2 + K]}


@dataclasses.dataclass
class _Session:
    uid: object
    slot: int
    pending: int                 # last emitted token, not yet in cache


class CachedSpecDecEngine:
    """Multi-request speculative decoding with persistent KV caches and
    fused rounds.  ``target``/``drafter`` are ``(params, ModelConfig)``
    pairs whose tensors live on ``device`` (``None`` = the card)."""

    def __init__(self, target: tuple, drafter: tuple, cfg: SpecDecConfig,
                 pool_slots: int = 1, batched_admission: bool = True,
                 pool_pages: Optional[int] = None, device=None):
        self.device = resolve_device(device)
        self.t_params, self.t_cfg = target
        self.d_params, self.d_cfg = drafter
        for params in (self.t_params, self.d_params):
            if params["embed"].device.type != self.device.type:
                raise ValueError(
                    f"parameters live on {params['embed'].device}, the "
                    f"engine on {self.device}")
        # One drafter and one draft temperature: the sweep scores every
        # lane with cfg.temps[0] (``engine_cached.py:347-351``).
        assert len(set(cfg.temps)) == 1, (
            "CachedSpecDecEngine requires homogeneous draft temperatures; "
            "use the reference SpecDecEngine for the diverse-drafts setup")
        self.cfg = cfg
        self.vocab = self.t_cfg.vocab_size
        # The W8A8 target tree feeds only the rounds' verify chunk.
        self._t_verify_params = self.t_params
        if cfg.quant:
            from repro_torch.serving.quant import quantize_params
            self._t_verify_params = quantize_params(self.t_params)
        self.pool_slots = pool_slots
        # A paged pool's page budget: None grows on demand, an int is a
        # hard budget the v2 scheduler accounts against (``page_state``).
        self.pool_pages = pool_pages
        # The paged kv_fused round's persistent contiguous view of the
        # pages ({model: {leaf: (layers, rows, H, buf_len, d)}}), and the
        # slots whose view rows are newer than their pages.
        self._fused_view: Optional[dict] = None
        self._view_dirty: set = set()
        # The default admission path: bucketed waves, or per-request
        # ``admit`` (the scheduler passes its own per call).
        self.batched_admission = batched_admission
        self.pool: Optional[CachePool] = None
        self._sessions: dict = {}
        self._round = None
        # Serving instrumentation (read by the scheduler / chip_smoke).
        self.num_target_forwards = 0
        self.num_draft_forwards = 0
        self.num_prefill_dispatches = 0
        # Host waits for draft tokens: on the card those seen while a
        # fused round and its admissions are queued (0) or in the kv
        # round's sweeps (L); on the CPU the kv round's fetches.
        self.num_draft_syncs = 0
        # Paged fused view events: whole-view gathers, and slots written
        # back to the pages (``_view_sync``) or refreshed from them.
        self.num_view_gathers = 0
        self.num_view_syncs = 0
        self.num_view_refreshes = 0

    # -- pool / session lifecycle ------------------------------------------
    def _ensure_pool(self, buf_len: int) -> CachePool:
        if self.pool is None:
            cfgs = {"target": self.t_cfg, "drafter": self.d_cfg}
            kw = dict(num_slots=self.pool_slots,
                      rows_per_slot=self.cfg.num_drafts, buf_len=buf_len,
                      device=self.device, quant=self.cfg.quant)
            if self.cfg.paged:
                self.pool = PagedCachePool(cfgs, page_size=self.cfg.page_size,
                                           num_pages=self.pool_pages, **kw)
            else:
                self.pool = CachePool(cfgs, **kw)
        else:
            if buf_len > self.pool.buf_len:
                # The paged view has the old length: write it back first.
                self._view_commit()
            self.pool.ensure_buf(buf_len)
        return self.pool

    @property
    def _paged(self) -> bool:
        return isinstance(self.pool, PagedCachePool)

    def release(self, uid) -> None:
        sess = self._sessions.pop(uid)
        self._view_dirty.discard(sess.slot)
        self.pool.release(sess.slot)

    # -- the model calls on the pool's storage -------------------------------
    # ``engine_cached.py:337-366``'s paged jits as plain calls: the paged
    # pool's pages and device table, or the contiguous arenas; all write
    # in place.

    def _d_step(self, tokens: torch.Tensor, pos: torch.Tensor,
                return_logits: bool = True):
        pool, uk = self.pool, self.cfg.decode_kernel
        if self._paged:
            return decode_step_slots_paged(
                self.d_params, self.d_cfg, tokens, pool.pages["drafter"],
                pool.pt_device(), pos, buf_len=pool.buf_len, use_kernel=uk,
                return_logits=return_logits)
        return decode_step_slots(self.d_params, self.d_cfg, tokens,
                                 pool.caches["drafter"], pos, use_kernel=uk,
                                 return_logits=return_logits)

    def _t_verify(self, tokens: torch.Tensor, pos: torch.Tensor):
        pool = self.pool
        if self._paged:
            return verify_step_slots_paged(
                self._t_verify_params, self.t_cfg, tokens,
                pool.pages["target"], pool.pt_device(), pos,
                buf_len=pool.buf_len)
        return verify_step_slots(self._t_verify_params, self.t_cfg, tokens,
                                 pool.caches["target"], pos)

    def _slot_prefill(self, name: str, tokens: torch.Tensor, pos, write,
                      use_view: bool) -> None:
        """One stacked admission prefill of model ``name``: into the
        paged view when it is live, through the page table otherwise, or
        into the contiguous arena."""
        pool = self.pool
        params, mcfg = ((self.t_params, self.t_cfg) if name == "target"
                        else (self.d_params, self.d_cfg))
        uk = self.cfg.prefill_kernel
        if use_view:
            prefill_slots(params, mcfg, tokens, self._fused_view[name], pos,
                          write, use_kernel=uk)
        elif self._paged:
            prefill_slots_paged(params, mcfg, tokens, pool.pages[name],
                                pool.pt_device(), pos, write,
                                buf_len=pool.buf_len, use_kernel=uk)
        else:
            prefill_slots(params, mcfg, tokens, pool.caches[name], pos, write,
                          use_kernel=uk)

    # -- the paged fused view (``engine_cached.py:368-423``) -----------------
    # The fused round never pays a per-round gather or scatter: the first
    # paged fused round gathers ONE contiguous working set, and every
    # later round runs the contiguous program on it.  The pages must be
    # current only when something other than the fused round reads them
    # (a suspend detaching a slot's chains, the host-driven round, buffer
    # growth), so they are written per slot, at those events.

    def _view_sync(self, slots) -> None:
        """Write the listed dirty slots' view rows into the pages through
        their table rows (other slots' pages stay untouched)."""
        if self._fused_view is None:
            return
        pool = self.pool
        for slot in sorted(set(slots) & self._view_dirty):
            rows = slice(slot * pool.rows_per_slot,
                         (slot + 1) * pool.rows_per_slot)
            for name, view in self._fused_view.items():
                paged_kv.scatter_arena(
                    pool.pages[name], pool.slot_table(slot),
                    {kk: leaf[:, rows] for kk, leaf in view.items()})
            self._view_dirty.discard(slot)
            self.num_view_syncs += 1

    def _view_refresh(self, slots) -> None:
        """Gather the listed slots' rows from the pages into the view
        (after a prefill or a resumed handle wrote pages behind it)."""
        if self._fused_view is None:
            return
        pool = self.pool
        for slot in sorted(set(slots)):
            rows = slice(slot * pool.rows_per_slot,
                         (slot + 1) * pool.rows_per_slot)
            for name, view in self._fused_view.items():
                sub = paged_kv.gather_arena(pool.pages[name],
                                            pool.slot_table(slot),
                                            pool.buf_len)
                for kk, leaf in view.items():
                    leaf[:, rows].copy_(sub[kk])
            self._view_dirty.discard(slot)
            self.num_view_refreshes += 1

    def _view_commit(self) -> None:
        """Write every dirty slot back to the pages and drop the view."""
        if self._fused_view is not None:
            self._view_sync(set(self._view_dirty))
            self._fused_view = None
        self._view_dirty.clear()

    # -- the v2 scheduler's capacity oracle (``engine_cached.py:564-614``) --
    def has_session(self, uid) -> bool:
        return uid in self._sessions

    def evict(self, uid) -> None:
        """Drop a live session mid-generation and return its slot (and
        pages).  The caller re-admits it later with its whole prompt +
        output prefix: per-request randomness depends only on (uid,
        blocks), so the stream continues as if uninterrupted."""
        self.release(uid)

    def can_suspend(self) -> bool:
        """Whether preemption can keep the KV resident (paged pools)."""
        return bool(self.cfg.paged)

    def suspend(self, uid) -> dict:
        """Preempt without forfeiting the KV: pop the session and detach
        its chains into a handle (the slot frees; ``resume`` re-binds the
        same pages to any free slot).  Under the fused view the slot's
        pages may be stale, so its view rows are written back first."""
        sess = self._sessions.pop(uid)
        self._view_sync({sess.slot})
        handle = self.pool.detach(sess.slot)
        handle["pending"] = sess.pending
        return handle

    def resume(self, uid, handle: dict) -> int:
        """Re-admit a suspended request from its handle."""
        assert uid not in self._sessions
        slot = self.pool.alloc()
        self.pool.attach(slot, handle)
        self._view_refresh({slot})
        self._sessions[uid] = _Session(uid=uid, slot=slot,
                                       pending=int(handle["pending"]))
        return slot

    def handle_pages(self, handle: dict) -> int:
        """Physical pages a suspend handle holds."""
        return int(handle["chain_len"]) * self.pool.rows_per_slot

    def drop_handle(self, handle: dict) -> None:
        """Forfeit a handle's pages (its request re-admits through a
        re-prefill, like an evicted one)."""
        self.pool.release_handle(handle)

    def page_state(self) -> Optional[dict]:
        """{free, total, fixed} page accounting, None when not paged;
        before the pool exists the whole budget is free."""
        if not self.cfg.paged:
            return None
        if self.pool is not None:
            return {"free": self.pool.free_pages,
                    "total": self.pool.num_pages,
                    "fixed": self.pool.fixed_budget}
        if self.pool_pages is None:
            return {"free": None, "total": None, "fixed": False}
        return {"free": self.pool_pages, "total": self.pool_pages,
                "fixed": True}

    def request_pages(self, prefix_len: int) -> int:
        """Pages a request at prefix length ``prefix_len`` holds after
        its next round: every round reserves ``pos + L + 1`` positions
        across its K lanes."""
        per_row = -(-(prefix_len + self.cfg.draft_len + 1)
                    // self.cfg.page_size)
        return per_row * self.cfg.num_drafts

    def held_pages(self, uid) -> int:
        if self.pool is None or uid not in self._sessions:
            return 0
        return self.pool.held_pages(self._sessions[uid].slot)

    def admit(self, uid, prompt: np.ndarray, buf_len: int) -> int:
        """Per-request admission (``engine_cached.py:757``): a slot, and
        both models' dense ``prefill`` of the prompt minus its last token
        (the first pending token) into a temporary K-row cache, installed
        by ``CachePool.write_prefill``."""
        assert uid not in self._sessions
        prompt = np.asarray(prompt, np.int32)
        assert len(prompt) >= 1
        pool = self._ensure_pool(buf_len)
        slot = pool.alloc()
        k = self.cfg.num_drafts
        toks = to_device(np.repeat(prompt[None, :-1], k, axis=0),
                         self.device)
        with record_function("admission/prefill"):
            for name, params, mcfg in (
                    ("target", self.t_params, self.t_cfg),
                    ("drafter", self.d_params, self.d_cfg)):
                cache = init_cache(mcfg, k, pool.buf_len, self.device)
                _, cache = prefill(params, mcfg, {"tokens": toks}, cache)
                pool.write_prefill(name, slot, cache, pos=len(prompt) - 1)
                self.num_prefill_dispatches += 1
        self._view_refresh({slot})
        self._sessions[uid] = _Session(uid=uid, slot=slot,
                                       pending=int(prompt[-1]))
        return slot

    def admit_batch(self, pairs, buf_len: int) -> None:
        """Bucketed batched admission (``engine_cached.py:783``): each
        ``(uid, prompt)`` gets a slot; prompts minus their last token
        (which becomes the pending token) prefill straight into the
        arenas, one stacked ``prefill_slots`` per (chunk round, bucket)
        per model, rows outside the group write-masked.  A paged pool
        reserves each prompt's chains first; its prefills go into the
        fused view when one is live (the admitted slots become dirty),
        else through the page table."""
        pairs = [(uid, np.asarray(p, np.int32)) for uid, p in pairs]
        if not pairs:
            return
        pool = self._ensure_pool(buf_len)
        rows_n = pool.num_slots * self.cfg.num_drafts
        max_bucket = _max_bucket(pool.buf_len)
        plans = []
        for uid, prompt in pairs:
            assert uid not in self._sessions
            assert len(prompt) >= 1
            slot = pool.alloc()
            self._sessions[uid] = _Session(uid=uid, slot=slot,
                                           pending=int(prompt[-1]))
            if self._paged:
                pool.reserve(slot, len(prompt) - 1)
            plans.append((slot, prompt[:-1],
                          _bucket_plan(len(prompt) - 1, max_bucket)))
        use_view = self._fused_view is not None
        with record_function("admission/prefill"):
            self._prefill_plans(plans, rows_n, use_view)
        for slot, toks, _ in plans:
            pool.set_pos(slot, len(toks))
        if use_view:
            self._view_dirty.update(slot for slot, _, _ in plans)

    def _prefill_plans(self, plans, rows_n: int, use_view: bool) -> None:
        """One stacked prefill_slots per (chunk round, bucket) per model."""
        pool = self.pool
        for c in range(max(len(p[2]) for p in plans)):
            groups = {}
            for slot, toks, chunks in plans:
                if c < len(chunks):
                    groups.setdefault(chunks[c][2], []).append(
                        (slot, toks, chunks[c]))
            for bucket in sorted(groups):
                tok = np.zeros((rows_n, bucket), np.int32)
                pos = np.zeros((rows_n,), np.int64)
                write = np.zeros((rows_n,), bool)
                for slot, toks, (off, ln, _) in groups[bucket]:
                    rr = pool.rows_of(slot)
                    tok[rr, :ln] = toks[off:off + ln]
                    pos[rr] = off
                    write[rr] = True
                tok_d = to_device(tok, self.device)
                for name in ("target", "drafter"):
                    self._slot_prefill(name, tok_d, pos, write, use_view)
                    self.num_prefill_dispatches += 1

    # -- the host-driven round ----------------------------------------------
    def _block_cached(self, subs: Sequence[torch.Tensor],
                      uids: Sequence) -> list:
        """Advance every listed session one block, host-driven
        (``engine_cached.py:884``): L drafter sweeps over the arena (one
        fetch of the live rows' tokens a step), ONE stacked verify chunk,
        block verification per request (one fetch each), the rollback
        gather, and the catch-up sweep for slots that accepted all L
        drafts.  Host arrays go up through ``to_device``: a blocking copy
        would make the host wait for the queued round."""
        cfg, pool, dev = self.cfg, self.pool, self.device
        K, L, N = cfg.num_drafts, cfg.draft_len, self.vocab
        S = pool.num_slots
        sessions = [self._sessions[u] for u in uids]
        r_n = len(sessions)
        need_probs = cfg.strategy in RS_STRATEGIES
        on_card = dev.type == "cuda"

        keys = np.stack([np.asarray(s.cpu(), np.int64) for s in subs])
        with record_function("round/randomness"):
            log_u_all, strat = block_randomness(to_device(keys, dev), L, K,
                                                N)     # (R, L+1, K, N)
        live_rows = np.concatenate([pool.rows_of(s.slot) for s in sessions])
        live_dev = to_device(live_rows.astype(np.int64), dev)
        base_pos = pool.pos.copy()
        row_pos0 = to_device(pool.row_positions().astype(np.int64), dev)
        # The verify chunk writes [pos, pos + L] into non-ring arenas.
        hi = max(base_pos[s.slot] for s in sessions) + L + 1
        assert hi <= pool.buf_len, (
            f"speculative block would write through position {hi - 1} but "
            f"the cache arena holds {pool.buf_len}; pass a larger buf_len")
        if self._paged:
            # The paged calls read and write the pages: write back a
            # fused view first, then extend every advancing slot's chains
            # through the round's writes ([pos, pos + L], the catch-up).
            self._view_commit()
            for sess in sessions:
                pool.reserve(sess.slot, int(base_pos[sess.slot]) + L + 1)

        cur = np.zeros((S * K, 1), np.int64)
        for sess in sessions:
            cur[pool.rows_of(sess.slot)] = sess.pending
        d_tokens = np.zeros((r_n, K, L), np.int64)
        tok_steps, prob_steps = [], []
        with SyncCounter(dev) as drafting, \
                record_function("round/draft_sweep"):
            for j in range(L):
                logits = self._d_step(to_device(cur, dev), row_pos0 + j)
                self.num_draft_forwards += 1
                p_all = probs_from_logits(logits[live_dev], cfg.temps[0],
                                          cfg.top_k, N)
                tok = V.draft_token_from_uniforms(
                    log_u_all[:, j].reshape(r_n * K, N), p_all)
                tk = tok.cpu().numpy().reshape(r_n, K)   # 1 fetch a step
                d_tokens[:, :, j] = tk
                cur = np.zeros((S * K, 1), np.int64)
                for r, sess in enumerate(sessions):
                    cur[pool.rows_of(sess.slot), 0] = tk[r]
                tok_steps.append(tok)
                if need_probs:
                    prob_steps.append(p_all)
        self.num_draft_syncs += drafting.count if on_card else L
        # The drafts stay on the device too, so the device verifiers
        # take them without an upload.
        d_tok_dev = torch.stack(tok_steps, dim=1).reshape(r_n, K, L)
        d_probs = (torch.stack(prob_steps, dim=1).reshape(r_n, K, L, N)
                   if need_probs else None)

        with SyncCounter(dev) as rest:
            with record_function("round/verify_chunk"):
                chunk = np.zeros((S * K, L + 1), np.int64)
                for r, sess in enumerate(sessions):
                    chunk[pool.rows_of(sess.slot), 0] = sess.pending
                    chunk[pool.rows_of(sess.slot), 1:] = d_tokens[r]
                t_logits = self._t_verify(to_device(chunk, dev), row_pos0)
                self.num_target_forwards += 1
                q = probs_from_logits(t_logits[live_dev], cfg.target_temp,
                                      cfg.top_k, N).reshape(r_n, K, L + 1, N)

            outs = []
            row_src = np.arange(S * K)
            full_slots = {}          # slot -> Y_L, for the catch-up
            with record_function("round/block_verify"):
                for r, sess in enumerate(sessions):
                    drafts = (d_tokens[r] if cfg.verifier_backend == "legacy"
                              else d_tok_dev[r])
                    with SyncCounter(dev) as fetch:
                        hb = run_block_verify(
                            log_u_all[r], drafts,
                            None if d_probs is None else d_probs[r], q[r],
                            strat[r], strategy=cfg.strategy,
                            backend=cfg.verifier_backend)
                    a = hb.num_accepted
                    rows = pool.rows_of(sess.slot)
                    row_src[rows] = rows[0] + _select_rollback_row(
                        hb.active, a)
                    pool.set_pos(sess.slot, base_pos[sess.slot] + 1 + a)
                    if a == L:
                        # The drafter consumed [pending, d_1..d_{L-1}]:
                        # Y_L goes in at base_pos + L in the catch-up.
                        full_slots[sess.slot] = hb.new_tokens[L - 1]
                    sess.pending = hb.new_tokens[-1]
                    outs.append(BlockOutcome(
                        new_tokens=hb.new_tokens, accepted=a,
                        verify_syncs=fetch.count if on_card
                        else hb.host_syncs,
                        active=hb.active))

            with record_function("round/rollback"):
                pool.rollback_rows(row_src)

            if full_slots:
                # Every other row decodes a dummy token at its
                # post-rollback position, where the next sweep writes its
                # pending token before anything attends it.
                with record_function("round/catch_up"):
                    extra_tok = np.zeros((S * K, 1), np.int64)
                    extra_pos = pool.row_positions().astype(np.int64)
                    for slot, y_l in full_slots.items():
                        rows = pool.rows_of(slot)
                        extra_tok[rows, 0] = y_l
                        extra_pos[rows] = base_pos[slot] + L
                    self._d_step(to_device(extra_tok, dev),
                                 to_device(extra_pos, dev),
                                 return_logits=False)
                    self.num_draft_forwards += 1
        if rest.count:
            # Waits outside the per-request fetches (none are expected)
            # are charged to the round's first outcome.
            outs[0] = outs[0]._replace(
                verify_syncs=outs[0].verify_syncs + rest.count)
        return outs

    # -- the fused round -----------------------------------------------------
    def _block_fused(self, subs: Sequence[torch.Tensor], uids: Sequence,
                     admits: Sequence = ()) -> list:
        """Advance every listed session one round; the round's only
        device-to-host transfer is the packed fetch.  ``admits`` are
        prefilled after the round is queued and before that fetch."""
        cfg, pool = self.cfg, self.pool
        K, L = cfg.num_drafts, cfg.draft_len
        sessions = [self._sessions[u] for u in uids]
        with SyncCounter(self.device) as queued:
            packed = self._queue_round(sessions, subs, admits)
        self.num_draft_syncs += queued.count
        with SyncCounter(self.device) as fetched, \
                record_function("round/fetch"):
            host = unpack(packed.cpu().numpy(), L, K)   # the ONE transfer
        # On the CPU the fetch is a copy the host never waits for.
        syncs = fetched.count if self.device.type == "cuda" else 1
        pool.refresh_pos_host(host["pos"], [s.slot for s in sessions])
        check_packed(host, [(s.uid, s.slot) for s in sessions],
                     vocab=self.vocab, draft_len=L)
        outs = []
        for i, sess in enumerate(sessions):
            s = sess.slot
            acc = int(host["accepted"][s])
            toks = [int(t) for t in host["tokens"][s][:acc + 1]]
            sess.pending = toks[-1]
            # The packed fetch serves the whole round; its waits go to
            # the first outcome.
            outs.append(BlockOutcome(new_tokens=toks, accepted=acc,
                                     verify_syncs=syncs if i == 0 else 0,
                                     active=host["active"][s].copy()))
        return outs

    def _queue_round(self, sessions, subs, admits) -> torch.Tensor:
        """Build the round's inputs, queue the fused round and the
        admission prefills; returns the device-side packed result."""
        cfg, pool = self.cfg, self.pool
        L, S = cfg.draft_len, pool.num_slots
        hi = max(pool.pos[s.slot] for s in sessions) + L + 1
        assert hi <= pool.buf_len, (
            f"speculative block would write through position {hi - 1} but "
            f"the cache arena holds {pool.buf_len}; pass a larger buf_len")
        if self._paged:
            # Each advancing slot's chains cover the round's writes; the
            # first paged fused round gathers the view, later ones mutate
            # it in place (``engine_cached.py:1105-1160``).
            for sess in sessions:
                pool.reserve(sess.slot, int(pool.pos[sess.slot]) + L + 1)
            if self._fused_view is None:
                pt = pool.pt_device()
                self._fused_view = {
                    name: paged_kv.gather_arena(pool.pages[name], pt,
                                                pool.buf_len)
                    for name in ("target", "drafter")}
                self._view_dirty.clear()
                self.num_view_gathers += 1
            arenas = self._fused_view
        else:
            arenas = pool.caches
        live = np.zeros(S, bool)
        pending = np.zeros(S, np.int64)
        # Free slots still need a valid key; their draws are masked.
        sub_rows = np.zeros((S, 2), np.int64)
        for sess, sub in zip(sessions, subs):
            live[sess.slot] = True
            pending[sess.slot] = sess.pending
            sub_rows[sess.slot] = np.asarray(sub.cpu(), np.int64)
        if self._round is None:
            if cfg.verifier_backend == "legacy":
                raise ValueError(
                    "fused rounds need a device verifier backend ('torch' "
                    "or 'kernel'); the 'legacy' host loop cannot run "
                    "in-program")
            self._round = build_round_core(cfg, self.t_cfg, self.d_cfg,
                                           self.vocab, S)
        pos_dev, packed = self._round(
            self._t_verify_params, self.d_params, arenas["target"],
            arenas["drafter"], pool.pos_device(),
            to_device(pending, self.device), to_device(live, self.device),
            to_device(sub_rows, self.device))
        self.num_target_forwards += 1
        self.num_draft_forwards += L + 1
        pool.adopt_round_device(pos_dev)
        if self._paged:
            self._view_dirty.update(s.slot for s in sessions)
        if admits:
            self.admit_batch(admits, pool.buf_len)
        return packed

    # -- scheduler contract ----------------------------------------------
    def round_with_admission(self, subs, uids, admits, buf_len: int,
                             tails: Optional[Sequence[int]] = None) -> list:
        """One kv_fused serving round with overlapped admission
        (``engine_cached.py:1204``): grow the pool for the whole wave,
        queue the fused round for ``uids``, queue the bucketed prefills
        for ``admits``, then fetch.  Admitted sessions join next round."""
        self._ensure_pool(buf_len)
        if tails is not None:
            for uid, tail in zip(uids, tails):
                sess = self._sessions[uid]
                assert int(tail) == sess.pending, (
                    f"uid {uid}: prefix tail {int(tail)} != cached "
                    f"pending {sess.pending}")
        if not uids:
            with SyncCounter(self.device) as queued:
                self.admit_batch(admits, buf_len)
            self.num_draft_syncs += queued.count
            return []
        return self._block_fused(subs, uids, admits=admits)

    def _admit_wave(self, pairs, buf_len: int,
                    admission: Optional[str] = None) -> None:
        """Admit unseen sessions (``engine_cached.py:1189``): one
        bucketed wave, or per-request ``admit``; ``admission`` overrides
        the engine's ``batched_admission`` default for this call."""
        if admission is None:
            admission = ("bucketed" if self.batched_admission
                         else "per_request")
        if admission == "bucketed":
            self.admit_batch(pairs, buf_len)
        else:
            for uid, prompt in pairs:
                self.admit(uid, prompt, buf_len)

    def gen_blocks(self, subs: Sequence[torch.Tensor],
                   prefixes: Sequence[np.ndarray], buf_len: int,
                   uids: Optional[Sequence] = None, fused: bool = False,
                   admission: Optional[str] = None) -> list:
        """Advance R requests one block each (``engine_cached.py:1230``),
        the reference engine's scheduler contract.  With ``uids`` the
        sessions persist in pool slots: unseen uids are admitted from
        their prefixes, known ones continue from their cached state and
        ``prefixes[i]`` must end in the session's pending token.  Without
        ``uids`` each call admits and releases ephemeral sessions.
        ``fused`` runs the fused round, else the host-driven one."""
        block = self._block_fused if fused else self._block_cached
        if uids is None:
            ephemeral = [object() for _ in prefixes]
            try:
                self._admit_wave(list(zip(ephemeral, prefixes)), buf_len,
                                 admission)
                return block(subs, ephemeral)
            finally:
                for uid in ephemeral:
                    if uid in self._sessions:
                        self.release(uid)
        self._ensure_pool(buf_len)
        new = []
        for uid, pre in zip(uids, prefixes):
            pre = np.asarray(pre, np.int32)
            if uid not in self._sessions:
                new.append((uid, pre))
            else:
                sess = self._sessions[uid]
                assert int(pre[-1]) == sess.pending, (
                    f"uid {uid}: prefix tail {int(pre[-1])} != cached "
                    f"pending {sess.pending}")
        self._admit_wave(new, buf_len, admission)
        return block(subs, uids)

    def gen_block(self, key: torch.Tensor, prefix: np.ndarray, buf_len: int,
                  uid=None, fused: bool = False) -> BlockOutcome:
        """The R = 1 case of ``gen_blocks``."""
        uids = None if uid is None else [uid]
        return self.gen_blocks([key], [np.asarray(prefix, np.int32)],
                               buf_len, uids=uids, fused=fused)[0]

    def generate(self, key: torch.Tensor, prompt: np.ndarray,
                 max_new: Optional[int] = None,
                 fused: bool = False) -> GenerationStats:
        """Single-request generation (``engine_cached.py:1280``) through
        host-driven or (``fused``) fused rounds, with the JAX engine's
        key derivation (``key, sub = split(key)`` per block)."""
        cfg = self.cfg
        max_new = max_new or cfg.max_new_tokens
        prompt = np.asarray(prompt, np.int32)
        buf = len(prompt) + max_new + cfg.draft_len + 2
        uid = object()
        self._admit_wave([(uid, prompt)], buf)
        block = self._block_fused if fused else self._block_cached
        out, blocks, accepted, syncs = [], 0, 0, 0
        key = key.cpu()
        try:
            while len(out) < max_new:
                key, sub = R.split(key)
                o = block([sub], [uid])[0]
                out.extend(o.new_tokens)
                accepted += o.accepted
                syncs += o.verify_syncs
                blocks += 1
        finally:
            self.release(uid)
        return GenerationStats(output=np.asarray(out[:max_new], np.int32),
                               blocks=blocks, accepted_drafts=accepted,
                               host_syncs=syncs)
