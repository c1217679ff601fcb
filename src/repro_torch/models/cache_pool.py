"""Slot-based KV arena for multi-request cached serving -- the port's
counterpart of ``repro/models/cache_pool.py``: the contiguous arena
(``CachePool``) and the paged one (``PagedCachePool``, DESIGN.md §12),
float32 or int8.

One pool holds, for every model of a serving step (target and drafter),
a ``(layers, num_slots * rows_per_slot, kv_heads, buf_len, head_dim)``
arena.  A request owns one slot = ``rows_per_slot`` consecutive rows
(the K draft lanes).  Contract, as in the JAX pool:

* ``alloc``/``release`` at admission/completion, lowest free slot first;
* per-slot positions live on the host (``pool.pos``), mirrored lazily on
  the device for the fused round (``pos_device``); host lifecycle writes
  touch one device element, and the round hands back its advanced
  positions (``adopt_round_device``), refreshed on the host from the
  round's packed fetch (``refresh_pos_host``);
* ``ensure_buf`` grows every arena's time axis (zero tail);
* the host-driven kv round installs a per-request dense prefill
  (``write_prefill``, quantized on install into an int8 pool) and rolls
  a round back by row replication (``rollback_rows``).

int8 arenas (``quant=True``, ``cache_pool.py:107-117``) hold four
leaves: int8 ``k``/``v`` and float32 per-KV-vector scales ``k_s``/``v_s``
of shape ``(layers, rows, kv_heads, T, 1)``.  The trailing singleton
axis lets every arena op (the rollback's row gather on axis 1, growth
on axis 3) treat all four leaves alike; the slots calls quantize on
write and the attention dequantizes as it reads.

The arenas are updated IN PLACE by the model calls and the fused
round's rollback (the port's stand-in for JAX's donated buffers), so
``pool.caches`` always holds the live tensors.
"""

from __future__ import annotations

import heapq
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.device import to_device
from repro_torch.models import paged as P
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import init_cache


class CachePool:

    def __init__(self, cfgs: Dict[str, ModelConfig], num_slots: int,
                 rows_per_slot: int, buf_len: int, device,
                 quant: bool = False):
        assert num_slots >= 1 and rows_per_slot >= 1
        self.cfgs = dict(cfgs)
        self.num_slots = num_slots
        self.rows_per_slot = rows_per_slot
        self.buf_len = buf_len
        self.device = torch.device(device)
        self.quant = quant
        self.caches = {name: self._init_arena(cfg, buf_len)
                       for name, cfg in self.cfgs.items()}
        self.pos = np.zeros(num_slots, np.int64)
        self._pos_dev = None
        self._free = list(range(num_slots))

    def _init_arena(self, cfg: ModelConfig, buf_len: int) -> dict:
        rows = self.num_slots * self.rows_per_slot
        if not self.quant:
            c = init_cache(cfg, rows, buf_len, self.device)
            return {"k": c["k"], "v": c["v"]}   # positions live host-side
        shape = (cfg.num_layers, rows, cfg.kv_heads, buf_len,
                 cfg.resolved_head_dim)
        arena = {kk: torch.zeros(shape, dtype=torch.int8, device=self.device)
                 for kk in ("k", "v")}
        arena.update({kk: torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                      device=self.device)
                      for kk in ("k_s", "v_s")})
        return arena

    # -- slot lifecycle ----------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free)

    def alloc(self) -> int:
        if not self._free:
            raise RuntimeError(
                f"CachePool: all {self.num_slots} slots in use")
        slot = min(self._free)
        self._free.remove(slot)
        self.set_pos(slot, 0)
        return slot

    def release(self, slot: int) -> None:
        assert 0 <= slot < self.num_slots and slot not in self._free
        self.set_pos(slot, 0)
        self._free.append(slot)

    def set_pos(self, slot: int, pos: int) -> None:
        self.pos[slot] = int(pos)
        if self._pos_dev is not None:
            # fill_ passes the value as a kernel argument; item assignment
            # would make a blocking host-to-device copy (a host sync).
            self._pos_dev[slot].fill_(int(pos))

    def rows_of(self, slot: int) -> np.ndarray:
        r = self.rows_per_slot
        return np.arange(slot * r, (slot + 1) * r)

    # -- buffer growth -----------------------------------------------------
    def ensure_buf(self, buf_len: int) -> None:
        """Grow every arena's time axis to at least ``buf_len``; live KV
        (and an int8 arena's scales) is preserved, the new tail is zero."""
        if buf_len <= self.buf_len:
            return
        for name, cfg in self.cfgs.items():
            fresh = self._init_arena(cfg, buf_len)
            for kk, old in self.caches[name].items():
                fresh[kk][:, :, :, :old.shape[3]].copy_(old)
            self.caches[name] = fresh
        self.buf_len = buf_len

    # -- cache content ops (the host-driven kv round) -----------------------
    def write_prefill(self, name: str, slot: int, cache: dict,
                      pos: int) -> None:
        """Install a dense prefill cache of ``rows_per_slot`` rows, built
        at the pool's ``buf_len`` (``registry.init_cache``/``prefill``),
        into ``slot``'s rows of arena ``name``; ``pos`` is the number of
        prefilled tokens.  An int8 pool quantizes it on install
        (``cache_pool.py:187-205``)."""
        arena = self.caches[name]
        assert cache["k"].shape[3] == self.buf_len, \
            "prefill cache buffer != pool buffer"
        cache = {"k": cache["k"], "v": cache["v"]}
        if self.quant:
            from repro_torch.serving.quant import quantize_kv
            kq, ks = quantize_kv(cache["k"])
            vq, vs = quantize_kv(cache["v"])
            cache = {"k": kq, "v": vq, "k_s": ks, "v_s": vs}
        rows = slice(slot * self.rows_per_slot,
                     (slot + 1) * self.rows_per_slot)
        for kk, leaf in arena.items():
            leaf[:, rows].copy_(cache[kk])
        self.set_pos(slot, pos)

    def rollback_rows(self, row_src: np.ndarray) -> None:
        """Arena-wide row replication: row i of every leaf becomes row
        ``row_src[i]`` (``cache_pool.py:212``).  The gather goes through a
        temporary: in place, row i could read a row ``row_src[i]`` that a
        lower row's copy had already overwritten."""
        assert row_src.shape == (self.num_slots * self.rows_per_slot,)
        idx = to_device(np.asarray(row_src, np.int64), self.device)
        for arena in self.caches.values():
            for leaf in arena.values():
                leaf.copy_(leaf.index_select(1, idx))

    def row_positions(self, default: int = 0) -> np.ndarray:
        """(num_slots * rows_per_slot,) per-row positions for the slot
        calls; free slots get ``default``."""
        per_slot = self.pos.copy()
        for s in self._free:
            per_slot[s] = default
        return np.repeat(per_slot, self.rows_per_slot).astype(np.int32)

    # -- fused-round device state ------------------------------------------
    def pos_device(self) -> torch.Tensor:
        """(num_slots,) int32 device positions for the fused round."""
        if self._pos_dev is None:
            self._pos_dev = to_device(self.pos.astype(np.int32), self.device)
        return self._pos_dev

    def adopt_round_device(self, pos_dev: torch.Tensor) -> None:
        """Adopt a fused round's advanced device positions (its arena
        updates already happened in place).  The host mirror stays stale
        for the advanced slots until ``refresh_pos_host``."""
        self._pos_dev = pos_dev

    def refresh_pos_host(self, pos_host: np.ndarray, slots) -> None:
        for s in slots:
            self.pos[s] = int(pos_host[s])


class PagePoolExhausted(RuntimeError):
    """A fixed-budget paged pool ran out of physical pages
    (``cache_pool.py:324``).  The v2 scheduler budgets pages ahead of
    every round, so this means the caller's accounting is wrong."""


class PagedCachePool(CachePool):
    """Paged slot arena (``cache_pool.py:331``, DESIGN.md §12): the
    contiguous pool's lifecycle and model-facing semantics, with each
    model's KV in fixed-size physical pages ``(layers, num_pages + 2,
    kv_heads, page_size, head_dim)`` (page 0 all zeros, the last page
    the write-only trash page of ``models/paged.py``) behind ONE page
    table ``(rows, n_lp)`` shared by every model: physical page p names
    page p in every model's storage at once.

    Differences from the contiguous pool:

    * ``ensure_buf`` widens the table (unmapped columns): no storage
      copy;
    * storage is reserved per slot as its chain grows (``reserve``;
      ``write_prefill`` reserves the prompt, the engine ``pos + L + 1``
      before each round), so a free slot holds no page and a fixed
      ``num_pages`` budget can hold more slots than pages; exhausting it
      raises ``PagePoolExhausted``.  With ``num_pages=None`` the pool
      starts at the contiguous pool's capacity and at least doubles on
      demand;
    * model calls take ``pool.pages`` and the device table
      (``pt_device``) through the ``*_slots_paged`` calls.  The class
      defines no ``caches``, so code that handles only the contiguous
      pool fails loudly;
    * the rollback replicates chain content page by page
      (``models/paged.py::replicate_rows``); rows keep their pages.

    The page table lives on the host; its device mirror is built lazily
    and then kept current per slot (``_touch_table``), with every upload
    through ``device.to_device`` (no host sync).  ``residency``,
    ``drop_device_mirrors`` and ``scrub`` belong to fault recovery, not
    yet ported.
    """

    def __init__(self, cfgs: Dict[str, ModelConfig], num_slots: int,
                 rows_per_slot: int, buf_len: int, device,
                 quant: bool = False, page_size: int = 64,
                 num_pages: Optional[int] = None):
        assert num_slots >= 1 and rows_per_slot >= 1 and page_size >= 1
        self.cfgs = dict(cfgs)
        self.num_slots = num_slots
        self.rows_per_slot = rows_per_slot
        self.buf_len = buf_len
        self.device = torch.device(device)
        self.quant = quant
        self.page_size = page_size
        self.n_lp = P.n_logical_pages(buf_len, page_size)
        rows = num_slots * rows_per_slot
        self.fixed_budget = num_pages is not None
        self.num_pages = num_pages if self.fixed_budget else rows * self.n_lp
        assert self.num_pages >= 1
        self.pages = {name: self._init_pages(cfg, self.num_pages)
                      for name, cfg in self.cfgs.items()}
        self.page_table = np.zeros((rows, self.n_lp), np.int32)
        self._pt_dev = None
        self._free_pages = list(range(1, self.num_pages + 1))
        heapq.heapify(self._free_pages)        # lowest free page first
        self._chain_len = np.zeros(num_slots, np.int64)
        self.pos = np.zeros(num_slots, np.int64)
        self._pos_dev = None
        self._free = list(range(num_slots))

    def _init_pages(self, cfg: ModelConfig, num_pages: int) -> dict:
        """Zeroed storage of ``num_pages`` pages plus the zero page and
        the trash page."""
        shape = (cfg.num_layers, num_pages + 2, cfg.kv_heads,
                 self.page_size, cfg.resolved_head_dim)
        if not self.quant:
            return {kk: torch.zeros(shape, dtype=cfg.torch_dtype,
                                    device=self.device) for kk in ("k", "v")}
        pages = {kk: torch.zeros(shape, dtype=torch.int8, device=self.device)
                 for kk in ("k", "v")}
        pages.update({kk: torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                      device=self.device)
                      for kk in ("k_s", "v_s")})
        return pages

    # -- page allocation ---------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free_pages)

    def chain_pages(self, n_tokens: int) -> int:
        """Pages ONE row needs to cover ``n_tokens`` positions."""
        return P.n_logical_pages(max(int(n_tokens), 0), self.page_size)

    def held_pages(self, slot: int) -> int:
        """Physical pages ``slot`` owns (all its rows)."""
        return int(self._chain_len[slot]) * self.rows_per_slot

    def reserve(self, slot: int, n_tokens: int) -> None:
        """Extend ``slot``'s chains, every row in lockstep, to cover
        ``n_tokens`` positions (``cache_pool.py:421``); never shrinks.  A
        fixed budget raises ``PagePoolExhausted`` before anything
        changes; an auto-grow pool grows its storage instead."""
        need_lp = self.chain_pages(n_tokens)
        assert need_lp <= self.n_lp, (
            f"reserve({n_tokens}) needs {need_lp} logical pages but the "
            f"table holds {self.n_lp}; grow buf_len first (ensure_buf)")
        have = int(self._chain_len[slot])
        if need_lp <= have:
            return
        want = (need_lp - have) * self.rows_per_slot
        if want > len(self._free_pages):
            if self.fixed_budget:
                raise PagePoolExhausted(
                    f"slot {slot} needs {want} pages, "
                    f"{len(self._free_pages)}/{self.num_pages} free")
            self._grow_pages(want - len(self._free_pages))
        r0 = slot * self.rows_per_slot
        for lp in range(have, need_lp):
            for r in range(r0, r0 + self.rows_per_slot):
                self.page_table[r, lp] = heapq.heappop(self._free_pages)
        self._chain_len[slot] = need_lp
        self._touch_table(slot)

    def _grow_pages(self, min_extra: int) -> None:
        """Grow the storage to at least twice its pages and at least
        ``min_extra`` more (``_grow_pages_leaf``: the old pages copied to
        the front).  Page indices are stable, so the table is untouched;
        the trash page moves to the new end."""
        new_total = max(self.num_pages * 2, self.num_pages + min_extra)
        for name, cfg in self.cfgs.items():
            fresh = self._init_pages(cfg, new_total)
            for kk, old in self.pages[name].items():
                fresh[kk][:, :self.num_pages + 1].copy_(
                    old[:, :self.num_pages + 1])
            self.pages[name] = fresh
        self._free_pages.extend(range(self.num_pages + 1, new_total + 1))
        heapq.heapify(self._free_pages)
        self.num_pages = new_total

    def release(self, slot: int) -> None:
        """Free the slot and its pages.  Clearing the slot's table rows
        keeps its dead rows harmless: their in-round writes go to the
        trash page, so a freed page given to another request is never
        written by the releasing slot riding along."""
        r0 = slot * self.rows_per_slot
        r1 = r0 + self.rows_per_slot
        for pg in self.page_table[r0:r1].reshape(-1):
            if pg > 0:
                heapq.heappush(self._free_pages, int(pg))
        self.page_table[r0:r1] = 0
        self._chain_len[slot] = 0
        self._touch_table(slot)
        super().release(slot)

    # -- suspend / resume: pages without a slot ------------------------------
    def detach(self, slot: int) -> dict:
        """Free the SLOT but keep its PAGES (``cache_pool.py:480``): the
        returned handle owns the chains, which are then in neither the
        free heap nor the table; ``attach`` re-binds them to any free
        slot (a host table rewrite, no KV copy), ``release_handle``
        forfeits them."""
        r0 = slot * self.rows_per_slot
        r1 = r0 + self.rows_per_slot
        handle = {"chains": self.page_table[r0:r1].copy(),
                  "chain_len": int(self._chain_len[slot]),
                  "pos": int(self.pos[slot])}
        self.page_table[r0:r1] = 0
        self._chain_len[slot] = 0
        self._touch_table(slot)
        super().release(slot)
        return handle

    def attach(self, slot: int, handle: dict) -> None:
        """Re-bind a detached handle's chains to ``slot``; columns the
        table gained since the detach stay unmapped."""
        r0 = slot * self.rows_per_slot
        r1 = r0 + self.rows_per_slot
        chains = handle["chains"]
        assert chains.shape[0] == self.rows_per_slot
        assert chains.shape[1] <= self.n_lp
        assert not self.page_table[r0:r1].any()
        self.page_table[r0:r1, :chains.shape[1]] = chains
        self._chain_len[slot] = int(handle["chain_len"])
        self._touch_table(slot)
        self.set_pos(slot, int(handle["pos"]))

    def release_handle(self, handle: dict) -> None:
        """Forfeit a suspended request's pages (its re-admission then
        re-prefills)."""
        for pg in handle["chains"].reshape(-1):
            if pg > 0:
                heapq.heappush(self._free_pages, int(pg))
        handle["chains"] = np.zeros_like(handle["chains"])
        handle["chain_len"] = 0

    # -- device table mirror -------------------------------------------------
    def _touch_table(self, slot: int) -> None:
        """Per-slot device-table update after a host chain change: one
        row-range copy (uploaded without a sync), not a re-upload."""
        if self._pt_dev is not None:
            r0 = slot * self.rows_per_slot
            r1 = r0 + self.rows_per_slot
            self._pt_dev[r0:r1].copy_(to_device(
                self.page_table[r0:r1].astype(np.int64), self.device))

    def pt_device(self) -> torch.Tensor:
        """(rows, n_lp) int64 device page table for the paged calls:
        built from the host table once, then kept by per-slot touches."""
        if self._pt_dev is None:
            self._pt_dev = to_device(self.page_table.astype(np.int64),
                                     self.device)
        return self._pt_dev

    def slot_table(self, slot: int) -> torch.Tensor:
        """``slot``'s rows of the device table (a view)."""
        r0 = slot * self.rows_per_slot
        return self.pt_device()[r0:r0 + self.rows_per_slot]

    # -- buffer growth: a table widening, not a storage copy -----------------
    def ensure_buf(self, buf_len: int) -> None:
        if buf_len <= self.buf_len:
            return
        new_lp = P.n_logical_pages(buf_len, self.page_size)
        if new_lp > self.n_lp:
            rows = self.num_slots * self.rows_per_slot
            pad = np.zeros((rows, new_lp - self.n_lp), np.int32)
            self.page_table = np.concatenate([self.page_table, pad], axis=1)
            self.n_lp = new_lp
            self._pt_dev = None        # shape changed; rebuilt lazily
        self.buf_len = buf_len

    # -- cache content ops ---------------------------------------------------
    def write_prefill(self, name: str, slot: int, cache: dict,
                      pos: int) -> None:
        """Install a dense prefill cache (``cache_pool.py:566``): reserve
        the slot's chains through ``pos``, quantize on install into an
        int8 pool, scatter through the slot's table rows."""
        assert cache["k"].shape[3] == self.buf_len, \
            "prefill cache buffer != pool buffer"
        cache = {"k": cache["k"], "v": cache["v"]}
        if self.quant:
            from repro_torch.serving.quant import quantize_kv
            kq, ks = quantize_kv(cache["k"])
            vq, vs = quantize_kv(cache["v"])
            cache = {"k": kq, "v": vq, "k_s": ks, "v_s": vs}
        self.reserve(slot, pos)
        P.scatter_arena(self.pages[name], self.slot_table(slot), cache)
        self.set_pos(slot, pos)

    def rollback_rows(self, row_src: np.ndarray) -> None:
        assert row_src.shape == (self.num_slots * self.rows_per_slot,)
        idx = to_device(np.asarray(row_src, np.int64), self.device)
        pt = self.pt_device()
        for pages in self.pages.values():
            P.replicate_rows(pages, pt, idx)

    def materialize(self, name: str) -> dict:
        """One model's whole contiguous arena view (tests and debugging;
        the serving paths never build it)."""
        return P.gather_arena(self.pages[name], self.pt_device(),
                              self.buf_len)
