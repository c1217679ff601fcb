"""Slot-based KV arena for multi-request cached serving -- the port's
counterpart of ``repro/models/cache_pool.py::CachePool``: the contiguous
arena, float32 or int8 (the paged arena is a later slice).

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

from typing import Dict

import numpy as np
import torch

from repro_torch.device import to_device
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
