"""The paged KV layout and the gather that resolves it -- the port's
counterpart of ``repro/kernels/paged.py``.

A paged arena stores each (row, layer) KV stream as a chain of
fixed-size time pages in a physical pool ``(P, Hkv, page, D)``; a page
table ``(B, n_lp)`` maps row b's logical page j to a physical page.
Physical page 0 is all zeros and table entry 0 means unmapped, so an
unmapped page reads zeros, which every attention masks beyond
``kv_len``.

``gather_kv_pages`` resolves the table into a contiguous ``(B, Hkv, t,
D)`` view (one ``index_select`` over the page axis), which then feeds
the contiguous attention entry points unchanged: paged attention is the
contiguous attention on an identical view.  It is a gather, not a
kernel (the JAX package's is a ``jnp.take``); a decode or flash kernel
that reads pages through the table is later performance work.
"""

from __future__ import annotations

import torch


def gather_kv_pages(pages: torch.Tensor, table: torch.Tensor,
                    t: int) -> torch.Tensor:
    """pages: (..., P, Hkv, page, D) physical pool (page 0 all zeros),
    any leading dims (a stacked layer axis) carried through;
    table: (B, n_lp) integer logical-to-physical map (0 = unmapped);
    t: view length, at most n_lp * page.  Returns a contiguous (..., B,
    Hkv, t, D) tensor in the pool's dtype."""
    b, n_lp = table.shape
    *lead, _, hkv, page, d = pages.shape
    axis = len(lead)
    v = pages.index_select(axis, table.reshape(-1))
    v = v.reshape(*lead, b, n_lp, hkv, page, d).transpose(axis + 1, axis + 2)
    return v.reshape(*lead, b, hkv, n_lp * page, d)[..., :t, :].contiguous()
