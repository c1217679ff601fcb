"""Paged KV storage: the page-table indirection between the slot-arena
view the models compute on and fixed-size physical pages -- the port's
counterpart of ``repro/models/paged.py`` (DESIGN.md §12).

The contiguous pool stores each model's KV as one ``(layers, rows,
kv_heads, buf_len, head_dim)`` arena.  The paged pool replaces the time
axis with chains of fixed-size pages:

  physical storage  (layers, num_pages + 2, kv_heads, page_size, head_dim)
  page table        (rows, n_logical_pages)

Row b's logical positions ``[lp * page_size, (lp + 1) * page_size)``
live in physical page ``table[b, lp]``.  As in the JAX package, page 0
is a permanent all-zero page and table entry 0 means unmapped: a gather
through an unmapped entry reads zeros, and a scatter through one is
dropped, so the zero page is never written and pages owned by other rows
stay untouched.

JAX drops such a write by sending its index out of bounds under
``mode="drop"``.  The port's storage has one page more than JAX's, a
write-only trash page after the last real one (index ``num_pages + 1``,
``storage.shape[page axis] - 1``), which no table entry names: unmapped
indices are redirected there with ``torch.where`` and the write is one
``index_copy_``.  A boolean mask would be a ``nonzero`` (a host sync on
the card); this form queues without one.  Pages ``0..num_pages`` hold
exactly the JAX package's bytes.

A gathered view is sliced to exactly ``buf_len`` positions, so every
model computation runs at the contiguous arena's shapes.  Where a chain
is mapped the view holds the arena's content; where it is not, zeros,
beyond the row's ``kv_len`` and masked to exact ``-inf`` scores.

The layer functions take one layer's leaf ``(P + 2, H, page, d)``; the
``*_arena`` ones the stacked ``(layers, P + 2, H, page, d)`` leaves.
int8 pools page their ``k``/``v`` and float32 ``k_s``/``v_s`` scale
leaves (trailing dim 1) through the same functions.  Every scatter and
replication writes its storage IN PLACE (the port's stand-in for JAX's
functional updates) and returns it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.paged import gather_kv_pages


def n_logical_pages(buf_len: int, page_size: int) -> int:
    """Pages needed to cover ``buf_len`` tokens (ceil division)."""
    return -(-buf_len // page_size)


def table_occupancy(table) -> int:
    """Mapped (nonzero) entries of a host page table."""
    return int(np.count_nonzero(np.asarray(table)))


def _scatter(pages: torch.Tensor, table: torch.Tensor,
             view: torch.Tensor) -> torch.Tensor:
    """In place: a contiguous (..., rows, H, T, d) ``view`` into
    ``pages`` (..., P + 2, H, page, d) through ``table``; unmapped
    entries and the pad tail go to the trash page."""
    rows, n_lp = table.shape
    *lead, _, h, page, d = pages.shape
    axis = len(lead)
    t = view.shape[-2]
    if t < n_lp * page:
        view = F.pad(view, (0, 0, 0, n_lp * page - t))
    v = view.reshape(*lead, rows, h, n_lp, page, d).transpose(axis + 1,
                                                              axis + 2)
    v = v.reshape(*lead, rows * n_lp, h, page, d)
    idx = table.reshape(-1).to(torch.int64)
    idx = torch.where(idx > 0, idx, pages.shape[axis] - 1)
    pages.index_copy_(axis, idx, v)
    return pages


# ---------------------------------------------------------------------------
# Per-layer primitives
# ---------------------------------------------------------------------------


def gather_layer(pages_l: torch.Tensor, table: torch.Tensor,
                 buf_len: int) -> torch.Tensor:
    """One layer's contiguous ``(rows, H, buf_len, d)`` view of
    ``pages_l (P + 2, H, page, d)`` through ``table (rows, n_lp)``;
    unmapped entries read the zero page."""
    return gather_kv_pages(pages_l, table, buf_len)


def scatter_layer(pages_l: torch.Tensor, table: torch.Tensor,
                  view_l: torch.Tensor) -> torch.Tensor:
    """Write a contiguous ``(rows, H, T, d)`` view back through the page
    table, in place (``T <= n_lp * page``).  The pad tail and every
    position whose entry is unmapped land in the trash page, so the zero
    page and pages owned by other rows stay untouched.  A mapped page
    appears in one table entry only (the allocator's invariant), so the
    real writes never collide."""
    return _scatter(pages_l, table, view_l)


# ---------------------------------------------------------------------------
# Arena-level wrappers (stacked-layer leaves, the pool's use)
# ---------------------------------------------------------------------------


def gather_arena(pages: dict, table: torch.Tensor, buf_len: int) -> dict:
    """{leaf: (layers, P + 2, H, page, d)} -> {leaf: (layers, rows, H,
    buf_len, d)} contiguous arena, all layers at once."""
    return {kk: gather_kv_pages(leaf, table, buf_len)
            for kk, leaf in pages.items()}


def scatter_arena(pages: dict, table: torch.Tensor, arena: dict) -> dict:
    """Inverse of ``gather_arena`` for the leaves present in ``arena``,
    in place."""
    for kk in arena:
        _scatter(pages[kk], table, arena[kk])
    return pages


def replicate_rows(pages: dict, table: torch.Tensor,
                   row_src: torch.Tensor) -> dict:
    """The paged rollback (``paged.py:replicate_rows``): row i's chain
    CONTENT becomes row ``row_src[i]``'s, copied page by page through the
    table, in place; rows keep their own physical pages.  The source
    pages are read into a temporary before any write, so a chain that is
    both read and written replicates its old content.  Unmapped
    destinations go to the trash page."""
    src_idx = table.index_select(0, row_src.to(torch.int64)).reshape(-1)
    dst = table.reshape(-1).to(torch.int64)
    for leaf in pages.values():
        safe = torch.where(dst > 0, dst, leaf.shape[1] - 1)
        leaf.index_copy_(1, safe, leaf.index_select(1, src_idx))
    return pages


def paged_block(block_fn, table: torch.Tensor, buf_len: int):
    """Adapt a per-layer block ``fn(params_l, x, cache_l) -> x`` over a
    contiguous layer cache (which it writes in place) to paged storage:
    gather the layer's view, run the block unchanged, scatter every leaf
    back through the table.  The block never sees a page, so paged
    attention is the contiguous attention on the same view."""

    def wrapped(params_l, x, pages_l):
        view = {kk: gather_layer(leaf, table, buf_len)
                for kk, leaf in pages_l.items()}
        x = block_fn(params_l, x, view)
        for kk, leaf in pages_l.items():
            scatter_layer(leaf, table, view[kk])
        return x

    return wrapped
