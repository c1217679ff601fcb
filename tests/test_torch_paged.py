"""The port's paged KV arena and the scheduler's v2 policy against the JAX
package on the CPU (DESIGN.md §12).

* ``gather_kv_pages``, ``gather_layer``/``scatter_layer`` (writes through
  unmapped entries and the pad tail dropped: the zero page and other
  rows' pages untouched), the arena wrappers, ``replicate_rows`` and
  ``paged_block``: bit for bit against JAX on pages ``0..P`` (the port's
  storage has one trash page more);
* the paged attention entry points against JAX's paged ops (plain, and
  the interpret-mode Pallas kernels for decode and flash) and bit for
  bit against the port's contiguous ones on the gathered view;
* ``PagedCachePool`` under one sequence of alloc / reserve / release /
  detach / attach / release_handle / ensure_buf / auto-grow, beside
  JAX's pool: equal tables, free pages, chains and ``materialize``;
  exhaustion without partial state; no ``caches``;
* the three paged slot calls against JAX's (the contiguous slot tests'
  tolerances) and bit for bit against the port's contiguous calls,
  float32 and int8;
* v2 servers against JAX's paged v2 servers on JAX's small pair (K = 2,
  L = 2, 6 tokens, pages of 8): per-uid streams and the counts
  ``preemptions``, ``evictions`` and ``rounds`` equal to JAX's;
  streaming and a raising callback; FIFO over a fixed budget raising
  ``PagePoolExhausted``; straddling buckets; the kernel routes; quant;
  the v2 validation messages and ``launch/serve.py --paged --policy
  v2``.

JAX's engines are built once per module.  JAX is imported inside the
CPU fixtures only, so the ``cuda``-marked tests also run where there is
no JAX.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import random as R
from repro_torch.device import SyncCounter
from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                      decode_attention_paged)
from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                     flash_attention_paged)
from repro_torch.kernels.paged import gather_kv_pages
from repro_torch.models import (PagedCachePool, PagePoolExhausted,
                                ModelConfig, params_from_jax)
from repro_torch.models import layers as TL
from repro_torch.models import paged as TP
from repro_torch.models import transformer as TT
from repro_torch.specdec import (STRATEGIES, CachedSpecDecEngine,
                                 SpecDecConfig, SpecDecServer)

# JAX's small pair and trace (``tests/test_scheduler.py:21-25,145-147``).
TKW = dict(name="t", family="dense", num_layers=2, d_model=48, num_heads=4,
           num_kv_heads=2, head_dim=12, d_ff=96, vocab_size=32,
           dtype="float32")
DKW = {**TKW, "name": "d", "num_layers": 1}
SD = dict(num_drafts=2, draft_len=2, strategy="gls", top_k=0)
PROMPTS = [np.arange(1, 1 + n, dtype=np.int32) % 31 + 1 for n in (3, 5, 4, 6)]
MAX_NEW = 6
PAGE = 8
# Attention and slot-call tolerances (``test_torch_quant.py``,
# ``test_torch_model.py``).
ATTN_TOL = 2e-5
ATOL_KV = ATOL_LOGITS = 1e-5
SCALE_RTOL, QUANT_LOGIT_ATOL = 1e-5, 1e-4


def _min_buf(prompts=PROMPTS):
    return max(len(p) for p in prompts) + MAX_NEW + SD["draft_len"] + 2


@pytest.fixture(scope="module")
def J():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels import paged as kpaged
    from repro.kernels.decode_attention import ops as dops
    from repro.kernels.flash_attention import ops as fops
    from repro.models import ModelConfig as JCfg
    from repro.models import cache_pool, init_params, layers, paged
    from repro.models import transformer
    from repro.serving import quant
    from repro.specdec import CachedSpecDecEngine as Engine
    from repro.specdec import SpecDecConfig as Config
    from repro.specdec.scheduler import SpecDecServer as Server
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, kpaged=kpaged, dops=dops, fops=fops, Cfg=JCfg,
        pool=cache_pool, init=init_params, L=layers, P=paged, T=transformer,
        quant=quant, Engine=Engine, Config=Config, Server=Server)


@pytest.fixture(scope="module")
def pair(J):
    jt, jd = J.Cfg(**TKW), J.Cfg(**DKW)
    init = J.jax.jit(J.init, static_argnums=1)    # one compile, not ~30
    jtp = init(J.jax.random.PRNGKey(0), jt)
    jdp = init(J.jax.random.PRNGKey(1), jd)
    conv = lambda p: params_from_jax(J.jax.tree_util.tree_map(np.asarray, p),
                                     device="cpu")
    return {"jax": ((jtp, jt), (jdp, jd)),
            "torch": ((conv(jtp), ModelConfig(**TKW)),
                      (conv(jdp), ModelConfig(**DKW)))}


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))


# A table of 3 rows x 3 logical pages over 6 physical pages: row 2's
# chain ends in an unmapped entry, row 1 holds one page.
TABLE = np.array([[1, 4, 6], [2, 0, 0], [5, 3, 0]], np.int32)
N_PAGES = 6


def _pages(rng, lead=(), h=2, page=4, d=3, int8=False):
    """Random storage of N_PAGES pages plus the zero page: JAX's
    (P + 1) layout and the port's with its trash page appended."""
    shape = lead + (N_PAGES + 1, h, page, d)
    if int8:
        a = rng.randint(-127, 128, shape).astype(np.int8)
    else:
        a = rng.randn(*shape).astype(np.float32)
    a[(slice(None),) * len(lead) + (0,)] = 0
    trash = np.zeros(lead + (1, h, page, d), a.dtype)
    return a, np.concatenate([a, trash], axis=len(lead))


def _real(t, axis=0):
    """Pages 0..P of the port's storage (its last, the trash page,
    dropped)."""
    return t.numpy().take(range(t.shape[axis] - 1), axis=axis)


# ---------------------------------------------------------------------------
# Paged storage primitives
# ---------------------------------------------------------------------------


def test_gather_and_scatter_layer_match_jax(J):
    rng = np.random.RandomState(0)
    jp, tp = _pages(rng)
    for t in (12, 10, 5):
        want = _np(J.kpaged.gather_kv_pages(J.jnp.asarray(jp),
                                            J.jnp.asarray(TABLE), t))
        np.testing.assert_array_equal(
            gather_kv_pages(_t(tp), _t(TABLE), t).numpy(), want)
        np.testing.assert_array_equal(
            TP.gather_layer(_t(tp), _t(TABLE), t).numpy(),
            _np(J.P.gather_layer(J.jnp.asarray(jp), J.jnp.asarray(TABLE), t)))
    # A view shorter than the chains (pad tail dropped), written through
    # rows 0 and 2 only: row 1's page, the zero page and row 2's unmapped
    # entry are untouched.
    view = rng.randn(2, 2, 10, 3).astype(np.float32)
    sub = TABLE[[0, 2]]
    want = _np(J.P.scatter_layer(J.jnp.asarray(jp), J.jnp.asarray(sub),
                                 J.jnp.asarray(view)))
    got = TP.scatter_layer(_t(tp), _t(sub), _t(view))
    np.testing.assert_array_equal(_real(got), want)
    assert not got[0].any()
    np.testing.assert_array_equal(got[2].numpy(), jp[2])
    assert TP.n_logical_pages(17, 8) == J.P.n_logical_pages(17, 8) == 3
    assert TP.table_occupancy(TABLE) == J.P.table_occupancy(TABLE) == 6


@pytest.mark.parametrize("int8", [False, True])
def test_arena_wrappers_and_replicate_rows_match_jax(J, int8):
    """The stacked leaves (2 layers): gather, scatter, and the rollback's
    page-by-page replication with an aliasing ``row_src``; int8 leaves
    and (L, P + 1, H, page, 1) scales alike."""
    rng = np.random.RandomState(1)
    jk, tk = _pages(rng, lead=(2,), int8=int8)
    js, ts = _pages(rng, lead=(2,), d=1)
    jpages = {"k": J.jnp.asarray(jk), "k_s": J.jnp.asarray(js)}
    tpages = {"k": _t(tk), "k_s": _t(ts)}
    want = J.P.gather_arena(jpages, J.jnp.asarray(TABLE), 11)
    got = TP.gather_arena(tpages, _t(TABLE), 11)
    for kk in got:
        np.testing.assert_array_equal(got[kk].numpy(), _np(want[kk]))
    arena = {kk: _t(_np(v) + (1 if kk == "k" else 0.5))
             for kk, v in want.items()}
    jnew = J.P.scatter_arena(jpages, J.jnp.asarray(TABLE),
                             {kk: J.jnp.asarray(v.numpy())
                              for kk, v in arena.items()})
    TP.scatter_arena(tpages, _t(TABLE), arena)
    for kk in tpages:
        np.testing.assert_array_equal(_real(tpages[kk], 1), _np(jnew[kk]))
    row_src = np.array([2, 2, 0])
    jrep = J.P.replicate_rows(jnew, J.jnp.asarray(TABLE),
                              J.jnp.asarray(row_src))
    TP.replicate_rows(tpages, _t(TABLE), _t(row_src))
    for kk in tpages:
        np.testing.assert_array_equal(_real(tpages[kk], 1), _np(jrep[kk]))
        assert not tpages[kk][:, 0].any()


def test_paged_block_matches_jax(J):
    """A block that writes one position of every row and reads it back:
    the same carry and pages as JAX's ``paged_block``."""
    rng = np.random.RandomState(2)
    jp, tp = _pages(rng)

    def jblock(params, carry, cache):
        k = cache["k"].at[:, :, 2].set(params)
        return carry + k[:, :, 2].sum(), {"k": k}

    def tblock(params, x, cache):
        cache["k"][:, :, 2] = params
        return x + cache["k"][:, :, 2].sum()

    jc, jpg = J.P.paged_block(jblock, J.jnp.asarray(TABLE), 10)(
        J.jnp.float32(7.0), J.jnp.float32(1.0), {"k": J.jnp.asarray(jp)})
    tpg = {"k": _t(tp)}
    tc = TP.paged_block(tblock, _t(TABLE), 10)(7.0, torch.tensor(1.0), tpg)
    assert float(tc) == float(jc)
    np.testing.assert_array_equal(_real(tpg["k"]), _np(jpg["k"]))


# ---------------------------------------------------------------------------
# Paged attention entry points
# ---------------------------------------------------------------------------


def _attn_pages(rng, int8, d=16, hkv=2):
    kp = [_pages(rng, h=hkv, d=d, int8=int8) for _ in range(2)]
    sp = [_pages(rng, h=hkv, d=1) for _ in range(2)] if int8 else None
    if int8:
        # Scales of randn data quantized to int8: |x| / 127 for |x| ~ 3.
        for pair_ in sp:
            for a in pair_:
                a[...] = np.abs(a) * (3 / 127)
    return kp, sp


@pytest.mark.parametrize("int8", [False, True])
def test_decode_attention_paged_matches_jax_and_contiguous(J, int8):
    rng = np.random.RandomState(3)
    kp, sp = _attn_pages(rng, int8)
    (jk, tk), (jv, tv) = kp
    q = rng.randn(3, 6, 16).astype(np.float32)
    kv_len = np.array([11, 3, 7], np.int32)
    jargs = [J.jnp.asarray(x) for x in (q, jk, jv, TABLE, kv_len)]
    targs = [_t(x) for x in (q, tk, tv, TABLE, kv_len)]
    jsc = [J.jnp.asarray(s[0]) for s in sp] if int8 else [None, None]
    tsc = [_t(s[1]) for s in sp] if int8 else [None, None]
    got = decode_attention_paged(*targs, *tsc, buf_len=12)
    for use_kernel in (False, True):
        want = J.dops.decode_attention_paged_op(
            *jargs, *jsc, buf_len=12, use_kernel=use_kernel,
            interpret=True if use_kernel else None)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=ATTN_TOL,
                                   atol=ATTN_TOL)
    view = [None if x is None else gather_kv_pages(x, _t(TABLE), 12)
            for x in (targs[1], targs[2], *tsc)]
    assert torch.equal(got, decode_attention(targs[0], view[0], view[1],
                                             targs[4], view[2], view[3]))


@pytest.mark.parametrize("int8", [False, True])
def test_flash_attention_paged_matches_jax_and_contiguous(J, int8):
    rng = np.random.RandomState(4)
    kp, sp = _attn_pages(rng, int8)
    (jk, tk), (jv, tv) = kp
    q = rng.randn(3, 6, 4, 16).astype(np.float32)
    q_off = np.array([5, 0, 2], np.int32)
    kv_len = np.array([9, 4, 6], np.int32)
    jsc = [J.jnp.asarray(s[0]) for s in sp] if int8 else [None, None]
    tsc = [_t(s[1]) for s in sp] if int8 else [None, None]
    got = flash_attention_paged(_t(q), _t(tk), _t(tv), _t(TABLE), _t(q_off),
                                _t(kv_len), *tsc, buf_len=12)
    for use_kernel in (False, True):
        kw = dict(interpret=True) if use_kernel else {}
        want = J.fops.flash_attention_paged_op(
            *[J.jnp.asarray(x) for x in (q, jk, jv, TABLE, q_off, kv_len)],
            *jsc, buf_len=12, use_kernel=use_kernel, **kw)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=ATTN_TOL,
                                   atol=ATTN_TOL)
    view = [None if x is None else gather_kv_pages(x, _t(TABLE), 12)
            for x in (_t(tk), _t(tv), *tsc)]
    assert torch.equal(got, flash_attention(_t(q), view[0], view[1],
                                            _t(q_off), _t(kv_len), view[2],
                                            view[3]))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_attention_paged_matches_jax_and_contiguous(J, use_kernel):
    """The layer-level entry point: the decode case (one query, kv_len)
    and the causal chunk case, with and without the kernel routes.  JAX's
    ``gqa_attention_paged`` calls a name its module does not define
    (``repro/models/layers.py:246``, ``gqa_attention``: NameError), so the
    port is held to what it means to compute, JAX's ``attention`` on
    JAX's ``gather_kv_pages`` view."""
    rng = np.random.RandomState(5)
    (jk, tk), (jv, tv) = _attn_pages(rng, False)[0]
    view = [gather_kv_pages(_t(x), _t(TABLE), 12) for x in (tk, tv)]
    for s, causal, off, kvl in ((1, False, 0, [11, 3, 7]),
                                (4, True, [5, 0, 2], [9, 4, 6])):
        q = rng.randn(3, 6, s, 16).astype(np.float32)
        kw = dict(causal=causal, q_offset=_t(np.int32(off)),
                  kv_len=_t(np.array(kvl, np.int32)), use_kernel=use_kernel)
        got = TL.attention_paged(_t(q), _t(tk), _t(tv), _t(TABLE),
                                 buf_len=12, **kw)
        with pytest.raises(NameError, match="gqa_attention"):
            J.L.gqa_attention_paged(J.jnp.asarray(q), J.jnp.asarray(jk),
                                    J.jnp.asarray(jv), J.jnp.asarray(TABLE),
                                    buf_len=12)
        jview = [J.kpaged.gather_kv_pages(J.jnp.asarray(x),
                                          J.jnp.asarray(TABLE), 12)
                 for x in (jk, jv)]
        want = J.L.attention(
            J.jnp.asarray(q), *jview, causal=causal,
            q_offset=J.jnp.asarray(np.int32(off)),
            kv_len=J.jnp.asarray(np.array(kvl, np.int32)),
            use_kernel=use_kernel)
        np.testing.assert_allclose(got.numpy(), _np(want), rtol=ATTN_TOL,
                                   atol=ATTN_TOL)
        assert torch.equal(got, TL.attention(_t(q), *view, **kw))


# ---------------------------------------------------------------------------
# PagedCachePool
# ---------------------------------------------------------------------------


def _pool_state(pool):
    return (pool.page_table.tolist(), sorted(pool._free_pages),
            pool._chain_len.tolist(), pool.num_pages, pool.n_lp,
            pool.buf_len, pool.pos.tolist(), pool.num_free)


@pytest.mark.parametrize("quant", [False, True])
def test_paged_pool_sequence_matches_jax(J, quant):
    """One lifecycle on both pools (auto-grow, 3 slots x 2 rows, pages
    of 8): prefill installs (quantized on install for int8), reserve,
    widening, growth past the first budget, a rollback, detach / attach
    to another slot, release_handle, release.  After every step the
    host state is equal, and ``materialize`` is bit for bit."""
    cfgs = {"target": TKW, "drafter": DKW}
    jp = J.pool.PagedCachePool({n: J.Cfg(**kw) for n, kw in cfgs.items()},
                               num_slots=3, rows_per_slot=2, buf_len=20,
                               quant=quant, page_size=PAGE)
    tp = PagedCachePool({n: ModelConfig(**kw) for n, kw in cfgs.items()},
                        num_slots=3, rows_per_slot=2, buf_len=20,
                        device="cpu", quant=quant, page_size=PAGE)
    rng = np.random.RandomState(6)

    def prefill(slot, n):
        for name, kw in cfgs.items():
            shape = (kw["num_layers"], 2, 2, jp.buf_len, 12)
            k, v = (rng.randn(*shape).astype(np.float32) for _ in range(2))
            jp.write_prefill(name, slot, {"k": J.jnp.asarray(k),
                                          "v": J.jnp.asarray(v)}, pos=n)
            tp.write_prefill(name, slot, {"k": _t(k), "v": _t(v)}, pos=n)

    def same():
        assert _pool_state(tp) == _pool_state(jp)
        for name in cfgs:
            want = jp.materialize(name)
            for kk, leaf in tp.materialize(name).items():
                np.testing.assert_array_equal(leaf.numpy(), _np(want[kk]))

    for slot, n in ((0, 10), (1, 20), (2, 17)):
        assert jp.alloc() == tp.alloc() == slot
        prefill(slot, n)
        same()
    for pool in (jp, tp):
        pool.ensure_buf(40)              # a widening: no storage copy
        pool.reserve(1, 40)              # 20 pages > 18: the pool grows
    same()
    row_src = np.array([1, 1, 2, 3, 5, 5])
    jp.rollback_rows(row_src)
    tp.rollback_rows(row_src)
    same()
    handles = [pool.detach(0) for pool in (jp, tp)]
    assert handles[0]["chains"].tolist() == handles[1]["chains"].tolist()
    for pool in (jp, tp):
        pool.release(1)
        assert pool.alloc() == 0
        pool.attach(0, handles[0] if pool is jp else handles[1])
    same()
    for pool, h in ((jp, handles[0]), (tp, handles[1])):
        pool.release_handle(dict(h, chains=h["chains"].copy()))
        pool.release(2)
    same()
    assert tp.held_pages(0) == jp.held_pages(0) > 0
    assert tp.chain_pages(17) == jp.chain_pages(17) == 3


def test_paged_pool_exhaustion_leaves_no_partial_state():
    cfg = ModelConfig(**TKW)
    pool = PagedCachePool({"t": cfg}, num_slots=2, rows_per_slot=2,
                          buf_len=32, device="cpu", page_size=PAGE,
                          num_pages=5)
    pool.alloc()
    pool.reserve(0, 16)                    # 2 pages a row: 4 of 5
    pool.alloc()
    before = _pool_state(pool)
    with pytest.raises(PagePoolExhausted, match="needs 2 pages, 1/5 free"):
        pool.reserve(1, 8)
    assert _pool_state(pool) == before
    with pytest.raises(AttributeError):
        pool.caches
    assert pool.pages["t"]["k"].shape[1] == 5 + 2


# ---------------------------------------------------------------------------
# The paged slot calls
# ---------------------------------------------------------------------------

B, BUF = 4, 20
# 4 rows: rows 0-2 mapped through position 23 (3 pages each), row 3
# unmapped (a dead row); 12 physical pages.
SLOT_TABLE = np.array([[3, 7, 1], [2, 9, 12], [5, 4, 11], [0, 0, 0]],
                      np.int32)
SLOT_PAGES = 12


def _slot_pages(J, rng, quant):
    """Random page storage (2 layers) for JAX and the port, and the
    port's contiguous arena gathered from it."""
    shape = (2, SLOT_PAGES + 1, 2, PAGE, 12)
    leaves = {}
    for kk in ("k", "v"):
        x = rng.randn(*shape).astype(np.float32)
        if quant:
            q, s = J.quant.quantize_kv(J.jnp.asarray(x))
            leaves[kk], leaves[kk + "_s"] = np.array(q), np.array(s)
        else:
            leaves[kk] = x
    for a in leaves.values():
        a[:, 0] = 0
    jpages = {kk: J.jnp.asarray(a) for kk, a in leaves.items()}
    tpages = {kk: _t(np.concatenate([a, np.zeros_like(a[:, :1])], axis=1))
              for kk, a in leaves.items()}
    arena = TP.gather_arena(tpages, _t(SLOT_TABLE), BUF)
    return jpages, tpages, arena


def _check_pages(tpages, jpages, quant):
    for kk, leaf in tpages.items():
        got, want = _real(leaf, 1), _np(jpages[kk])
        if quant and kk in ("k", "v"):
            assert np.abs(got.astype(np.int32)
                          - want.astype(np.int32)).max() <= 1, kk
        elif quant:
            np.testing.assert_allclose(got, want, rtol=SCALE_RTOL, atol=0)
        else:
            np.testing.assert_allclose(got, want, atol=ATOL_KV, rtol=0)


def _check_contiguous(tpages, arena):
    """The paged storage, gathered, equals the contiguous call's arena
    bit for bit wherever the table maps (elsewhere it reads zeros)."""
    got = TP.gather_arena(tpages, _t(SLOT_TABLE), BUF)
    mapped = np.repeat(SLOT_TABLE > 0, PAGE, axis=1)[:, :BUF]
    mask = torch.from_numpy(mapped)[None, :, None, :, None]
    for kk, leaf in got.items():
        assert torch.equal(leaf, torch.where(mask, arena[kk],
                                             torch.zeros_like(arena[kk])))


# (quant, use_kernel): float32 dense and through the kernel routes (their
# plain versions here), int8 through the kernel routes.
SLOT_CASES = [(False, False), (False, True), (True, True)]


@pytest.mark.parametrize("quant,use_kernel", SLOT_CASES)
def test_slot_calls_paged_match_jax_and_contiguous(J, pair, quant,
                                                   use_kernel):
    """prefill (a masked row and the dead row), decode at ragged
    positions, a 3-token verify: each against JAX's paged call and, bit
    for bit (logits and storage), the port's contiguous call on the
    gathered arena."""
    (jtp, jcfg), _ = pair["jax"]
    (ttp, tcfg), _ = pair["torch"]
    rng = np.random.RandomState(7 + quant)
    jpages, tpages, arena = _slot_pages(J, rng, quant)
    jt, tt = J.jnp.asarray(SLOT_TABLE), _t(SLOT_TABLE)
    atol = QUANT_LOGIT_ATOL if quant else ATOL_LOGITS

    toks = rng.randint(0, 32, (B, 5)).astype(np.int32)
    pos = np.array([0, 6, 15, 0], np.int32)
    write = np.array([True, False, True, False])
    jpages = J.T.prefill_slots_paged(
        jtp, jcfg, J.jnp.asarray(toks), jpages, jt, J.jnp.asarray(pos),
        J.jnp.asarray(write), buf_len=BUF, use_kernel=use_kernel)
    TT.prefill_slots_paged(ttp, tcfg, _t(toks), tpages, tt, pos, write,
                           buf_len=BUF, use_kernel=use_kernel)
    TT.prefill_slots(ttp, tcfg, _t(toks), arena, pos, write,
                     use_kernel=use_kernel)
    _check_pages(tpages, jpages, quant)
    _check_contiguous(tpages, arena)

    toks = rng.randint(0, 32, (B, 1)).astype(np.int32)
    pos = np.array([5, 11, 19, 0], np.int32)
    jl, jpages = J.T.decode_step_slots_paged(
        jtp, jcfg, J.jnp.asarray(toks), jpages, jt, J.jnp.asarray(pos),
        buf_len=BUF, use_kernel=use_kernel)
    tl = TT.decode_step_slots_paged(ttp, tcfg, _t(toks), tpages, tt, _t(pos),
                                    buf_len=BUF, use_kernel=use_kernel)
    cl = TT.decode_step_slots(ttp, tcfg, _t(toks), arena, _t(pos),
                              use_kernel=use_kernel)
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=atol, rtol=0)
    assert torch.equal(tl, cl)
    _check_pages(tpages, jpages, quant)
    _check_contiguous(tpages, arena)

    toks = rng.randint(0, 32, (B, 3)).astype(np.int32)
    pos = np.array([6, 12, 17, 0], np.int32)
    jl, jpages = J.T.verify_step_slots_paged(
        jtp, jcfg, J.jnp.asarray(toks), jpages, jt, J.jnp.asarray(pos),
        buf_len=BUF)
    tl = TT.verify_step_slots_paged(ttp, tcfg, _t(toks), tpages, tt, _t(pos),
                                    buf_len=BUF)
    cl = TT.verify_step_slots(ttp, tcfg, _t(toks), arena, _t(pos))
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=atol, rtol=0)
    assert torch.equal(tl, cl)
    _check_pages(tpages, jpages, quant)
    _check_contiguous(tpages, arena)


# ---------------------------------------------------------------------------
# v2 servers against JAX's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def serve(J, pair):
    """``serve(side, sd, server_kw, ...)`` -> (server, {uid: output}),
    with JAX's engines built once per geometry and reused (a strategy
    change rebuilds only the fused program), and each JAX serve run once
    (JAX's streams are deterministic)."""
    engines, jax_runs = {}, {}

    def get_engine(side, sd, pool_slots, pool_pages):
        key = (side, pool_slots, pool_pages, sd.get("quant", False),
               sd.get("decode_kernel", False), sd.get("paged", False))
        if key not in engines:
            target, drafter = pair[side]
            if side == "jax":
                cfg = J.Config(**sd)
                engines[key] = J.Engine(target, drafter, cfg,
                                        pool_slots=pool_slots,
                                        pool_pages=pool_pages)
            else:
                engines[key] = CachedSpecDecEngine(
                    target, drafter, SpecDecConfig(**sd),
                    pool_slots=pool_slots, pool_pages=pool_pages,
                    device="cpu")
        eng = engines[key]
        if side == "jax":
            if eng.cfg.strategy != sd["strategy"]:
                eng.cfg = dataclasses.replace(eng.cfg,
                                              strategy=sd["strategy"])
                eng._fused_round = None
        else:
            eng.cfg = SpecDecConfig(**sd)
            eng._round = None
        return eng

    def run(side, sd, server_kw, *, pool_slots=2, pool_pages=None,
            prompts=PROMPTS, pattern=None, on_token=None):
        key = (side, tuple(sorted(sd.items())),
               tuple(sorted(server_kw.items())), pool_slots, pool_pages,
               id(prompts), pattern)
        if side == "jax" and key in jax_runs:
            return jax_runs[key]
        eng = get_engine(side, sd, pool_slots, pool_pages)
        Server = J.Server if side == "jax" else SpecDecServer
        rkey = (J.jax.random.PRNGKey(7) if side == "jax" else R.PRNGKey(7))
        srv = Server(eng, max_batch=pool_slots,
                     min_buf_len=_min_buf(prompts), **server_kw)
        if pattern is None:
            for p in prompts:
                srv.submit(p, max_new=MAX_NEW, on_token=on_token)
            done = srv.run(rkey)
        else:
            done = pattern(srv, rkey)
        out = srv, {r.uid: list(r.output) for r in done}
        if side == "jax":
            jax_runs[key] = out
        return out
    return run


def _paged(**kw):
    return dict(SD, paged=True, page_size=PAGE, **kw)


def _counts(srv):
    m = srv.metrics
    return (m.preemptions, m.evictions, m.rounds)


def _assert_free(srv):
    eng = srv.engine
    assert eng.pool.num_free == eng.pool.num_slots
    st = eng.page_state()
    assert st["free"] == st["total"]


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_v2_oversubscribed_kv_fused_matches_jax(serve, strategy):
    """``test_oversubscribed_paged_v2_bit_identical_all_strategies`` on
    both sides: a fixed budget of 24 pages, ``preempt_tokens=3``:
    JAX's streams, preemptions, evictions and rounds; no draft sync;
    every slot and page free at the end."""
    sd = _paged(strategy=strategy)
    kw = dict(cache_mode="kv_fused", policy="v2", preempt_tokens=3)
    jsrv, want = serve("jax", sd, kw, pool_pages=24)
    tsrv, got = serve("torch", sd, kw, pool_pages=24)
    assert got == want
    assert _counts(tsrv) == _counts(jsrv)
    assert tsrv.metrics.preemptions > 0
    assert tsrv.metrics.draft_syncs == 0
    assert tsrv.metrics.host_syncs == tsrv.metrics.rounds
    _assert_free(tsrv)


def _eviction_pattern(srv, key):
    """``test_mid_generation_eviction_readmission_bit_identical``: two
    requests run two steps, then a priority-5 arrival evicts one."""
    srv.submit(PROMPTS[0], max_new=MAX_NEW)
    srv.submit(PROMPTS[1], max_new=MAX_NEW)
    srv.step(key)
    srv.step(key)
    srv.submit(PROMPTS[2], max_new=MAX_NEW, priority=5)
    srv.submit(PROMPTS[3], max_new=MAX_NEW)
    return srv.run(key)


def test_v2_priority_eviction_kv_matches_jax(serve):
    """The victim suspends (its pages stay in a handle), resumes, and
    finishes with JAX's tokens (on the strategy matrix's engines: the
    full batch, not the 24-page budget, forces the eviction)."""
    kw = dict(cache_mode="kv", policy="v2")
    jsrv, want = serve("jax", _paged(), kw, pool_pages=24,
                       pattern=_eviction_pattern)
    tsrv, got = serve("torch", _paged(), kw, pool_pages=24,
                      pattern=_eviction_pattern)
    assert got == want
    assert _counts(tsrv) == _counts(jsrv)
    assert tsrv.metrics.evictions >= 1
    assert tsrv.metrics.draft_syncs == SD["draft_len"] * tsrv.metrics.rounds
    _assert_free(tsrv)
    # The same pattern through the fused round: the same streams.
    fsrv, fused = serve("torch", _paged(), dict(kw, cache_mode="kv_fused"),
                        pool_pages=24, pattern=_eviction_pattern)
    assert fused == want and fsrv.metrics.evictions >= 1


def test_v2_eviction_accounting_and_suspend_handle(pair):
    """A suspended victim keeps its pages in a handle (held by no slot),
    resumes without a prefill, and its ``evicted_s``, ``token_times``
    and ``wall_s`` are consistent."""
    target, drafter = pair["torch"]
    eng = CachedSpecDecEngine(target, drafter, SpecDecConfig(**_paged()),
                              pool_slots=2, pool_pages=16, device="cpu")
    srv = SpecDecServer(eng, max_batch=2, cache_mode="kv", policy="v2",
                        min_buf_len=_min_buf())
    key = R.PRNGKey(7)
    srv.submit(PROMPTS[0], max_new=MAX_NEW)
    srv.submit(PROMPTS[1], max_new=MAX_NEW)
    srv.step(key)
    srv.step(key)
    srv.submit(PROMPTS[2], max_new=MAX_NEW, priority=5)
    dispatches = eng.num_prefill_dispatches
    srv.step(key)
    victim = next(r for r in srv.queue if r.evictions)
    assert victim._kv_handle is not None
    held = eng.handle_pages(victim._kv_handle)
    assert held > 0 and eng.page_state()["free"] <= 16 - held
    assert eng.num_prefill_dispatches == dispatches + 2   # the arrival only
    done = srv.run(key)
    assert srv.metrics.evictions >= 1
    for r in done:
        assert len(r.token_times) == len(r.output)
        assert r.token_times == sorted(r.token_times)
        assert r.wall_s >= r.evicted_s
    assert next(r for r in done if r.uid == victim.uid).evicted_s > 0


def test_v2_streaming_and_raising_callback(serve):
    """``on_token`` streams each uid's final output in order; a callback
    that raises fails only its request (``failed``, ``callback_errors``),
    whose slot and pages are freed while the others keep JAX's
    streams."""
    kw = dict(cache_mode="kv_fused", policy="v2", preempt_tokens=3)
    _, want = serve("jax", _paged(), kw, pool_pages=24)
    streamed = {}
    tsrv, got = serve("torch", _paged(), kw, pool_pages=24,
                      on_token=lambda uid, tok: streamed.setdefault(
                          uid, []).append(tok))
    assert streamed == got == want

    def pattern(srv, key):
        for i, p in enumerate(PROMPTS):
            srv.submit(p, max_new=MAX_NEW,
                       on_token=(lambda uid, tok: 1 / 0) if i == 1 else None)
        return srv.run(key)

    tsrv, got = serve("torch", _paged(), kw, pool_pages=24, pattern=pattern)
    assert tsrv.metrics.callback_errors == 1
    assert [r.uid for r in tsrv.failed] == [2]
    assert "ZeroDivisionError" in tsrv.failed[0].error
    assert got == {u: want[u] for u in want if u != 2}
    assert tsrv.failed[0].output == want[2][:len(tsrv.failed[0].output)]
    _assert_free(tsrv)


def test_fifo_fixed_page_budget_raises(serve):
    """FIFO keeps no page account: a budget of 4 pages is exhausted
    mid-admission, loudly, as in JAX."""
    with pytest.raises(PagePoolExhausted):
        serve("torch", _paged(), dict(cache_mode="kv"), pool_pages=4)


def test_straddling_buckets_paged_equals_contiguous(serve):
    """``test_bucket_straddling_prompts_paged_bit_identical`` with a
    40-token prompt, so the wave's prefills take the 16 and 64 buckets
    (JAX's lengths 3-12 all land in 16): four slots, FIFO kv_fused and
    kv, the paged servers give the contiguous kv_fused server's streams
    (held to JAX's at these buckets in ``test_torch_kv_mode.py``)."""
    prompts = [np.arange(1, 1 + n, dtype=np.int32) % 31 + 1
               for n in (3, 9, 4, 12)]
    prompts[3] = np.random.RandomState(8).randint(1, 32, 40).astype(np.int32)
    _, want = serve("torch", SD, dict(cache_mode="kv_fused"), pool_slots=4,
                    prompts=prompts)
    for mode in ("kv_fused", "kv"):
        _, got = serve("torch", _paged(), dict(cache_mode=mode),
                       pool_slots=4, prompts=prompts)
        assert got == want, mode


# A budget of 10 pages strips one suspend handle (its request re-admits
# through a re-prefill of prompt + output) and resumes another.
TIGHT_PAGES = 10


def test_v2_kernel_routes_paged_equals_contiguous_and_jax(serve):
    """With ``decode_kernel``/``prefill_kernel`` on (their plain versions
    here), over the tight budget: the paged v2 server gives JAX's
    streams and counts, and the contiguous v2 server's streams (the
    kernels run on the gathered views)."""
    kern = dict(decode_kernel=True, prefill_kernel=True)
    kw = dict(cache_mode="kv_fused", policy="v2", preempt_tokens=3)
    jsrv, want = serve("jax", _paged(**kern), kw, pool_pages=TIGHT_PAGES)
    tsrv, got = serve("torch", _paged(**kern), kw, pool_pages=TIGHT_PAGES)
    _, contiguous = serve("torch", dict(SD, **kern), kw)
    assert got == want == contiguous
    assert _counts(tsrv) == _counts(jsrv)
    assert tsrv.metrics.evictions >= 1 and tsrv.engine.num_view_refreshes >= 1


def test_v2_quant_paged_matches_jax(serve):
    """int8 pages (quantize-on-write, W8A8 verify) over the tight budget,
    a stripped handle's request re-prefilled and re-quantized: JAX's
    streams and counts."""
    kw = dict(cache_mode="kv_fused", policy="v2", preempt_tokens=3)
    jsrv, want = serve("jax", _paged(quant=True), kw, pool_pages=TIGHT_PAGES)
    tsrv, got = serve("torch", _paged(quant=True), kw,
                      pool_pages=TIGHT_PAGES)
    assert got == want
    assert _counts(tsrv) == _counts(jsrv)
    assert tsrv.metrics.evictions >= 1 and tsrv.engine.num_view_refreshes >= 1
    assert set(tsrv.engine.pool.pages["target"]) == {"k", "v", "k_s", "v_s"}
    _assert_free(tsrv)


def test_v2_validation_messages(pair):
    target, drafter = pair["torch"]
    cfg = SpecDecConfig(**SD)
    from repro_torch.specdec import SpecDecEngine
    ref = SpecDecEngine(target, drafter, cfg, device="cpu")
    cached = CachedSpecDecEngine(target, drafter, cfg, pool_slots=2,
                                 device="cpu")
    with pytest.raises(ValueError, match="unknown policy"):
        SpecDecServer(cached, max_batch=2, cache_mode="kv", policy="mystery")
    with pytest.raises(ValueError, match="policy='v2' needs cache_mode"):
        SpecDecServer(ref, cache_mode="reprefill", policy="v2")
    with pytest.raises(ValueError, match="preempt_tokens needs policy='v2'"):
        SpecDecServer(ref, cache_mode="reprefill", preempt_tokens=4)
    with pytest.raises(ValueError, match="preempt_tokens must be >= 1"):
        SpecDecServer(cached, max_batch=2, cache_mode="kv", policy="v2",
                      preempt_tokens=0)
    assert not cached.can_suspend() and cached.page_state() is None


def test_serve_cli_paged_v2(capsys):
    from repro_torch.launch import serve as cli
    cli.main(["--arch", "smollm-360m", "--target-layers", "1",
              "--draft-layers", "1", "--requests", "2", "--max-new", "4",
              "--drafts", "2", "--draft-len", "2", "--max-batch", "1",
              "--paged", "--policy", "v2", "--preempt-tokens", "3",
              "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert "over 2 requests" in line
    assert "preemptions=1" in line and "evictions=0" in line
    with pytest.raises(SystemExit):
        cli.main(["--paged", "--cache-mode", "reprefill", "--device", "cpu"])


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the paged entry points launch the "
                    "decode and flash kernels only there")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("int8", [False, True])
def test_paged_kernels_equal_contiguous_on_card(cuda, d, int8):
    """The paged decode and flash entry points launch the kernels on the
    gathered views and equal the contiguous kernels bit for bit."""
    from repro_torch.kernels.mode import launch_counts, launch_name
    gen = torch.Generator(device=cuda).manual_seed(d + int8)
    b, hkv, g, page, n_lp = 16, 2, 3, 64, 4
    pool_n = b * n_lp
    shape = (pool_n + 1, hkv, page, d)
    if int8:
        kp, vp = (torch.randint(-127, 128, shape, device=cuda,
                                generator=gen).to(torch.int8)
                  for _ in range(2))
        ks, vs = (torch.rand(shape[:-1] + (1,), device=cuda, generator=gen)
                  for _ in range(2))
    else:
        kp, vp = (torch.randn(shape, device=cuda, generator=gen)
                  for _ in range(2))
        ks = vs = None
    table = (torch.randperm(pool_n, device=cuda, generator=gen) + 1) \
        .reshape(b, n_lp)
    table[3, 2:] = 0
    buf = 230
    kv_len = torch.randint(1, buf, (b,), device=cuda, generator=gen,
                           dtype=torch.int32)
    kv_len[3] = 100
    view = [None if x is None else gather_kv_pages(x, table, buf)
            for x in (kp, vp, ks, vs)]
    q = torch.randn(b, hkv * g, d, device=cuda, generator=gen)
    before = launch_counts[launch_name("decode_attention", d, int8)]
    got = decode_attention_paged(q, kp, vp, table, kv_len, ks, vs,
                                 buf_len=buf)
    assert launch_counts[launch_name("decode_attention", d, int8)] == \
        before + 1
    assert torch.equal(got, decode_attention(q, *view[:2], kv_len,
                                             *view[2:]))
    q = torch.randn(b, hkv * g, 48, d, device=cuda, generator=gen)
    off = torch.clamp(kv_len - 48, min=0)
    got = flash_attention_paged(q, kp, vp, table, off, kv_len, ks, vs,
                                buf_len=buf)
    assert torch.equal(got, flash_attention(q, *view[:2], off, kv_len,
                                            *view[2:]))


@pytest.mark.cuda
def test_paged_fused_round_syncs_equal_contiguous_on_card(cuda):
    """One paged kv_fused round waits on the card as the contiguous
    round does: no draft sync, one fetch."""
    cfg = ModelConfig(**dict(TKW, d_model=128, num_heads=6, num_kv_heads=2,
                             head_dim=64, d_ff=256, vocab_size=300))
    gen = torch.Generator(device=cuda).manual_seed(0)
    from repro_torch.models import init_params
    target = (init_params(gen, cfg, cuda), cfg)
    drafter = (init_params(gen, cfg.replace(num_layers=1), cuda),
               cfg.replace(num_layers=1))
    waits = []
    for paged in (False, True):
        sd = SpecDecConfig(num_drafts=4, draft_len=3,
                           verifier_backend="kernel", decode_kernel=True,
                           prefill_kernel=True, paged=paged)
        eng = CachedSpecDecEngine(target, drafter, sd, pool_slots=2,
                                  pool_pages=64 if paged else None,
                                  device=cuda)
        prompts = [np.arange(1, 40, dtype=np.int32),
                   np.arange(5, 70, dtype=np.int32)]
        eng.admit_batch(list(zip("ab", prompts)), 96)
        eng._block_fused([R.PRNGKey(1), R.PRNGKey(2)], ["a", "b"])
        ds0 = eng.num_draft_syncs
        outs = eng._block_fused([R.PRNGKey(3), R.PRNGKey(4)], ["a", "b"])
        waits.append((eng.num_draft_syncs - ds0,
                      sum(o.verify_syncs for o in outs)))
    assert waits[0] == waits[1] == (0, 1)
