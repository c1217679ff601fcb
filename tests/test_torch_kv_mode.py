"""The port's host-driven ``kv`` cache mode and dense serving calls
against the JAX package on the CPU.

* the dense ``prefill`` / ``decode_step`` / ``verify_step`` (logits,
  caches, ``pos``), ``verify_step`` against a ``decode_step`` sequence,
  ``chunked_attention`` (ragged last block, ``q_offset``, a fully masked
  row, GQA groups), ``forward`` and ``prefill`` past 2,048 tokens, and
  ``verify_step_q``;
* ``CachePool.write_prefill`` (float32 and int8), ``rollback_rows`` with
  an aliasing ``row_src``, ``row_positions``;
* ``CachedSpecDecEngine``'s host-driven round: JAX's token streams for
  the six strategies and the three verifier backends, float32 and
  quant, bucketed and per-request admission; equal to the port's fused
  round and reference engine; JAX's sync accounting; the prefix-tail and
  buffer errors; ephemeral sessions;
* ``SpecDecServer(cache_mode="kv")`` per uid against JAX's kv server and
  the port's kv_fused server, per-request admission against bucketed,
  and ``launch/serve.py --cache-mode kv``.

Logits are held to 1e-5 (float32 summation order); token streams are
compared exactly.  JAX is imported inside the CPU fixtures only, so the
``cuda``-marked tests also run where there is no JAX.
"""

import dataclasses
import types

import numpy as np
import pytest
import torch

from repro_torch import random as R
from repro_torch.device import SyncCounter
from repro_torch.models import CachePool, ModelConfig, params_from_jax
from repro_torch.models import layers as TL
from repro_torch.models import transformer as TT
from repro_torch.serving import quantize_params, verify_step_q
from repro_torch.specdec import (
    STRATEGIES,
    CachedSpecDecEngine,
    SpecDecConfig,
    SpecDecEngine,
    SpecDecServer,
)

KW = dict(name="t", family="dense", num_layers=2, d_model=64, num_heads=6,
          num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=300,
          dtype="float32")
DKW = {**KW, "name": "d", "num_layers": 1}
SINGLE = ("single", "daliri")
JAX_BACKEND = {"torch": "xla", "kernel": "pallas", "legacy": "legacy"}


@pytest.fixture(scope="module")
def J():
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.models import ModelConfig as JCfg
    from repro.models import init_params
    from repro.models import cache_pool, layers, transformer
    from repro.serving import quant
    from repro.specdec import CachedSpecDecEngine as Engine
    from repro.specdec import SpecDecConfig as Config
    from repro.specdec import SpecDecServer as Server
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, Cfg=JCfg, init=init_params, pool=cache_pool,
        L=layers, T=transformer, quant=quant, Engine=Engine, Config=Config,
        Server=Server)


@pytest.fixture(scope="module")
def pair(J):
    jt, jd = J.Cfg(**KW), J.Cfg(**DKW)
    jtp = J.init(J.jax.random.PRNGKey(0), jt)
    jdp = J.init(J.jax.random.PRNGKey(1), jd)
    conv = lambda p: params_from_jax(J.jax.tree_util.tree_map(np.asarray, p),
                                     device="cpu")
    return {"jax": ((jtp, jt), (jdp, jd)),
            "torch": ((conv(jtp), ModelConfig(**KW)),
                      (conv(jdp), ModelConfig(**DKW)))}


def _np(x):
    return np.asarray(x)


# ---------------------------------------------------------------------------
# Dense serving calls and chunked attention
# ---------------------------------------------------------------------------


def test_dense_calls_match_jax(J, pair):
    """prefill of 8 tokens, one decode_step, a 3-token verify_step:
    logits within 1e-5, equal caches and positions."""
    (jp, jc), _ = pair["jax"]
    (tp, tc), _ = pair["torch"]
    toks = np.random.RandomState(0).randint(0, 300, (3, 12)).astype(np.int32)
    jcache = J.T.init_cache(jc, 3, 20)
    tcache = TT.init_cache(tc, 3, 20, "cpu")
    assert tcache["pos"] == int(jcache["pos"]) == 0
    assert TT.cache_len(tc, 20) == J.T.cache_len(jc, 20)
    steps = [(J.T.prefill, TT.prefill, lambda t: {"tokens": t}, 0, 8),
             (J.T.decode_step, TT.decode_step, lambda t: t, 8, 9),
             (J.T.verify_step, TT.verify_step, lambda t: t, 9, 12)]
    for jf, tf, wrap, a, b in steps:
        jl, jcache = jf(jp, jc, wrap(J.jnp.asarray(toks[:, a:b])), jcache)
        tl, tcache = tf(tp, tc, wrap(torch.from_numpy(toks[:, a:b])),
                        tcache)
        np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-5, rtol=0)
        for kk in ("k", "v"):
            np.testing.assert_allclose(tcache[kk].numpy(), _np(jcache[kk]),
                                       atol=1e-5, rtol=0)
        assert tcache["pos"] == int(jcache["pos"]) == b


def test_verify_step_bit_exact_vs_decode(pair):
    """``test_decode_consistency.py::test_verify_step_bit_exact_vs_decode``
    on the port: a 5-token verify_step gives the logits of 5 decode_steps
    (1e-5) and the same position."""
    (tp, tc), _ = pair["torch"]
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, 300, (2, 12)).astype(np.int32))
    _, c1 = TT.prefill(tp, tc, {"tokens": toks[:, :6]},
                       TT.init_cache(tc, 2, 64, "cpu"))
    c2 = {"k": c1["k"].clone(), "v": c1["v"].clone(), "pos": c1["pos"]}
    outs = []
    for i in range(6, 11):
        lg, c1 = TT.decode_step(tp, tc, toks[:, i:i + 1], c1)
        outs.append(lg)
    got, c2 = TT.verify_step(tp, tc, toks[:, 6:11], c2)
    np.testing.assert_allclose(got.numpy(), torch.stack(outs, 1).numpy(),
                               atol=1e-5, rtol=0)
    assert c1["pos"] == c2["pos"] == 11


# (b, h, hkv, s, t, d, q_offset, causal): a ragged last block; queries at
# the end of a two-block sequence; q_offset -1 (row 0 sees no key: a
# fully masked row, zero out); the non-causal stream, group 2.
CHUNKED_CASES = [(2, 6, 2, 5, 1500, 16, 1495, True),
                 (1, 4, 4, 7, 2100, 8, 2093, True),
                 (1, 6, 2, 4, 1030, 16, -1, True),
                 (2, 6, 3, 9, 1030, 16, 3, False)]


@pytest.mark.parametrize("b,h,hkv,s,t,d,off,causal", CHUNKED_CASES)
def test_chunked_attention_matches_jax_and_attention(J, b, h, hkv, s, t, d,
                                                     off, causal):
    rng = np.random.RandomState(t + s)
    q = rng.randn(b, h, s, d).astype(np.float32)
    k, v = (rng.randn(b, hkv, t, d).astype(np.float32) for _ in range(2))
    j = J.L.chunked_attention(J.jnp.asarray(q), J.jnp.asarray(k),
                              J.jnp.asarray(v), causal=causal, q_offset=off)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    got = TL.chunked_attention(qt, kt, vt, causal=causal, q_offset=off)
    dense = TL.attention(qt, kt, vt, causal=causal, q_offset=off)
    np.testing.assert_allclose(got.numpy(), _np(j), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), atol=1e-5, rtol=0)
    if off < 0:
        assert not got[:, :, 0].any()


def test_forward_and_prefill_past_2048_match_jax(J):
    """At 2,049 and 2,100 tokens ``forward`` and ``prefill`` take the
    chunked attention on both sides (a 1-layer model of width 32)."""
    kw = dict(KW, num_layers=1, d_model=32, num_heads=4, head_dim=8,
              d_ff=64)
    jc, tc = J.Cfg(**kw), ModelConfig(**kw)
    jp = J.init(J.jax.random.PRNGKey(3), jc)
    tp = params_from_jax(J.jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    toks = np.random.RandomState(2).randint(0, 300, (1, 2100)).astype(
        np.int32)
    jl = J.T.forward(jp, jc, {"tokens": J.jnp.asarray(toks)}, remat=False)
    tl = TT.forward(tp, tc, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        TT.forward(tp, tc, {"tokens": torch.from_numpy(toks)},
                   chunked=False).numpy(), tl.numpy(), atol=1e-5, rtol=0)
    jl, jcache = J.T.prefill(jp, jc, {"tokens": J.jnp.asarray(toks[:, :2049])},
                             J.T.init_cache(jc, 1, 2060))
    tl, tcache = TT.prefill(tp, tc, {"tokens": torch.from_numpy(
        toks[:, :2049])}, TT.init_cache(tc, 1, 2060, "cpu"))
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-5, rtol=0)
    np.testing.assert_allclose(tcache["k"].numpy(), _np(jcache["k"]),
                               atol=1e-5, rtol=0)
    assert tcache["pos"] == int(jcache["pos"]) == 2049


def test_verify_step_q_matches_jax(J, pair):
    """The W8A8 verify chunk: on the CPU ``qdot`` is JAX's float32
    emulation on both sides, so the logits agree to 1e-5."""
    (jp, jc), _ = pair["jax"]
    (tp, tc), _ = pair["torch"]
    toks = np.random.RandomState(4).randint(0, 300, (2, 12)).astype(np.int32)
    _, jcache = J.T.prefill(jp, jc, {"tokens": J.jnp.asarray(toks[:, :7])},
                            J.T.init_cache(jc, 2, 16))
    _, tcache = TT.prefill(tp, tc, {"tokens": torch.from_numpy(toks[:, :7])},
                           TT.init_cache(tc, 2, 16, "cpu"))
    jl, jcache = J.quant.verify_step_q(J.quant.quantize_params(jp), jc,
                                       J.jnp.asarray(toks[:, 7:12]), jcache)
    tl, tcache = verify_step_q(quantize_params(tp), tc,
                               torch.from_numpy(toks[:, 7:12]), tcache)
    np.testing.assert_allclose(tl.numpy(), _np(jl), atol=1e-5, rtol=0)
    assert tcache["pos"] == int(jcache["pos"]) == 12


# ---------------------------------------------------------------------------
# CachePool
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("quant", [False, True])
def test_cache_pool_ops_match_jax(J, pair, quant):
    """write_prefill into slots 0 and 1 (quantized on install for an
    int8 pool), the per-row positions with slot 2 free, then a rollback
    whose ``row_src`` aliases: row 5 reads row 0, which row 0's own
    gather replaces (an in-place gather would hand row 5 row 2)."""
    (jp, jc), _ = pair["jax"]
    (tp, tc), _ = pair["torch"]
    jpool = J.pool.CachePool({"target": jc}, num_slots=3, rows_per_slot=2,
                             buf_len=12, quant=quant)
    tpool = CachePool({"target": tc}, num_slots=3, rows_per_slot=2,
                      buf_len=12, device="cpu", quant=quant)
    toks = np.random.RandomState(5).randint(0, 300, (2, 6)).astype(np.int32)
    for slot in (0, 1):
        assert jpool.alloc() == tpool.alloc() == slot
        _, jc_ = J.T.prefill(jp, jc, {"tokens": J.jnp.asarray(toks + slot)},
                             J.T.init_cache(jc, 2, 12))
        _, tc_ = TT.prefill(tp, tc, {"tokens": torch.from_numpy(toks + slot)},
                            TT.init_cache(tc, 2, 12, "cpu"))
        jpool.write_prefill("target", slot, jc_, pos=6 - slot)
        tpool.write_prefill("target", slot, tc_, pos=6 - slot)
    assert tpool.num_free == jpool.num_free == 1
    np.testing.assert_array_equal(tpool.row_positions(),
                                  jpool.row_positions())
    row_src = np.array([2, 3, 2, 3, 4, 0])
    before = tpool.caches["target"]["k"].clone()
    jpool.rollback_rows(row_src)
    tpool.rollback_rows(row_src)
    for kk, leaf in tpool.caches["target"].items():
        want = _np(jpool.caches["target"][kk])
        if leaf.dtype == torch.int8:
            np.testing.assert_array_equal(leaf.numpy(), want)
        else:
            np.testing.assert_allclose(leaf.numpy(), want, atol=1e-5, rtol=0)
    assert torch.equal(tpool.caches["target"]["k"][:, 5], before[:, 0])
    assert set(tpool.caches["target"]) == (
        {"k", "v", "k_s", "v_s"} if quant else {"k", "v"})


# ---------------------------------------------------------------------------
# The host-driven round against JAX's
# ---------------------------------------------------------------------------


def _engines(J, pair, k, quant, batched_admission, strategy="gls",
             backend="kernel", pool_slots=1, kernels=False):
    (jtp, jt), (jdp, jd) = pair["jax"]
    (ttp, tt), (tdp, td) = pair["torch"]
    kw = dict(num_drafts=k, draft_len=3, strategy=strategy, quant=quant,
              max_new_tokens=8, decode_kernel=kernels,
              prefill_kernel=kernels)
    je = J.Engine((jtp, jt), (jdp, jd),
                  J.Config(**kw, verifier_backend=JAX_BACKEND[backend]),
                  pool_slots=pool_slots, batched_admission=batched_admission)
    te = CachedSpecDecEngine((ttp, tt), (tdp, td),
                             SpecDecConfig(**kw, verifier_backend=backend),
                             pool_slots=pool_slots,
                             batched_admission=batched_admission,
                             device="cpu")
    return je, te


def _set(engine, backend, strategy):
    engine.cfg = dataclasses.replace(engine.cfg, verifier_backend=backend,
                                     strategy=strategy)


@pytest.fixture(scope="module")
def engine_pairs(J, pair):
    """One (JAX, port) engine pair per (K, quant, batched admission),
    shared by the stream tests (the JAX engine jits per instance)."""
    cache = {}

    def get(k, quant, batched):
        if (k, quant, batched) not in cache:
            cache[k, quant, batched] = _engines(J, pair, k, quant, batched)
        return cache[k, quant, batched]
    return get


# (backend, quant, batched admission): the three backends on float32
# arenas and bucketed admission, then int8 arenas (W8A8 verify) under
# both admissions and per-request admission on float32 arenas.
STREAM_RUNS = [("torch", False, True), ("kernel", False, True),
               ("legacy", False, True), ("kernel", True, True),
               ("legacy", True, False), ("torch", False, False)]


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_kv_round_streams_match_jax(J, engine_pairs, strategy):
    """``generate(fused=False)``: JAX's tokens, accepted counts and
    verify syncs per run, and JAX's draft syncs, draft forwards and
    prefill dispatches per engine.  Two drafts for every strategy (the
    single-draft ones read draft 0), so the engines are shared."""
    prompt = np.array([3, 1, 4, 1, 5, 9, 2], np.int32)
    counters = ("num_draft_syncs", "num_draft_forwards",
                "num_prefill_dispatches")
    for i, (backend, quant, batched) in enumerate(STREAM_RUNS):
        je, te = engine_pairs(2, quant, batched)
        before = [(getattr(je, c), getattr(te, c)) for c in counters]
        _set(je, JAX_BACKEND[backend], strategy)
        _set(te, backend, strategy)
        jo = je.generate(J.jax.random.PRNGKey(20 + i), prompt)
        to = te.generate(R.PRNGKey(20 + i), prompt)
        run = (backend, quant, batched)
        np.testing.assert_array_equal(to.output, jo.output, err_msg=str(run))
        assert (to.blocks, to.accepted_drafts, to.host_syncs) == (
            jo.blocks, jo.accepted_drafts, jo.host_syncs), run
        for c, (j0, t0) in zip(counters, before):
            assert getattr(te, c) - t0 == getattr(je, c) - j0 > 0, (c, run)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_kv_round_equals_fused_and_reference(pair, strategy):
    """The host-driven round gives the fused round's tokens, and the
    reference engine's (``test_engine_cached.py::
    test_cached_engine_matches_reference``), with the kernel routes on
    (their plain versions here) for both cached rounds."""
    (ttp, tt), (tdp, td) = pair["torch"]
    k = 1 if strategy in SINGLE else 2
    cfg = SpecDecConfig(num_drafts=k, draft_len=3, strategy=strategy,
                        max_new_tokens=8, verifier_backend="kernel",
                        decode_kernel=True, prefill_kernel=True)
    cached = CachedSpecDecEngine((ttp, tt), (tdp, td), cfg, device="cpu")
    ref = SpecDecEngine((ttp, tt), (tdp, td), cfg, device="cpu")
    prompt = np.array([2, 7, 1, 8, 2, 8], np.int32)
    kv = cached.generate(R.PRNGKey(30), prompt)
    fused = cached.generate(R.PRNGKey(30), prompt, fused=True)
    np.testing.assert_array_equal(kv.output, fused.output)
    np.testing.assert_array_equal(
        kv.output, ref.generate(R.PRNGKey(30), prompt).output)


def test_kv_sync_accounting_and_errors(pair):
    """One verify fetch per block and L draft fetches per round
    (``test_engine_cached.py:80-91``); the prefix-tail and past-buffer
    errors; ephemeral sessions leave the pool free; the legacy backend
    is refused by the fused round only."""
    (ttp, tt), (tdp, td) = pair["torch"]
    cfg = SpecDecConfig(num_drafts=4, draft_len=3, strategy="gls",
                        max_new_tokens=12, verifier_backend="torch")
    eng = CachedSpecDecEngine((ttp, tt), (tdp, td), cfg, pool_slots=2,
                              device="cpu")
    o = eng.generate(R.PRNGKey(3), np.array([1, 2, 3], np.int32))
    assert o.host_syncs == o.blocks
    assert eng.num_draft_syncs == o.blocks * cfg.draft_len
    prefix = np.array([1, 2, 3], np.int32)
    out = eng.gen_block(R.PRNGKey(0), prefix, 16, uid=1)
    good = np.concatenate([prefix, np.asarray(out.new_tokens, np.int32)])
    bad = np.concatenate([good, [int(good[-1]) + 1]]).astype(np.int32)
    with pytest.raises(AssertionError, match="pending"):
        eng.gen_block(R.PRNGKey(1), bad, 16, uid=1)
    eng.gen_block(R.PRNGKey(1), good, 16, uid=1)
    with pytest.raises(AssertionError, match="larger buf_len"):
        eng.gen_blocks([R.PRNGKey(2)], [np.arange(1, 19, dtype=np.int32)],
                       16, uids=[2])
    eng.release(1)
    eng.release(2)
    for fused in (False, True):
        eng.gen_blocks([R.PRNGKey(4), R.PRNGKey(5)],
                       [prefix, prefix[:2]], 16, fused=fused)
        assert eng.pool.num_free == 2 and not eng._sessions
    legacy = CachedSpecDecEngine(
        (ttp, tt), (tdp, td),
        dataclasses.replace(cfg, verifier_backend="legacy"), device="cpu")
    assert len(legacy.generate(R.PRNGKey(6), prefix).output) == 12
    with pytest.raises(ValueError, match="legacy"):
        legacy.generate(R.PRNGKey(6), prefix, fused=True)


# ---------------------------------------------------------------------------
# The server's kv mode
# ---------------------------------------------------------------------------


PROMPTS = [np.random.RandomState(3 + i).randint(0, 300, n).astype(np.int32)
           for i, n in enumerate((5, 17, 40, 70))]


def _serve(te, cache_mode, admission, max_batch=2):
    ts = SpecDecServer(te, max_batch=max_batch, cache_mode=cache_mode,
                       admission=admission)
    for p in PROMPTS:
        ts.submit(p, max_new=8)
    return ts, {r.uid: r.output for r in ts.run(R.PRNGKey(0))}


def test_server_kv_matches_jax_and_kv_fused(J, pair):
    """Four requests (buckets 16, 32, 64 and a 70-token prompt chunked
    past the 64 bucket) on two slots: per-uid streams equal JAX's kv
    server, the port's kv_fused server and its per-request kv server; the
    kv accounting is L draft fetches a round and one verify fetch per
    advanced request."""
    je, te = _engines(J, pair, 2, False, True, pool_slots=2, kernels=True)
    js = J.Server(je, max_batch=2, cache_mode="kv")
    for p in PROMPTS:
        js.submit(p, max_new=8)
    jdone = {r.uid: r.output for r in js.run(J.jax.random.PRNGKey(0))}
    ts, kv = _serve(te, "kv", "bucketed")
    assert kv == jdone
    m = ts.metrics
    assert (m.rounds, m.host_syncs, m.draft_syncs) == (
        js.metrics.rounds, js.metrics.host_syncs, js.metrics.draft_syncs)
    assert m.draft_syncs == 3 * m.rounds
    assert m.host_syncs == m.total_blocks
    assert te.pool.num_free == 2
    assert _serve(te, "kv_fused", "bucketed")[1] == kv
    assert _serve(te, "kv", "per_request")[1] == kv


def test_server_kv_rejects_reference_engine_and_unknown_modes(pair):
    (ttp, tt), (tdp, td) = pair["torch"]
    cfg = SpecDecConfig(num_drafts=2, draft_len=2)
    ref = SpecDecEngine((ttp, tt), (tdp, td), cfg, device="cpu")
    with pytest.raises(TypeError, match="CachedSpecDecEngine"):
        SpecDecServer(ref, cache_mode="kv")
    cached = CachedSpecDecEngine((ttp, tt), (tdp, td), cfg, pool_slots=1,
                                 device="cpu")
    with pytest.raises(ValueError, match="slots"):
        SpecDecServer(cached, max_batch=4, cache_mode="kv")
    with pytest.raises(ValueError, match="unknown admission"):
        SpecDecServer(cached, max_batch=1, cache_mode="kv",
                      admission="eager")


def test_serve_cli_kv_per_request(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "smollm-360m", "--target-layers", "1",
                "--draft-layers", "1", "--requests", "2", "--max-new", "2",
                "--drafts", "2", "--draft-len", "2", "--max-batch", "2",
                "--cache-mode", "kv", "--admission", "per_request",
                "--backend", "legacy", "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert "cache_mode=kv admission=per_request" in line
    assert "over 2 requests" in line


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kv round's kernels and its "
                    "waits are the card's")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("h,hkv,d", [(15, 5, 64), (32, 8, 128)])
def test_chunked_attention_matches_attention_on_card(cuda, h, hkv, d):
    """smollm-360m's and granite-8b's attention widths, 2,300 keys."""
    gen = torch.Generator(device=cuda).manual_seed(d)
    q = torch.randn(1, h, 2300, d, device=cuda, generator=gen)
    k, v = (torch.randn(1, hkv, 2300, d, device=cuda, generator=gen)
            for _ in range(2))
    got = TL.chunked_attention(q, k, v, causal=True)
    want = TL.attention(q, k, v, causal=True)
    assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_kv_round_syncs_on_card(cuda):
    """A 2-layer pair at head dim 64 with the kernel routes: the host
    waits L times in a round's sweeps and once per request in its
    verification, nowhere else."""
    cfg = ModelConfig(**dict(KW, d_model=128, num_heads=6, num_kv_heads=2,
                             head_dim=64, d_ff=256))
    gen = torch.Generator(device=cuda).manual_seed(0)
    from repro_torch.models import init_params
    target = (init_params(gen, cfg, cuda), cfg)
    drafter = (init_params(gen, cfg.replace(num_layers=1), cuda),
               cfg.replace(num_layers=1))
    eng = CachedSpecDecEngine(target, drafter,
                              SpecDecConfig(num_drafts=4, draft_len=3,
                                            verifier_backend="kernel",
                                            decode_kernel=True,
                                            prefill_kernel=True),
                              pool_slots=2, device=cuda)
    server = SpecDecServer(eng, max_batch=2, cache_mode="kv")
    for p in PROMPTS[:3]:
        server.submit(p, max_new=12)
    server.run(R.PRNGKey(0))
    m = server.metrics
    assert m.draft_syncs == 3 * m.rounds
    assert m.host_syncs == m.total_blocks


@pytest.mark.cuda
def test_rollback_rows_aliasing_on_card(cuda):
    cfg = ModelConfig(**KW)
    pool = CachePool({"t": cfg}, num_slots=3, rows_per_slot=2, buf_len=8,
                     device=cuda)
    for leaf in pool.caches["t"].values():
        leaf.copy_(torch.arange(6, device=cuda, dtype=leaf.dtype)[
            None, :, None, None, None].expand_as(leaf))
    row_src = np.array([3, 3, 2, 3, 5, 0])
    with SyncCounter(cuda) as waits:
        pool.rollback_rows(row_src)
    assert waits.count == 0
    want = torch.tensor(row_src, dtype=torch.float32)
    assert torch.equal(pool.caches["t"]["k"][0, :, 0, 0, 0].cpu(), want)
