"""The RG-LRU hybrid family (recurrentgemma) in the port against the JAX
package on the CPU, and the sliding window of the attention layers.

* The config equals JAX's field by field, and ``reduced()`` gives JAX's
  smoke variant (3 layers: one unit, window 64).
* ``rg_lru_scan`` (a log-depth scan of JAX's combine in float32, another
  summation order than JAX's ``associative_scan``) within atol 1e-5 of
  JAX's, with and without ``h0``; ``rg_lru_step`` within atol 1e-6.
* ``params_from_jax`` for the hybrid tree (the units' stacked recurrent
  blocks plus one attention block, and ``extra_rec``) and for the MoE
  tree carry every leaf bit for bit.
* ``recurrentgemma-2b.reduced()`` and a narrower 5-layer variant (one
  unit, two trailing recurrent blocks) through the registry: ``forward``,
  ``prefill`` of 70 tokens (the 64-key window wraps the ring) and 8
  ``decode_step`` calls against JAX's, logits and every cache leaf
  within atol 1e-5.
* The reference engine with a hybrid target emits JAX's token streams
  (``tests/test_specdec_families.py``'s geometry) with a dense and a
  hybrid drafter, exactly.
* ``window`` in ``layers.attention`` and ``layers.chunked_attention``
  against JAX's (causal and not, q offsets, kv_len, a ragged block)
  within atol 1e-6, and a windowed call takes no kernel route."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get
from repro.models import ModelConfig as JCfg
from repro.models import decode_step as j_decode
from repro.models import forward as j_forward
from repro.models import init_cache as j_cache
from repro.models import init_params as j_init
from repro.models import layers as JL
from repro.models import prefill as j_prefill
from repro.models import rglru as JG
from repro.specdec import SpecDecConfig as JConfig
from repro.specdec import SpecDecEngine as JEngine
from repro_torch import random as R
from repro_torch.configs import get_config
from repro_torch.models import ModelConfig, params_from_jax
from repro_torch.models import layers as TL
from repro_torch.models import registry as TR
from repro_torch.models import rglru as TG
from repro_torch.specdec import SpecDecConfig, SpecDecEngine

ATOL = 1e-5
STEP_ATOL = 1e-6
ATTN_ATOL = 1e-6
ARCH = "recurrentgemma-2b"


def _conv(p):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, p),
                           device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def test_config_and_reduced_match_jax():
    ours, theirs = get_config(ARCH), j_get(ARCH)
    assert ours.family == "hybrid" and ours.dtype == "float32"
    for o, t in ((ours, theirs), (ours.reduced(), theirs.reduced())):
        for field in ("name", "family", "num_layers", "d_model",
                      "num_heads", "num_kv_heads", "head_dim", "d_ff",
                      "vocab_size", "rope_theta", "norm_eps", "pattern_rec",
                      "local_window", "lru_width", "max_seq_len",
                      "resolved_head_dim", "kv_heads", "padded_vocab"):
            assert getattr(o, field) == getattr(t, field), field
    assert TG.layout(ours) == JG.layout(theirs) == (8, 2)
    assert TG.layout(ours.reduced()) == (1, 0)


def _lru_params(w, seed):
    rng = np.random.RandomState(seed)
    return {"lru_wa": (rng.randn(w, w) / np.sqrt(w)).astype(np.float32),
            "lru_wx": (rng.randn(w, w) / np.sqrt(w)).astype(np.float32),
            "lru_lambda": rng.uniform(-1, 2, w).astype(np.float32)}


@pytest.mark.parametrize("s", [1, 2, 7, 64, 130])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rg_lru_scan_matches_jax(s, with_h0):
    w = 32
    p = _lru_params(w, s)
    rng = np.random.RandomState(s + 1)
    x = rng.randn(2, s, w).astype(np.float32)
    h0 = rng.randn(2, w).astype(np.float32) if with_h0 else None
    jy, jh = JG.rg_lru_scan(jax.tree_util.tree_map(jnp.asarray, p),
                            jnp.asarray(x),
                            None if h0 is None else jnp.asarray(h0))
    ty, th = TG.rg_lru_scan(jax.tree_util.tree_map(_t, p), _t(x),
                            None if h0 is None else _t(h0))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0,
                               atol=ATOL)


def test_rg_lru_step_matches_jax_and_the_scan():
    w = 32
    p = _lru_params(w, 3)
    rng = np.random.RandomState(4)
    x = rng.randn(2, 5, w).astype(np.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    tp = jax.tree_util.tree_map(_t, p)
    jh = jnp.zeros((2, w), jnp.float32)
    th = torch.zeros((2, w))
    for i in range(5):
        jy, jh = JG.rg_lru_step(jp, jnp.asarray(x[:, i:i + 1]), jh)
        ty, th = TG.rg_lru_step(tp, _t(x[:, i:i + 1]), th)
        np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=0,
                                   atol=STEP_ATOL)
        np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0,
                                   atol=STEP_ATOL)
    _, hs = TG.rg_lru_scan(tp, _t(x))
    np.testing.assert_allclose(hs.numpy(), th.numpy(), rtol=0, atol=ATOL)


# The reduced config (one unit) and one with two trailing recurrent
# blocks (recurrentgemma-2b's layout at the smallest depth).
CASES = {"reduced": dict(),
         "extra_rec": dict(num_layers=5, d_model=128, lru_width=128,
                           d_ff=256)}


@pytest.fixture(scope="module", params=sorted(CASES))
def model(request):
    kw = CASES[request.param]
    jcfg = j_get(ARCH).reduced().replace(**kw)
    tcfg = get_config(ARCH).reduced().replace(**kw)
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, _conv(jp)


def test_params_from_jax_hybrid_tree(model):
    jcfg, tcfg, jp, tp = model
    n_units, extra = TG.layout(tcfg)
    assert len(tp["units"]) == n_units and len(tp["extra_rec"]) == extra
    for u, unit in enumerate(tp["units"]):
        assert len(unit["rec"]) == jcfg.pattern_rec
        for r, block in enumerate(unit["rec"]):
            for leaf in ("w_x", "w_gate", "conv_w", "conv_b", "lru_wa",
                         "lru_wx", "lru_lambda", "w_out"):
                np.testing.assert_array_equal(
                    block[leaf].numpy(),
                    np.asarray(jp["units"]["rec"][leaf][u, r]))
            np.testing.assert_array_equal(
                block["mlp"]["w_down"].numpy(),
                np.asarray(jp["units"]["rec"]["mlp"]["w_down"][u, r]))
        np.testing.assert_array_equal(
            unit["attn"]["attn"]["wq"].numpy(),
            np.asarray(jp["units"]["attn"]["attn"]["wq"][u]))
    for e, block in enumerate(tp["extra_rec"]):
        np.testing.assert_array_equal(
            block["lru_wa"].numpy(), np.asarray(jp["extra_rec"]["lru_wa"][e]))


def test_forward_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    toks = np.random.RandomState(1).randint(0, jcfg.vocab_size,
                                            (2, 90)).astype(np.int32)
    jl = j_forward(jp, jcfg, {"tokens": jnp.asarray(toks)}, remat=False)
    tl = TR.forward(tp, tcfg, {"tokens": _t(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL)


def _cache_leaves(c):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            c, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]:
        if isinstance(leaf, (int, np.integer)) or np.ndim(leaf) == 0:
            continue
        out[jax.tree_util.keystr(path)] = np.asarray(leaf)
    return out


def test_prefill_and_decode_match_jax(model):
    """``prefill`` of 70 tokens into a cache for 100 (window 64: the ring
    wraps), then 8 ``decode_step`` calls: logits and every cache leaf
    (conv and RG-LRU states, the ring) against JAX's at every step."""
    jcfg, tcfg, jp, tp = model
    toks = np.random.RandomState(2).randint(0, jcfg.vocab_size,
                                            (2, 78)).astype(np.int32)
    jc = j_cache(jcfg, 2, 100)
    tc = TR.init_cache(tcfg, 2, 100, "cpu")
    assert tc["units"]["attn"]["k"].shape[3] == 64
    jl, jc = j_prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :70])}, jc)
    tl, tc = TR.prefill(tp, tcfg, {"tokens": _t(toks[:, :70])}, tc)
    for i in range(70, 79):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL)
        want, got = _cache_leaves(jc), _cache_leaves(tc)
        if not TG.layout(tcfg)[1]:
            want = {k: v for k, v in want.items() if "extra_rec" not in k}
            got = {k: v for k, v in got.items() if "extra_rec" not in k}
        assert sorted(want) == sorted(got)
        for name in want:
            np.testing.assert_allclose(got[name], want[name], rtol=0,
                                       atol=ATOL, err_msg=name)
        assert int(tc["pos"]) == int(jc["pos"]) == i
        if i == 78:
            break
        jl, jc = j_decode(jp, jcfg, jnp.asarray(toks[:, i:i + 1]), jc)
        tl, tc = TR.decode_step(tp, tcfg, _t(toks[:, i:i + 1]), tc)


# tests/test_specdec_families.py:13-33: the dense drafter, hybrid target.
DRAFTER = dict(name="d", family="dense", num_layers=1, d_model=48,
               num_heads=4, num_kv_heads=2, head_dim=12, d_ff=96,
               vocab_size=64, dtype="float32")
TARGET = dict(name="th", family="hybrid", num_layers=3, d_model=64,
              num_heads=4, num_kv_heads=1, head_dim=16, d_ff=128,
              vocab_size=64, pattern_rec=2, local_window=16, lru_width=64,
              dtype="float32")


@pytest.mark.parametrize("drafter", ["dense", "hybrid"])
def test_reference_engine_streams_match_jax(drafter):
    """A 3-block hybrid target (window 16, so a 20-token stream wraps its
    ring) with a dense or a hybrid drafter: JAX's tokens."""
    pairs = []
    for kw, seed in ((TARGET, 0),
                     (DRAFTER if drafter == "dense" else TARGET, 1)):
        jp = j_init(jax.random.PRNGKey(seed), JCfg(**kw))
        pairs.append(((jp, JCfg(**kw)), (_conv(jp), ModelConfig(**kw))))
    kw = dict(num_drafts=2, draft_len=2, strategy="gls", top_k=0,
              max_new_tokens=12)
    je = JEngine(pairs[0][0], [pairs[1][0]],
                 JConfig(verifier_backend="pallas", **kw))
    te = SpecDecEngine(pairs[0][1], pairs[1][1],
                       SpecDecConfig(verifier_backend="kernel", **kw),
                       device="cpu")
    prompt = np.arange(1, 9, dtype=np.int32)
    jo = je.generate(jax.random.PRNGKey(5), prompt)
    to = te.generate(R.PRNGKey(5), prompt)
    np.testing.assert_array_equal(jo.output, to.output)
    assert (jo.blocks, jo.accepted_drafts) == (to.blocks, to.accepted_drafts)
    assert len(to.output) == 12


def test_hybrid_refuses_cached_serving():
    from repro_torch.launch.serve import check_cache_mode
    for mode in ("kv", "kv_fused"):
        with pytest.raises(ValueError, match="reprefill"):
            check_cache_mode(ARCH, mode)
    check_cache_mode(ARCH, "reprefill")


# ---------------------------------------------------------------------------
# The sliding window of the attention layers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal,q_offset,kv_len,window", [
    (True, 0, None, 5), (True, 0, None, 1), (True, 3, 30, 8),
    (False, 10, 25, 6), (True, 0, None, 100)])
def test_attention_window_matches_jax(causal, q_offset, kv_len, window):
    rng = np.random.RandomState(window)
    q = rng.randn(2, 4, 12, 16).astype(np.float32)
    k, v = (rng.randn(2, 2, 30, 16).astype(np.float32) for _ in range(2))
    want = JL.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                        causal=causal, q_offset=q_offset, kv_len=kv_len,
                        window=window)
    got = TL.attention(_t(q), _t(k), _t(v), causal=causal,
                       q_offset=q_offset, kv_len=kv_len, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATTN_ATOL)


@pytest.mark.parametrize("causal,q_offset,window,kv_block", [
    (True, 0, 7, 16), (True, 20, 40, 32), (False, 0, 9, 16),
    (True, 0, 64, 64)])
def test_chunked_attention_window_matches_jax(causal, q_offset, window,
                                              kv_block):
    rng = np.random.RandomState(window + kv_block)
    s = 50
    t = s + q_offset
    q = rng.randn(1, 4, s, 16).astype(np.float32)
    k, v = (rng.randn(1, 1, t, 16).astype(np.float32) for _ in range(2))
    want = JL.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=causal,
                                q_offset=q_offset, window=window,
                                kv_block=kv_block)
    got = TL.chunked_attention(_t(q), _t(k), _t(v), causal=causal,
                               q_offset=q_offset, window=window,
                               kv_block=kv_block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATTN_ATOL)
    dense = TL.attention(_t(q), _t(k), _t(v), causal=causal,
                         q_offset=q_offset, window=window)
    np.testing.assert_allclose(got.numpy(), dense.numpy(), rtol=0,
                               atol=ATTN_ATOL)


def test_windowed_attention_takes_no_kernel_route(monkeypatch):
    """With ``use_kernel`` a windowed decode or prefill call still runs
    the dense path (JAX's ``layers.py:164,171``)."""
    import repro_torch.kernels.decode_attention.ops as dops
    import repro_torch.kernels.flash_attention.ops as fops

    def refuse(*a, **kw):
        raise AssertionError("a windowed call took a kernel route")

    monkeypatch.setattr(dops, "decode_attention", refuse)
    monkeypatch.setattr(fops, "flash_attention", refuse)
    rng = np.random.RandomState(0)
    k, v = (_t(rng.randn(2, 1, 20, 16).astype(np.float32))
            for _ in range(2))
    TL.attention(_t(rng.randn(2, 4, 1, 16).astype(np.float32)), k, v,
                 causal=False, kv_len=20, window=8, use_kernel=True)
    TL.attention(_t(rng.randn(2, 4, 5, 16).astype(np.float32)), k, v,
                 causal=True, q_offset=15, window=8, use_kernel=True)
    with pytest.raises(AssertionError, match="kernel route"):
        TL.attention(_t(rng.randn(2, 4, 1, 16).astype(np.float32)), k, v,
                     causal=False, kv_len=20, use_kernel=True)
