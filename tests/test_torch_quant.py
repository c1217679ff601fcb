"""The port's int8 serving path (``repro_torch.serving.quant``, int8
arenas, quantize-on-write, dequantizing attention, W8A8 verify) against
the JAX package on the CPU, on the same numpy inputs.

Tolerances:

* the quantizers (``quantize_kv``, ``quantize_weight``,
  ``quantize_params``) and the CPU ``qdot`` are bit-exact: the same
  float32 operations in the same order (the CPU ``qdot`` is JAX's float32
  emulation of the int8 product, exact at these contraction depths);
* the int8 plain attention matches JAX's interpret-mode kernels and
  references at atol = rtol = 2e-5, the tolerance of
  ``tests/test_quant_fused.py`` (online softmax against one softmax);
* the slot calls on int8 arenas: int8 leaves within one quantum (a value
  that lands within float32 rounding of a .5 boundary may round either
  way, since the keys agree to ~1e-6, not bitwise), scales at rtol 1e-5,
  logits at atol 1e-4 (the model math agrees to ~1e-6; a flipped
  quantum moves an attention read by at most one scale step);
* engine token streams are equal, and the acceptance rate with
  ``quant=True`` stays within 0.2 of float32's (the gate of
  ``tests/test_quant_fused.py:197``).

The configs are those of ``tests/test_quant_fused.py:22-26``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention.kernel import decode_attention as j_decode
from repro.kernels.decode_attention.ref import decode_attention_ref
from repro.kernels.flash_attention.kernel import flash_attention as j_flash
from repro.kernels.flash_attention.ref import flash_attention_ref
from repro.models import CachePool as JPool
from repro.models import ModelConfig as JCfg
from repro.models import init_params as j_init
from repro.models import transformer as JT
from repro.serving import quant as JQ
from repro.specdec import CachedSpecDecEngine as JEngine
from repro.specdec import SpecDecConfig as JConfig
from repro_torch import random as R
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import CachePool, ModelConfig, params_from_jax
from repro_torch.models import transformer as TT
from repro_torch.serving import quant as TQ
from repro_torch.specdec import CachedSpecDecEngine, SpecDecConfig

T_KW = dict(name="t", family="dense", num_layers=2, d_model=64, num_heads=4,
            num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=64,
            dtype="float32")
D_KW = dict(T_KW, name="d", d_model=32, d_ff=64, num_heads=2,
            num_kv_heads=1)
RACE = ("gls", "gls_strong", "daliri")
ATTN_TOL = 2e-5
SCALE_RTOL, LOGIT_ATOL = 1e-5, 1e-4


def _np(x):
    return np.asarray(x)


def _conv(p):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, p),
                           device="cpu")


@pytest.fixture(scope="module")
def pair():
    kt, kd = jax.random.split(jax.random.PRNGKey(0))
    jtp, jdp = j_init(kt, JCfg(**T_KW)), j_init(kd, JCfg(**D_KW))
    return {"jax": ((jtp, JCfg(**T_KW)), (jdp, JCfg(**D_KW))),
            "torch": ((_conv(jtp), ModelConfig(**T_KW)),
                      (_conv(jdp), ModelConfig(**D_KW)))}


# ---------------------------------------------------------------------------
# Quantizers and qdot: bit-exact
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 3, 4, 17, 8), (5, 16), (1, 2, 40, 64)])
def test_quantize_kv_bit_exact(shape):
    rng = np.random.RandomState(len(shape))
    x = (rng.randn(*shape) * rng.uniform(0.01, 30, shape[:-1] + (1,))
         ).astype(np.float32)
    x[(0,) * (len(shape) - 1)] = 0.0            # an all-zero vector
    jq, js = JQ.quantize_kv(jnp.asarray(x))
    tq, ts = TQ.quantize_kv(torch.from_numpy(x))
    assert tq.dtype == torch.int8 and tuple(ts.shape) == shape[:-1] + (1,)
    np.testing.assert_array_equal(tq.numpy(), _np(jq))
    np.testing.assert_array_equal(ts.numpy(), _np(js))
    np.testing.assert_array_equal(
        TQ.dequantize_kv(tq, ts).numpy(), _np(JQ.dequantize_kv(jq, js)))


def test_quantize_weight_and_qdot_bit_exact():
    rng = np.random.RandomState(1)
    w = (rng.randn(96, 40) / 8).astype(np.float32)
    w[:, 3] = 0.0                                # an all-zero channel
    jw, tw = JQ.quantize_weight(jnp.asarray(w)), TQ.quantize_weight(
        torch.from_numpy(w))
    np.testing.assert_array_equal(tw["q"].numpy(), _np(jw["q"]))
    np.testing.assert_array_equal(tw["s"].numpy(), _np(jw["s"]))
    x = rng.randn(3, 5, 96).astype(np.float32)
    x[0, 0] = 0.0                                # an all-zero token
    np.testing.assert_array_equal(
        TQ.qdot(torch.from_numpy(x), tw).numpy(),
        _np(JQ.qdot(jnp.asarray(x), jw)))


def test_quantize_params_leaf_by_leaf(pair):
    """The port's per-layer tree against JAX's stacked tree: every
    quantized leaf equal, layer by layer; norms and embeddings kept."""
    (jtp, _), _ = pair["jax"]
    (ttp, _), _ = pair["torch"]
    jq = jax.tree_util.tree_map(np.asarray, JQ.quantize_params(jtp))
    tq = TQ.quantize_params(ttp)
    for name in ("wq", "wk", "wv", "wo"):
        for i, layer in enumerate(tq["layers"]):
            for part in ("q", "s"):
                np.testing.assert_array_equal(
                    layer["attn"][name][part].numpy(),
                    jq["layers"]["attn"][name][part][i])
    for name in ("w_gate", "w_up", "w_down"):
        for i, layer in enumerate(tq["layers"]):
            for part in ("q", "s"):
                np.testing.assert_array_equal(
                    layer["mlp"][name][part].numpy(),
                    jq["layers"]["mlp"][name][part][i])
    for part in ("q", "s"):
        np.testing.assert_array_equal(tq["lm_head"][part].numpy(),
                                      jq["lm_head"][part])
    assert tq["embed"] is ttp["embed"]
    assert tq["layers"][0]["attn_norm"]["scale"] is \
        ttp["layers"][0]["attn_norm"]["scale"]


# ---------------------------------------------------------------------------
# int8 attention: the plain versions against JAX's kernels and references
# ---------------------------------------------------------------------------


def _int8_kv(seed, b=3, hkv=2, t=40, d=16):
    rng = np.random.RandomState(seed)
    kd = rng.randn(b, hkv, t, d).astype(np.float32)
    vd = rng.randn(b, hkv, t, d).astype(np.float32)
    k8, ks = (_np(a) for a in JQ.quantize_kv(jnp.asarray(kd)))
    v8, vs = (_np(a) for a in JQ.quantize_kv(jnp.asarray(vd)))
    return rng, (k8, v8, ks, vs)


# (head dim, query heads over 2 KV heads): the cases of
# ``test_quant_fused.py`` (d 16, G = 2), G = 4 as granite-8b, and both at
# granite's head dim 128.
INT8_DIMS = [(16, 4), (16, 8), (128, 4), (128, 8)]


@pytest.mark.parametrize("d,h", INT8_DIMS)
def test_int8_decode_plain_matches_jax(d, h):
    """``test_quant_fused.py:132-163``'s decode case (kv_len 40, 11, 1)
    plus a fully masked row (kv_len 0: zeros, the kernels' contract)."""
    rng, (k8, v8, ks, vs) = _int8_kv(6, b=4, d=d)
    q = rng.randn(4, h, d).astype(np.float32)
    kv_len = np.array([40, 11, 1, 0], np.int32)
    j_args = [jnp.asarray(a) for a in (q, k8, v8, kv_len, ks, vs)]
    t_args = [torch.tensor(a) for a in (q, k8, v8, kv_len, ks, vs)]
    got = decode_attention(*t_args).numpy()
    kern = _np(j_decode(*j_args, tk=16, interpret=True))
    np.testing.assert_allclose(got, kern, atol=ATTN_TOL, rtol=ATTN_TOL)
    assert not got[3].any()
    ref = _np(decode_attention_ref(*[a[:3] for a in j_args]))
    np.testing.assert_allclose(got[:3], ref, atol=ATTN_TOL, rtol=ATTN_TOL)


@pytest.mark.parametrize(
    "d,h,causal", [dh + (True,) for dh in INT8_DIMS]
    + [dh + (False,) for dh in INT8_DIMS],
    ids=[f"{d}-{h}" for d, h in INT8_DIMS]
    + [f"{d}-{h}-noncausal" for d, h in INT8_DIMS])
def test_int8_flash_plain_matches_jax(d, h, causal):
    """``test_quant_fused.py:132-163``'s prefill case (q_offset 0, 5, 30;
    6 queries each) plus a fully masked row (kv_len 0), causal and not
    (JAX's static ``causal``)."""
    rng, (k8, v8, ks, vs) = _int8_kv(7, b=4, d=d)
    q = rng.randn(4, h, 6, d).astype(np.float32)
    q_off = np.array([0, 5, 30, 0], np.int32)
    kv_len = q_off + 6
    kv_len[3] = 0
    j_args = [jnp.asarray(a) for a in (q, k8, v8, q_off, kv_len, ks, vs)]
    got = flash_attention(*[torch.tensor(a) for a in
                            (q, k8, v8, q_off, kv_len, ks, vs)],
                          causal=causal).numpy()
    kern = _np(j_flash(*j_args, causal=causal, tq=8, tk=16, interpret=True))
    ref = _np(flash_attention_ref(*j_args, causal=causal))
    for want in (kern, ref):
        np.testing.assert_allclose(got, want, atol=ATTN_TOL, rtol=ATTN_TOL)
    assert not got[3].any()


# ---------------------------------------------------------------------------
# int8 arenas: layout, growth, rollback
# ---------------------------------------------------------------------------


def _pools(buf=8, slots=2, rows=2):
    cfgs = {"target": T_KW, "drafter": D_KW}
    jp = JPool({n: JCfg(**kw) for n, kw in cfgs.items()}, num_slots=slots,
               rows_per_slot=rows, buf_len=buf, quant=True)
    tp = CachePool({n: ModelConfig(**kw) for n, kw in cfgs.items()},
                   num_slots=slots, rows_per_slot=rows, buf_len=buf,
                   device="cpu", quant=True)
    return jp, tp


def test_quant_pool_layout_and_growth_bit_exact():
    """Four leaves of JAX's dtypes and shapes; ``ensure_buf`` keeps every
    leaf's live prefix bit for bit (as JAX's pool does on the same data)
    and zeroes the tail."""
    jp, tp = _pools()
    rng = np.random.RandomState(3)
    for name in ("target", "drafter"):
        assert set(tp.caches[name]) == set(jp.caches[name]) == {
            "k", "v", "k_s", "v_s"}
        for kk, leaf in tp.caches[name].items():
            want = jp.caches[name][kk]
            assert tuple(leaf.shape) == want.shape
            assert str(leaf.dtype).split(".")[-1] == str(want.dtype)
            if leaf.dtype == torch.int8:
                data = rng.randint(-127, 128, leaf.shape).astype(np.int8)
            else:
                data = rng.uniform(1e-3, 1, leaf.shape).astype(np.float32)
            leaf.copy_(torch.from_numpy(data))
            jp.caches[name][kk] = jnp.asarray(data)
    jp.ensure_buf(24)
    tp.ensure_buf(24)
    for name in ("target", "drafter"):
        for kk, leaf in tp.caches[name].items():
            assert leaf.shape[3] == 24
            np.testing.assert_array_equal(leaf.numpy(),
                                          _np(jp.caches[name][kk]))
            assert not leaf[:, :, :, 8:].any()


@pytest.mark.parametrize("strategy", ["gls", "daliri"])
def test_fused_round_rollback_gathers_scales(pair, strategy):
    """After every fused round each live slot's K rows are one row: the
    rollback gathers all four leaves (the catch-up then writes the same
    token into every row).  Checked on the int8 leaves AND the scales up
    to the slot's position, after rounds whose drafts differed."""
    (ttp, tt), (tdp, td) = pair["torch"]
    k = 1 if strategy == "daliri" else 3
    eng = CachedSpecDecEngine((ttp, tt), (tdp, td),
                              SpecDecConfig(num_drafts=k, draft_len=3,
                                            strategy=strategy, quant=True),
                              pool_slots=2, device="cpu")
    eng.admit_batch([("a", np.arange(1, 9, dtype=np.int32)),
                     ("b", np.arange(20, 31, dtype=np.int32))], 64)
    key = R.PRNGKey(4)
    for _ in range(4):
        key, s1 = R.split(key)
        key, s2 = R.split(key)
        eng._block_fused([s1, s2], ["a", "b"])
        for slot in (0, 1):
            rows = eng.pool.rows_of(slot)
            pos = int(eng.pool.pos[slot])
            for arena in eng.pool.caches.values():
                for leaf in arena.values():
                    live = leaf[:, rows, :, :pos]
                    assert torch.equal(live, live[:, :1].expand_as(live))


# ---------------------------------------------------------------------------
# The slot calls on int8 arenas
# ---------------------------------------------------------------------------

B, T = 4, 40


def _arenas(seed):
    rng = np.random.RandomState(seed)
    shape = (T_KW["num_layers"], B, T_KW["num_kv_heads"], T,
             T_KW["head_dim"])
    leaves = {}
    for kk in ("k", "v"):
        q, s = JQ.quantize_kv(jnp.asarray(rng.randn(*shape).astype(
            np.float32)))
        leaves[kk], leaves[kk + "_s"] = _np(q), _np(s)
    return ({kk: jnp.asarray(a) for kk, a in leaves.items()},
            {kk: torch.from_numpy(a.copy()) for kk, a in leaves.items()})


def _check_arena(tc, jc):
    for kk in ("k", "v"):
        diff = np.abs(tc[kk].numpy().astype(np.int32)
                      - _np(jc[kk]).astype(np.int32))
        assert diff.max() <= 1, kk
        np.testing.assert_allclose(tc[kk + "_s"].numpy(), _np(jc[kk + "_s"]),
                                   rtol=SCALE_RTOL, atol=0)


@pytest.mark.parametrize("w8a8", [False, True])
def test_verify_step_slots_int8(pair, w8a8):
    (jtp, jcfg), _ = pair["jax"]
    (ttp, tcfg), _ = pair["torch"]
    if w8a8:
        jtp, ttp = JQ.quantize_params(jtp), TQ.quantize_params(ttp)
    jc, tc = _arenas(1)
    toks = np.random.RandomState(2).randint(0, 64, (B, 5)).astype(np.int32)
    pos = np.array([0, 3, 17, 35], np.int32)
    jl, jn = JT.verify_step_slots(jtp, jcfg, jnp.asarray(toks), jc,
                                  jnp.asarray(pos))
    tl = TT.verify_step_slots(ttp, tcfg, torch.from_numpy(toks), tc,
                              torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=0, atol=LOGIT_ATOL)
    _check_arena(tc, jn)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_decode_step_slots_int8(pair, use_kernel):
    (jtp, jcfg), _ = pair["jax"]
    (ttp, tcfg), _ = pair["torch"]
    jc, tc = _arenas(3)
    toks = np.array([[5], [17], [63], [0]], np.int32)
    pos = np.array([0, 9, 39, 22], np.int32)
    jl, jn = JT.decode_step_slots(jtp, jcfg, jnp.asarray(toks), jc,
                                  jnp.asarray(pos), use_kernel=use_kernel)
    tl = TT.decode_step_slots(ttp, tcfg, torch.from_numpy(toks), tc,
                              torch.from_numpy(pos), use_kernel=use_kernel)
    np.testing.assert_allclose(tl.numpy(), _np(jl), rtol=0, atol=LOGIT_ATOL)
    _check_arena(tc, jn)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_slots_int8(pair, use_kernel):
    """A write mask (row 1 outside the wave) and a chunk tail past T: the
    written int8 leaves and scales match JAX's; masked rows untouched."""
    (jtp, jcfg), _ = pair["jax"]
    (ttp, tcfg), _ = pair["torch"]
    jc, tc = _arenas(4)
    before = {kk: v.clone() for kk, v in tc.items()}
    toks = np.random.RandomState(5).randint(0, 64, (B, 16)).astype(np.int32)
    pos = np.array([0, 3, 10, 30], np.int32)
    write = np.array([True, False, True, True])
    jn = JT.prefill_slots(jtp, jcfg, jnp.asarray(toks), jc, jnp.asarray(pos),
                          jnp.asarray(write), use_kernel=use_kernel)
    TT.prefill_slots(ttp, tcfg, torch.from_numpy(toks), tc, pos, write,
                     use_kernel=use_kernel)
    _check_arena(tc, jn)
    for kk, leaf in tc.items():
        assert torch.equal(leaf[:, 1], before[kk][:, 1]), kk


# ---------------------------------------------------------------------------
# The engine: token streams and the acceptance gate
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("strategy", RACE)
def test_quant_engine_streams_match_jax(pair, strategy):
    """``quant=True`` fused-round generation gives JAX's tokens on fixed
    prompts and keys (JAX's pallas verifier, its reference on the CPU)."""
    k = 1 if strategy == "daliri" else 2
    (jtp, jt), (jdp, jd) = pair["jax"]
    (ttp, tt), (tdp, td) = pair["torch"]
    je = JEngine((jtp, jt), (jdp, jd),
                 JConfig(num_drafts=k, draft_len=3, strategy=strategy,
                         quant=True, verifier_backend="pallas"))
    te = CachedSpecDecEngine((ttp, tt), (tdp, td),
                             SpecDecConfig(num_drafts=k, draft_len=3,
                                           strategy=strategy, quant=True,
                                           verifier_backend="kernel"),
                             device="cpu")
    prompt = np.arange(1, 9, dtype=np.int32)
    for seed in (11, 12):
        jo = je.generate(jax.random.PRNGKey(seed), prompt, max_new=24,
                         fused=True)
        to = te.generate(R.PRNGKey(seed), prompt, max_new=24, fused=True)
        np.testing.assert_array_equal(jo.output, to.output)
        assert jo.blocks == to.blocks
        assert jo.accepted_drafts == to.accepted_drafts
    assert te.num_draft_syncs == 0


def _acceptance(pair, quant: bool, strategy: str, seeds=(11, 12, 13),
                max_new=32):
    (ttp, tt), (tdp, td) = pair["torch"]
    cfg = SpecDecConfig(num_drafts=2, draft_len=3, strategy=strategy,
                        quant=quant)
    eng = CachedSpecDecEngine((ttp, tt), (tdp, td), cfg, pool_slots=1,
                              device="cpu")
    prompt = np.arange(1, 9, dtype=np.int32)
    acc = blocks = 0
    for seed in seeds:
        st = eng.generate(R.PRNGKey(seed), prompt, max_new=max_new,
                          fused=True)
        acc += st.accepted_drafts
        blocks += st.blocks
    return acc / (blocks * cfg.draft_len)


@pytest.mark.parametrize("strategy", RACE)
def test_quant_acceptance_matches_f32(pair, strategy):
    """The quantization gate of ``tests/test_quant_fused.py:197``: int8
    arenas and W8A8 verify move the acceptance rate by at most 0.2."""
    rate_f = _acceptance(pair, False, strategy)
    rate_q = _acceptance(pair, True, strategy)
    assert abs(rate_q - rate_f) <= 0.2, (strategy, rate_q, rate_f)


def test_quant_engine_quantizes_verify_tree_only(pair):
    """The W8A8 tree feeds only the round's verify chunk: the engine
    keeps the float32 target for admission and the float32 drafter."""
    (ttp, tt), (tdp, td) = pair["torch"]
    eng = CachedSpecDecEngine((ttp, tt), (tdp, td),
                              SpecDecConfig(num_drafts=2, draft_len=3,
                                            quant=True), device="cpu")
    assert set(eng._t_verify_params["lm_head"]) == {"q", "s"}
    assert eng.t_params is ttp and eng.d_params is tdp
    eng.admit_batch([("a", np.arange(1, 6, dtype=np.int32))], 32)
    assert eng.pool.quant
    assert eng.pool.caches["target"]["k"].dtype == torch.int8
    f32 = dataclasses.replace(eng.cfg, quant=False)
    assert CachedSpecDecEngine((ttp, tt), (tdp, td), f32,
                               device="cpu")._t_verify_params is ttp
