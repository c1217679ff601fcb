"""The MoE family in the port against the JAX package on the CPU.

* The configs (granite-moe-1b-a400m, mixtral-8x22b) equal JAX's field
  by field, and ``reduced()`` gives JAX's smoke variants.
* ``moe_mlp``: group sizes and capacities as JAX's; outputs within atol
  1e-5 and the load-balance loss within rtol 1e-6 of JAX's, at the
  training and serving capacity factors, with tokens dropped past
  capacity and with planted router ties (two experts' router columns
  equal: the lower index wins in both).  The dispatch is exact (one token
  per expert slot); the combine sums a token's kept choices in another
  order than JAX's einsum, hence the tolerance.
* ``forward`` (with ``return_aux`` and ``return_hidden``), ``prefill``
  and ``decode_step`` of both ``reduced()`` configs through the registry
  against JAX's: logits within atol 1e-5, caches within atol 1e-5;
  mixtral's ring (window 64) wraps in the prefill and the decode steps.
* The reference engine with an MoE target emits JAX's token streams
  (``tests/test_specdec_families.py``'s geometry) with a dense and an MoE
  drafter, and a self-draft accepts what JAX's accepts (the rows share
  routing groups, so a drop can reject a draft on both sides).  Streams
  are compared exactly."""

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
from repro.models import moe as JM
from repro.models import prefill as j_prefill
from repro.specdec import SpecDecConfig as JConfig
from repro.specdec import SpecDecEngine as JEngine
from repro_torch import random as R
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.models import ModelConfig, params_from_jax
from repro_torch.models import moe as TM
from repro_torch.models import registry as TR
from repro_torch.specdec import SpecDecConfig, SpecDecEngine

# One intra-op thread: the suite runs under several pytest-xdist workers
# on a few cores, where torch's default of a thread a core makes the
# workers contend over tensors of a few kilobytes.
torch.set_num_threads(1)

ATOL = 1e-5
AUX_RTOL = 1e-6
ARCHS = ("granite-moe-1b-a400m", "mixtral-8x22b")


def _conv(p):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, p),
                           device="cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_reduced_match_jax(arch):
    ours, theirs = get_config(arch), j_get(arch)
    assert arch in ARCH_NAMES and ours.family == "moe"
    for o, t in ((ours, theirs), (ours.reduced(), theirs.reduced())):
        for field in ("name", "family", "num_layers", "d_model",
                      "num_heads", "num_kv_heads", "head_dim", "d_ff",
                      "vocab_size", "rope_theta", "norm_eps",
                      "sliding_window", "max_seq_len", "num_experts",
                      "experts_per_token", "resolved_head_dim", "kv_heads",
                      "padded_vocab"):
            assert getattr(o, field) == getattr(t, field), field
    assert ours.dtype == "float32"
    assert ours.reduced().dtype == theirs.reduced().dtype == "float32"


@pytest.mark.parametrize("tokens", [1, 7, 40, 256, 300, 513, 4168])
@pytest.mark.parametrize("cf", [TM.CAPACITY_FACTOR,
                                TM.SERVING_CAPACITY_FACTOR])
def test_group_size_and_capacity_match_jax(tokens, cf):
    cfg = get_config("mixtral-8x22b")
    jcfg = j_get("mixtral-8x22b")
    group = TM._group_size(tokens)
    assert group == JM._group_size(tokens)
    assert TM.capacity(cfg, group, cf) == JM.capacity(jcfg, group, cf)


def _moe_case(cfg, shape, plant):
    """A JAX MoE layer's router and experts and its input x (float32).
    ``plant``: "tie" gives experts 1 and 2 the same router column (every
    token ties them exactly); "skew" gives every token a common component
    that expert 0's column follows, so every token picks expert 0 and
    the expert overflows its capacity."""
    rng = np.random.RandomState(5)
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    draw = lambda *sh: (rng.randn(*sh) / np.sqrt(sh[-2])).astype(np.float32)
    router = draw(d, e)
    experts = {"w_gate": draw(e, d, f), "w_up": draw(e, d, f),
               "w_down": draw(e, f, d)}
    x = rng.randn(*shape, d).astype(np.float32)
    if plant == "tie":
        router[:, 2] = router[:, 1]
    if plant == "skew":
        common = rng.randn(d).astype(np.float32)
        x += common
        router[:, 0] = common / np.float32(d)
    return {"router": router, "experts": experts}, x


def _drops(cfg, x, router, cf):
    """(Token, choice) pairs past capacity, counted in numpy with JAX's
    routing order."""
    b, s, d = x.shape
    t = b * s
    group = JM._group_size(t)
    cap = JM.capacity(cfg, group, cf)
    logits = x.reshape(t // group, group, d) @ router
    order = np.argsort(-logits, axis=-1, kind="stable")
    idx = order[..., :cfg.experts_per_token].reshape(t // group, -1)
    drops = 0
    for row in idx:
        counts = np.bincount(row, minlength=cfg.num_experts)
        drops += int(np.maximum(counts - cap, 0).sum())
    return drops


@pytest.mark.parametrize("plant", ["none", "tie", "skew"])
@pytest.mark.parametrize("cf", [TM.CAPACITY_FACTOR,
                                TM.SERVING_CAPACITY_FACTOR])
@pytest.mark.parametrize("arch,shape", [("granite-moe-1b-a400m", (2, 40)),
                                        ("mixtral-8x22b", (3, 100))])
def test_moe_mlp_matches_jax(arch, shape, cf, plant):
    jcfg = j_get(arch).reduced()
    tcfg = get_config(arch).reduced()
    layer, x = _moe_case(jcfg, shape, plant)
    j_out, j_aux = JM.moe_mlp(jax.tree_util.tree_map(jnp.asarray, layer),
                              jcfg, jnp.asarray(x), cf=cf)
    t_out, t_aux = TM.moe_mlp(jax.tree_util.tree_map(_t, layer), tcfg,
                              _t(x), cf=cf)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(float(t_aux), float(j_aux), rtol=AUX_RTOL)
    if plant == "skew" and cf == TM.CAPACITY_FACTOR:
        # Expert 0 overflows its training capacity: the capacity cut is
        # covered, not only the dropless case.
        assert _drops(jcfg, x, layer["router"], cf) > 0


def test_top_k_keeps_the_lower_index_on_ties():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.2, 0.3]])
    vals, idx = TM.top_k(probs, 3)
    assert idx.tolist() == [[1, 2, 4]]
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert np.asarray(ji).tolist() == idx.tolist()


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg = j_get(request.param).reduced()
    tcfg = get_config(request.param).reduced()
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, _conv(jp)


def test_params_from_jax_moe_tree(model):
    jcfg, tcfg, jp, tp = model
    assert len(tp["layers"]) == jcfg.num_layers
    for i, layer in enumerate(tp["layers"]):
        np.testing.assert_array_equal(
            layer["router"].numpy(), np.asarray(jp["layers"]["router"][i]))
        for w in ("w_gate", "w_up", "w_down"):
            np.testing.assert_array_equal(
                layer["experts"][w].numpy(),
                np.asarray(jp["layers"]["experts"][w][i]))
        assert layer["experts"]["w_down"].shape == (
            jcfg.num_experts, jcfg.d_ff, jcfg.d_model)


def test_forward_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    toks = np.random.RandomState(1).randint(0, jcfg.vocab_size,
                                            (2, 90)).astype(np.int32)
    jl, jaux = j_forward(jp, jcfg, {"tokens": jnp.asarray(toks)},
                         remat=False, return_aux=True)
    tl, taux = TR.forward(tp, tcfg, {"tokens": _t(toks)}, return_aux=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=AUX_RTOL)
    jh = j_forward(jp, jcfg, {"tokens": jnp.asarray(toks)}, remat=False,
                   return_hidden=True)
    th = TR.forward(tp, tcfg, {"tokens": _t(toks)}, return_hidden=True)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=0,
                               atol=ATOL)


def test_prefill_and_decode_match_jax(model):
    """``prefill`` of 70 tokens into a cache for 100 (mixtral's reduced
    window, 64, wraps the ring), then 8 ``decode_step`` calls: logits and
    caches against JAX's at every step."""
    jcfg, tcfg, jp, tp = model
    toks = np.random.RandomState(2).randint(0, jcfg.vocab_size,
                                            (2, 78)).astype(np.int32)
    jc = j_cache(jcfg, 2, 100)
    tc = TR.init_cache(tcfg, 2, 100, "cpu")
    assert tuple(tc["k"].shape) == tuple(jc["k"].shape)
    if jcfg.sliding_window:
        assert tc["k"].shape[3] == 64
    jl, jc = j_prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :70])}, jc)
    tl, tc = TR.prefill(tp, tcfg, {"tokens": _t(toks[:, :70])}, tc)
    for i in range(70, 79):
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                   atol=ATOL)
        for kk in ("k", "v"):
            np.testing.assert_allclose(tc[kk].numpy(), np.asarray(jc[kk]),
                                       rtol=0, atol=ATOL)
        assert int(tc["pos"]) == int(jc["pos"]) == i
        if i == 78:
            break
        jl, jc = j_decode(jp, jcfg, jnp.asarray(toks[:, i:i + 1]), jc)
        tl, tc = TR.decode_step(tp, tcfg, _t(toks[:, i:i + 1]), tc)


def test_moe_refuses_cached_serving():
    from repro_torch.launch.serve import check_cache_mode
    for arch in ARCHS:
        for mode in ("kv", "kv_fused"):
            with pytest.raises(ValueError, match="reprefill"):
                check_cache_mode(arch, mode)
        check_cache_mode(arch, "reprefill")


# tests/test_specdec_families.py:13-27: the dense drafter and MoE target.
DRAFTER = dict(name="d", family="dense", num_layers=1, d_model=48,
               num_heads=4, num_kv_heads=2, head_dim=12, d_ff=96,
               vocab_size=64, dtype="float32")
TARGET = dict(name="tm", family="moe", num_layers=2, d_model=64,
              num_heads=4, num_kv_heads=2, head_dim=16, d_ff=128,
              vocab_size=64, num_experts=4, experts_per_token=2,
              dtype="float32")
MOE_DRAFTER = dict(TARGET, name="dm", num_layers=1)


@pytest.fixture(scope="module")
def pairs():
    out = {}
    for name, kw, seed in (("target", TARGET, 0), ("dense", DRAFTER, 1),
                           ("moe", MOE_DRAFTER, 2)):
        jp = j_init(jax.random.PRNGKey(seed), JCfg(**kw))
        out[name] = ((jp, JCfg(**kw)), (_conv(jp), ModelConfig(**kw)))
    return out


def _engines(pairs, drafter, k=2, el=2, max_new=10, target="target"):
    (jt, tt), (jd, td) = pairs[target], pairs[drafter]
    kw = dict(num_drafts=k, draft_len=el, strategy="gls", top_k=0,
              max_new_tokens=max_new)
    je = JEngine(jt, [jd], JConfig(verifier_backend="pallas", **kw))
    te = SpecDecEngine(tt, td, SpecDecConfig(verifier_backend="kernel",
                                             **kw), device="cpu")
    return je, te


@pytest.mark.parametrize("drafter", ["dense", "moe"])
def test_reference_engine_streams_match_jax(pairs, drafter):
    je, te = _engines(pairs, drafter)
    prompt = np.array([1, 2, 3], np.int32)
    jo = je.generate(jax.random.PRNGKey(5), prompt)
    to = te.generate(R.PRNGKey(5), prompt)
    np.testing.assert_array_equal(jo.output, to.output)
    assert (jo.blocks, jo.accepted_drafts) == (to.blocks, to.accepted_drafts)
    assert len(to.output) == 10 and 1.0 <= len(to.output) / to.blocks <= 3.0


def test_self_draft_rate_matches_jax(pairs):
    """The MoE target drafting for itself: the drafter's forwards route
    its K rows' tokens in other groups than the target's scoring forward,
    so a drop past capacity can reject a draft; the accepted count equals
    JAX's, whatever it is (at this size no group overflows)."""
    je, te = _engines(pairs, "target", k=4, el=3, max_new=24)
    prompt = np.arange(1, 9, dtype=np.int32)
    jo = je.generate(jax.random.PRNGKey(7), prompt)
    to = te.generate(R.PRNGKey(7), prompt)
    np.testing.assert_array_equal(jo.output, to.output)
    assert (jo.blocks, jo.accepted_drafts) == (to.blocks, to.accepted_drafts)
