"""The port's reprefill serving path against the JAX package on the CPU.

* ``SpecDecEngine.generate`` emits JAX's tokens for all six strategies,
  under the three port backends ("torch" against JAX's "xla", "kernel"
  -- the plain row race on the CPU -- against "pallas", "legacy", the
  per-token host loop, against "legacy", with its host-sync count), for
  an SSM target with the dense drafter of
  ``tests/test_specdec_families.py`` and for an SSM target with an SSM
  drafter;
* ``serve`` equals JAX's, and ``gen_blocks`` over R = 2 requests equals
  two ``gen_block`` calls;
* ``SpecDecServer(cache_mode="reprefill")``, batched and sequential,
  emits per request the tokens of JAX's server in the same mode;
* ``autoregressive_reference`` equals JAX's.

Token streams are compared exactly: the uniform bits are exact and the
model math agrees to ~1e-6, so a flip would mean a float near-tie in a
race, to be traced, not tolerated."""

import jax
import numpy as np
import pytest
import torch

from repro.models import ModelConfig as JCfg
from repro.models import init_params as j_init
from repro.specdec import SpecDecConfig as JConfig
from repro.specdec import SpecDecEngine as JEngine
from repro.specdec import STRATEGIES
from repro.specdec import SpecDecServer as JServer
from repro.specdec.engine import autoregressive_reference as j_ar
from repro_torch import random as R
from repro_torch.models import ModelConfig, params_from_jax
from repro_torch.specdec import (
    SpecDecConfig,
    SpecDecEngine,
    SpecDecServer,
    autoregressive_reference,
)

# tests/test_specdec_families.py:13-20: the dense drafter and SSM target.
DRAFTER = dict(name="d", family="dense", num_layers=1, d_model=48,
               num_heads=4, num_kv_heads=2, head_dim=12, d_ff=96,
               vocab_size=64, dtype="float32")
TARGET = dict(name="ts", family="ssm", num_layers=2, d_model=64,
              num_heads=1, d_ff=0, vocab_size=64, ssm_state=16,
              ssm_head_dim=32, ssm_chunk=8, dtype="float32")
SSM_DRAFTER = dict(TARGET, name="ds", num_layers=1)
J_BACKEND = {"torch": "xla", "kernel": "pallas", "legacy": "legacy"}


def _convert(p):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, p),
                           device="cpu")


@pytest.fixture(scope="module")
def models():
    out = {}
    for name, kw, seed in (("target", TARGET, 0), ("dense", DRAFTER, 1),
                           ("ssm", SSM_DRAFTER, 2)):
        jp = j_init(jax.random.PRNGKey(seed), JCfg(**kw))
        out[name] = ((jp, JCfg(**kw)), (_convert(jp), ModelConfig(**kw)))
    return out


def _engines(models, drafter, strategy, backend, max_new=10):
    k = 1 if strategy in ("single", "daliri") else 2
    (jt, tt), (jd, td) = models["target"], models[drafter]
    je = JEngine(jt, [jd], JConfig(num_drafts=k, draft_len=2,
                                   strategy=strategy, top_k=0,
                                   max_new_tokens=max_new,
                                   verifier_backend=J_BACKEND[backend]))
    te = SpecDecEngine(tt, td, SpecDecConfig(num_drafts=k, draft_len=2,
                                             strategy=strategy, top_k=0,
                                             max_new_tokens=max_new,
                                             verifier_backend=backend),
                       device="cpu")
    return je, te


@pytest.mark.parametrize("backend", ["torch", "kernel", "legacy"])
@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("drafter", ["dense", "ssm"])
def test_generate_matches_jax(models, drafter, strategy, backend):
    je, te = _engines(models, drafter, strategy, backend)
    prompt = np.array([1, 2, 3], np.int32)
    jo = je.generate(jax.random.PRNGKey(5), prompt)
    to = te.generate(R.PRNGKey(5), prompt)
    np.testing.assert_array_equal(jo.output, to.output)
    assert (jo.blocks, jo.accepted_drafts, jo.host_syncs) == \
        (to.blocks, to.accepted_drafts, to.host_syncs)
    assert te.num_draft_forwards == je.num_draft_forwards
    assert te.num_target_forwards == je.num_target_forwards == to.blocks
    assert te.num_draft_syncs == je.num_draft_syncs
    assert (to.output >= 0).all() and (to.output < 64).all()


def test_serve_matches_jax(models):
    """``serve``: each prompt generated on ``fold_in(key, i)``."""
    je, te = _engines(models, "ssm", "gls", "kernel", max_new=6)
    prompts = [np.array([1, 2, 3], np.int32),
               np.array([9, 8, 7, 6, 5], np.int32)]
    jo = je.serve(jax.random.PRNGKey(1), prompts)
    to = te.serve(R.PRNGKey(1), prompts)
    for j, t in zip(jo, to):
        np.testing.assert_array_equal(j.output, t.output)
        assert j.blocks == t.blocks


def test_gen_blocks_equals_gen_block(models):
    _, te = _engines(models, "ssm", "gls", "kernel")
    prefixes = [np.array([1, 2, 3], np.int32),
                np.array([7, 8, 9, 10, 11, 12, 13, 14, 15], np.int32)]
    subs = [R.fold_in(R.PRNGKey(0), i) for i in (1, 2)]
    batched = te.gen_blocks(subs, prefixes, 20)
    for sub, pre, out in zip(subs, prefixes, batched):
        one = te.gen_block(sub, pre, 20)
        assert one.new_tokens == out.new_tokens
        assert one.accepted == out.accepted
        np.testing.assert_array_equal(one.active, out.active)


@pytest.mark.parametrize("batched", [True, False])
def test_server_matches_jax_reprefill(models, batched):
    """Three requests, two live at a time (the third admitted when one
    finishes, growing the buffer): per-request tokens equal JAX's."""
    je, te = _engines(models, "dense", "gls", "kernel")
    prompts = [np.random.RandomState(3 + i).randint(0, 64, n).astype(
        np.int32) for i, n in enumerate((5, 11, 17))]
    js = JServer(je, max_batch=2, batched=batched, cache_mode="reprefill")
    ts = SpecDecServer(te, max_batch=2, batched=batched,
                       cache_mode="reprefill")
    for p, n in zip(prompts, (6, 9, 5)):
        js.submit(p, max_new=n)
        ts.submit(p, max_new=n)
    jdone = {r.uid: r.output for r in js.run(jax.random.PRNGKey(0))}
    tdone = {r.uid: r.output for r in ts.run(R.PRNGKey(0))}
    assert sorted(jdone) == sorted(tdone) == [1, 2, 3]
    for uid in jdone:
        assert jdone[uid] == tdone[uid], uid
    jm, tm = js.metrics, ts.metrics
    assert (tm.rounds, tm.target_forwards, tm.host_syncs, tm.draft_syncs) \
        == (jm.rounds, jm.target_forwards, jm.host_syncs, jm.draft_syncs)


def test_server_rejects_wrong_engine(models):
    _, te = _engines(models, "dense", "gls", "torch")
    with pytest.raises(TypeError, match="CachedSpecDecEngine"):
        SpecDecServer(te, max_batch=2, cache_mode="kv_fused")
    with pytest.raises(TypeError, match="CachedSpecDecEngine"):
        SpecDecServer(te, max_batch=2, cache_mode="kv")
    with pytest.raises(ValueError, match="cache_mode"):
        SpecDecServer(te, max_batch=2, cache_mode="paged")


def test_heterogeneous_drafters_raise(models):
    """Two distinct drafters make a heterogeneous engine (one forward per
    drafter a draft step, ``tests/test_torch_diverse_drafts.py``); a
    drafter count other than 1 or K raises."""
    (_, tt), (_, td) = models["target"], models["dense"]
    other = (dict(td[0]), td[1])
    eng = SpecDecEngine(tt, [td, other], SpecDecConfig(num_drafts=2),
                        device="cpu")
    assert not eng._homogeneous
    with pytest.raises(ValueError, match="3 drafters"):
        SpecDecEngine(tt, [td, other, td], SpecDecConfig(num_drafts=2),
                      device="cpu")


@pytest.mark.parametrize("gumbel", [True, False])
def test_autoregressive_reference_matches_jax(models, gumbel):
    (jt, tt) = models["target"]
    prompt = np.array([4, 5, 6, 7], np.int32)
    j = j_ar(jax.random.PRNGKey(2), jt, prompt, 8, top_k=10,
             use_gumbel_trace=gumbel)
    t = autoregressive_reference(R.PRNGKey(2), tt, prompt, 8, top_k=10,
                                 use_gumbel_trace=gumbel, device="cpu")
    np.testing.assert_array_equal(j, t)


def test_engine_without_device_refuses_cpu(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    (_, tt), (_, td) = models["target"], models["dense"]
    with pytest.raises(RuntimeError, match="CUDA"):
        SpecDecEngine(tt, td, SpecDecConfig(num_drafts=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        autoregressive_reference(R.PRNGKey(0), tt, np.array([1]), 2)
