"""Heterogeneous drafters in the port's reference engine against the JAX
package on the CPU: K distinct drafters (different depths and seeds) at
per-drafter temperatures (``SpecDecConfig.draft_temps``), the paper's
diverse-drafts setup (Table 2).

* JAX's token streams for gls, gls_strong, specinfer and spectr:
  through ``generate`` with K = 2, through ``gen_blocks`` and
  ``SpecDecServer(cache_mode="reprefill")`` with K = 3, with one drafter
  forward per drafter a draft step;
* the Table 2 geometry at toy size: target temperature 2.0, drafter
  temperatures (0.5, 1.0) and (1.0, 0.5);
* drafter invariance (``test_specdec.py::
  test_engine_conditional_invariance``): GLS gives the same tokens for
  two drafters whose drafts coincide.

Token streams are compared exactly.  The buffers are 18 tokens long (14
in the invariance test), so JAX compiles few forwards.
"""

import jax
import numpy as np
import pytest
import torch

from repro.models import ModelConfig as JCfg
from repro.models import init_params as j_init
from repro.specdec import SpecDecConfig as JConfig
from repro.specdec import SpecDecEngine as JEngine
from repro.specdec import SpecDecServer as JServer
from repro_torch import random as R
from repro_torch.models import ModelConfig, params_from_jax
from repro_torch.specdec import SpecDecConfig, SpecDecEngine, SpecDecServer

KW = dict(name="t", family="dense", num_layers=2, d_model=48, num_heads=4,
          num_kv_heads=2, head_dim=12, d_ff=96, vocab_size=64,
          dtype="float32")
# Drafters: (name, layers, seed).
DRAFTERS = [("d1", 1, 1), ("d2", 2, 2), ("d3", 1, 3)]
STRATEGIES = ("gls", "gls_strong", "specinfer", "spectr")
TEMPS = {2: (0.7, 1.3), 3: (0.6, 1.0, 1.5)}
PROMPT = np.array([1, 2, 3, 4, 5], np.int32)


def _conv(p):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, p),
                           device="cpu")


@pytest.fixture(scope="module")
def models():
    jt = JCfg(**KW)
    jtp = j_init(jax.random.PRNGKey(0), jt)
    out = {"jax": {"target": (jtp, jt), "drafters": []},
           "torch": {"target": (_conv(jtp), ModelConfig(**KW)),
                     "drafters": []}}
    for name, layers, seed in DRAFTERS:
        kw = dict(KW, name=name, num_layers=layers)
        p = j_init(jax.random.PRNGKey(seed), JCfg(**kw))
        out["jax"]["drafters"].append((p, JCfg(**kw)))
        out["torch"]["drafters"].append((_conv(p), ModelConfig(**kw)))
    return out


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def _engines(models, k, strategy, temps, target_temp=1.0, top_k=20):
    kw = dict(num_drafts=k, draft_len=3, strategy=strategy,
              target_temp=target_temp, draft_temps=temps, top_k=top_k,
              max_new_tokens=8)
    je = JEngine(models["jax"]["target"], models["jax"]["drafters"][:k],
                 JConfig(**kw, verifier_backend="xla"))
    te = SpecDecEngine(models["torch"]["target"],
                       models["torch"]["drafters"][:k],
                       SpecDecConfig(**kw, verifier_backend="kernel"),
                       device="cpu")
    return je, te


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_diverse_generate_matches_jax(models, strategy):
    je, te = _engines(models, 2, strategy, TEMPS[2])
    assert not je._homogeneous and not te._homogeneous
    jo = je.generate(jax.random.PRNGKey(40), PROMPT)
    to = te.generate(R.PRNGKey(40), PROMPT)
    np.testing.assert_array_equal(to.output, jo.output)
    assert (to.blocks, to.accepted_drafts) == (jo.blocks, jo.accepted_drafts)
    # One forward per drafter a draft step.
    assert te.num_draft_forwards == je.num_draft_forwards == 2 * 3 * to.blocks


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_diverse_gen_blocks_and_server_match_jax(models, strategy):
    """K = 3: one ``gen_blocks`` call over two requests, then a batched
    reprefill server over three requests on two live slots."""
    je, te = _engines(models, 3, strategy, TEMPS[3])
    prefixes = [PROMPT, np.array([7, 8, 9], np.int32)]
    keys = [7, 8]
    jb = je.gen_blocks([jax.random.PRNGKey(s) for s in keys], prefixes, 18)
    tb = te.gen_blocks([R.PRNGKey(s) for s in keys], prefixes, 18)
    for j, t in zip(jb, tb):
        assert t.new_tokens == [int(x) for x in j.new_tokens]
        assert t.accepted == j.accepted
        np.testing.assert_array_equal(t.active, np.asarray(j.active))
    js = JServer(je, max_batch=2, batched=True, cache_mode="reprefill")
    ts = SpecDecServer(te, max_batch=2, batched=True, cache_mode="reprefill")
    for n in (4, 6, 7):
        p = np.arange(1, n + 1, dtype=np.int32) * 3 % 64
        js.submit(p, max_new=6)
        ts.submit(p, max_new=6)
    jdone = {r.uid: r.output for r in js.run(jax.random.PRNGKey(3))}
    tdone = {r.uid: r.output for r in ts.run(R.PRNGKey(3))}
    assert tdone == jdone
    assert ts.metrics.rounds == js.metrics.rounds


@pytest.mark.parametrize("temps", [(0.5, 1.0), (1.0, 0.5)])
@pytest.mark.parametrize("strategy", ["gls", "specinfer"])
def test_table2_geometry_matches_jax(models, strategy, temps):
    """``bench_table2_diverse_drafts.py``'s geometry at toy size: target
    temperature 2.0, two drafters at the given temperatures, top-k 50."""
    je, te = _engines(models, 2, strategy, temps, target_temp=2.0, top_k=50)
    jo = je.generate(jax.random.PRNGKey(50), PROMPT)
    to = te.generate(R.PRNGKey(50), PROMPT)
    np.testing.assert_array_equal(to.output, jo.output)
    assert to.accepted_drafts == jo.accepted_drafts


def test_engine_conditional_invariance(models):
    """Def. 1 at engine level, as JAX's test states it: drafter 2 is
    drafter 1 with every weight scaled by 1 + 1e-4 (usually the same race
    winners, always other logits); GLS gives equal outputs in at least 8
    of 10 generations on the same keys.  The first generation of each
    equals JAX's."""
    tcfg = ModelConfig(**KW)
    dcfg = tcfg.replace(name="d1", num_layers=1)
    (tp, _), (dp1, _) = models["torch"]["target"], \
        models["torch"]["drafters"][0]
    dp2 = _tree_map(lambda w: w * (1.0 + 1e-4), dp1)
    sd = SpecDecConfig(num_drafts=2, draft_len=3, strategy="gls",
                       max_new_tokens=6, top_k=0)
    e1 = SpecDecEngine((tp, tcfg), [(dp1, dcfg)], sd, device="cpu")
    e2 = SpecDecEngine((tp, tcfg), [(dp2, dcfg)], sd, device="cpu")
    jd = models["jax"]["drafters"][0]
    je1 = JEngine(models["jax"]["target"], [jd],
                  JConfig(num_drafts=2, draft_len=3, strategy="gls",
                          max_new_tokens=6, top_k=0))
    jd2 = (jax.tree.map(lambda a: a * (1.0 + 1e-4), jd[0]), jd[1])
    je2 = JEngine(models["jax"]["target"], [jd2],
                  JConfig(num_drafts=2, draft_len=3, strategy="gls",
                          max_new_tokens=6, top_k=0))
    matched = 0
    for i in range(10):
        o1 = e1.generate(R.PRNGKey(100 + i), PROMPT, max_new=4)
        o2 = e2.generate(R.PRNGKey(100 + i), PROMPT, max_new=4)
        matched += int(np.array_equal(o1.output, o2.output))
        if i == 0:
            for je, o in ((je1, o1), (je2, o2)):
                np.testing.assert_array_equal(
                    o.output, je.generate(jax.random.PRNGKey(100), PROMPT,
                                          max_new=4).output)
    assert matched >= 8, f"only {matched}/10 generations drafter-invariant"
    assert torch.equal(dp2["embed"], dp1["embed"] * (1.0 + 1e-4))
