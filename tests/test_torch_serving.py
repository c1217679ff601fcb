"""The port's serving path against the JAX package on the CPU.

* ``block_verify_batched`` is bit-identical to JAX's on the same numpy
  log-uniforms, draft tokens and target distributions, for gls,
  gls_strong and daliri, under both port backends ("torch" and
  "kernel", the plain row race on the CPU; the rejection-sampling
  strategies are held in ``tests/test_torch_rs_verify.py``);
* the port's strategies and backends mirror JAX's;
* ``CachedSpecDecEngine`` fused rounds emit the same tokens as JAX's
  (``fused=True``, ``verifier_backend="pallas"``) from the same
  converted parameters and keys, for all six strategies;
* ``SpecDecServer`` emits, per request, the same tokens as JAX's
  ``SpecDecServer(cache_mode="kv_fused")`` over prompts that straddle
  admission buckets, with ``draft_syncs == 0`` and
  ``host_syncs == rounds``, for all six strategies.

Token streams are compared exactly: the uniform bits are exact and the
model math agrees to ~1e-6, so a flip would mean a float near-tie in a
race, to be traced, not tolerated."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ModelConfig as JCfg
from repro.models import init_params as j_init
from repro.specdec import CachedSpecDecEngine as JEngine
from repro.specdec import SpecDecConfig as JConfig
from repro.specdec import SpecDecServer as JServer
from repro.specdec import BACKENDS as J_BACKENDS
from repro.specdec import RS_STRATEGIES as J_RS_STRATEGIES
from repro.specdec import STRATEGIES as J_STRATEGIES
from repro.specdec import verify as JV
from repro.specdec.block_verify import block_verify_batched as j_bvb
from repro.specdec.engine import probs_from_logits as j_probs
from repro.specdec.engine_cached import _bucket_plan as j_bucket_plan
from repro.specdec.engine_cached import _max_bucket as j_max_bucket
from repro_torch import random as R
from repro_torch.models import ModelConfig, params_from_jax
from repro_torch.specdec import (
    BACKENDS,
    RS_STRATEGIES,
    STRATEGIES,
    CachedSpecDecEngine,
    SpecDecConfig,
    SpecDecEngine,
    SpecDecServer,
    block_verify_batched,
    probs_from_logits,
)
from repro_torch.specdec import verify as TV
from repro_torch.specdec.engine_cached import _bucket_plan, _max_bucket

# One intra-op thread: the suite runs under several pytest-xdist workers
# on a few cores, where torch's default of a thread a core makes the
# workers contend over tensors of a few kilobytes.
torch.set_num_threads(1)

KW = dict(name="t", family="dense", num_layers=2, d_model=64, num_heads=6,
          num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=300,
          dtype="float32")
RACE = ("gls", "gls_strong", "daliri")
# Single-draft strategies run with K = 1, as the launchers run them.
SINGLE = ("single", "daliri")


@pytest.fixture(scope="module")
def pair():
    jt, jd = JCfg(**KW), JCfg(**{**KW, "name": "d", "num_layers": 1})
    tt, td = ModelConfig(**KW), ModelConfig(**{**KW, "name": "d",
                                               "num_layers": 1})
    jtp = j_init(jax.random.PRNGKey(0), jt)
    jdp = j_init(jax.random.PRNGKey(1), jd)
    conv = lambda p: params_from_jax(jax.tree_util.tree_map(np.asarray, p),
                                     device="cpu")
    return {"jax": ((jtp, jt), (jdp, jd)),
            "torch": ((conv(jtp), tt), (conv(jdp), td))}


def _verify_inputs(seed, r=3, l=3, k=4, n=300):
    rng = np.random.RandomState(seed)
    log_u = np.log(rng.uniform(1e-6, 1.0, (r, l + 1, k, n))).astype(
        np.float32)
    q = rng.dirichlet(np.ones(n) * 0.3, (r, k, l + 1)).astype(np.float32)
    q[q < 2e-3] = 0.0                          # zero-probability symbols
    q /= q.sum(-1, keepdims=True)
    # Drafts: mostly the target race's own winners, so blocks accept
    # several tokens and exercise the active-mask recursion.
    score = np.log(-log_u).transpose(0, 2, 1, 3) - np.log(
        np.maximum(q, 1e-30))
    score[q <= 0] = np.inf
    d = score.argmin(-1)[:, :, :l].astype(np.int32)
    flip = rng.uniform(size=d.shape) < 0.25
    d[flip] = rng.randint(0, n, flip.sum())
    keys = np.asarray(jax.vmap(lambda s: jax.random.split(s, l + 1))(
        jax.random.split(jax.random.PRNGKey(seed), r)))
    return log_u, d, q, keys


@pytest.mark.parametrize("backend", ["torch", "kernel"])
@pytest.mark.parametrize("strategy", RACE)
def test_block_verify_batched_bit_identical(strategy, backend):
    k = 1 if strategy == "daliri" else 4
    outs = []
    for seed in (0, 1):
        log_u, d, q, keys = _verify_inputs(seed, k=k)
        j = j_bvb(jnp.asarray(log_u), jnp.asarray(d), None, jnp.asarray(q),
                  jnp.asarray(keys), strategy=strategy,
                  backend="pallas" if backend == "kernel" else "xla")
        t = block_verify_batched(torch.from_numpy(log_u), torch.from_numpy(d),
                                 None, torch.from_numpy(q),
                                 torch.from_numpy(keys.astype(np.int64)),
                                 strategy=strategy, backend=backend)
        np.testing.assert_array_equal(np.asarray(j.tokens), t.tokens.numpy())
        np.testing.assert_array_equal(np.asarray(j.num_accepted),
                                      t.num_accepted.numpy())
        np.testing.assert_array_equal(np.asarray(j.active), t.active.numpy())
        np.testing.assert_array_equal(np.asarray(j.bonus), t.bonus.numpy())
        outs.append(int(t.num_accepted.sum()))
    assert max(outs) > 0                      # some drafts were accepted


def test_step_verifiers_match():
    log_u, d, q, _ = _verify_inputs(7, r=1, l=1)
    lu, dt, qq = log_u[0, 0], d[0, :, 0], q[0, :, 0]
    active = np.array([True, False, True, True])
    for jf, tf in ((JV.gls_verify, TV.gls_verify),
                   (JV.gls_verify_strong, TV.gls_verify_strong)):
        j = jf(jnp.asarray(lu), jnp.asarray(dt), jnp.asarray(qq),
               jnp.asarray(active))
        t = tf(torch.from_numpy(lu), torch.from_numpy(dt).long(),
               torch.from_numpy(qq), torch.from_numpy(active))
        assert int(j.token) == int(t.token)
        np.testing.assert_array_equal(np.asarray(j.new_active),
                                      t.new_active.numpy())
    j = JV.daliri_verify(jnp.asarray(lu[0]), jnp.asarray(dt[0]),
                         jnp.asarray(qq[0]))
    t = TV.daliri_verify(torch.from_numpy(lu[0]), int(dt[0]),
                         torch.from_numpy(qq[0]))
    assert int(j.token) == int(t.token) and bool(j.accepted) == bool(
        t.accepted)


def test_probs_and_bucket_plan_match():
    logits = np.random.RandomState(3).randn(4, 512).astype(np.float32)
    for temp, top_k in ((1.0, 50), (0.7, 0), (1.0, 299)):
        np.testing.assert_allclose(
            probs_from_logits(torch.from_numpy(logits), temp, top_k,
                              300).numpy(),
            np.asarray(j_probs(jnp.asarray(logits), temp, top_k, 300)),
            rtol=1e-6, atol=1e-7)
    for buf in (16, 40, 85, 370, 1000):
        assert _max_bucket(buf) == j_max_bucket(buf)
        for n in (0, 1, 15, 16, 17, 64, 70, 299):
            assert _bucket_plan(n, _max_bucket(buf)) == \
                j_bucket_plan(n, j_max_bucket(buf))


def test_strategies_and_backends_mirror_jax(pair):
    """The port's strategy tuples are JAX's, its backends are JAX's with
    "torch"/"kernel" for "xla"/"pallas", every JAX strategy builds a
    config, and the cached engine's fused round refuses the legacy host
    loop as JAX's does (its host-driven round takes it)."""
    assert STRATEGIES == J_STRATEGIES
    assert RS_STRATEGIES == J_RS_STRATEGIES
    twin = {"legacy": "legacy", "xla": "torch", "pallas": "kernel"}
    assert BACKENDS == tuple(twin[b] for b in J_BACKENDS)
    for s in J_STRATEGIES:
        for b in BACKENDS:
            assert SpecDecConfig(strategy=s, verifier_backend=b).strategy == s
    with pytest.raises(ValueError, match="unknown strategy"):
        SpecDecConfig(strategy="medusa")
    (ttp, tt), (tdp, td) = pair["torch"]
    eng = CachedSpecDecEngine((ttp, tt), (tdp, td),
                              SpecDecConfig(strategy="specinfer",
                                            verifier_backend="legacy"),
                              device="cpu")
    with pytest.raises(ValueError, match="legacy"):
        eng.generate(R.PRNGKey(0), np.array([1, 2, 3], np.int32), max_new=4,
                     fused=True)


@pytest.mark.parametrize("temps", [None, (0.7, 0.7, 0.7, 0.7),
                                   (1.0, 0.5, 1.0, 2.0)])
def test_config_draft_temps_match_jax(pair, temps):
    """The same keyword arguments build both configs (``draft_temps``,
    the JAX field) and give equal ``.temps``; distinct temperatures are
    taken by the reference engine (heterogeneous drafting) and refused
    by the cached engine, which asserts as JAX's does."""
    kw = dict(num_drafts=4, draft_len=3, strategy="gls", target_temp=1.0,
              draft_temps=temps, top_k=50, max_new_tokens=8)
    jc, tc = JConfig(**kw), SpecDecConfig(**kw)
    assert tc.temps == jc.temps
    assert len(tc.temps) == 4
    (ttp, tt), (tdp, td) = pair["torch"]
    ref = SpecDecEngine((ttp, tt), (tdp, td), tc, device="cpu")
    assert ref._homogeneous == (temps is None or len(set(temps)) == 1)
    if ref._homogeneous:
        CachedSpecDecEngine((ttp, tt), (tdp, td), tc, device="cpu")
        return
    with pytest.raises(AssertionError, match="homogeneous"):
        CachedSpecDecEngine((ttp, tt), (tdp, td), tc, device="cpu")


@pytest.mark.parametrize("strategy", J_STRATEGIES)
def test_engine_generate_matches_jax(pair, strategy):
    """Fused-round generation (the engine alone, one request): the same
    tokens as JAX's ``generate(fused=True)`` with the pallas verifier
    (its bit-identical reference on the CPU)."""
    k = 1 if strategy in SINGLE else 4
    (jtp, jt), (jdp, jd) = pair["jax"]
    (ttp, tt), (tdp, td) = pair["torch"]
    prompt = np.array([1, 2, 3, 4, 5, 6, 7], np.int32)
    je = JEngine((jtp, jt), (jdp, jd),
                 JConfig(num_drafts=k, draft_len=3, strategy=strategy,
                         max_new_tokens=12, verifier_backend="pallas"))
    jo = je.generate(jax.random.PRNGKey(5), prompt, fused=True)
    te = CachedSpecDecEngine((ttp, tt), (tdp, td),
                             SpecDecConfig(num_drafts=k, draft_len=3,
                                           strategy=strategy,
                                           max_new_tokens=12,
                                           verifier_backend="kernel"),
                             device="cpu")
    to = te.generate(R.PRNGKey(5), prompt, fused=True)
    np.testing.assert_array_equal(jo.output, to.output)
    assert jo.blocks == to.blocks and to.host_syncs == to.blocks
    assert te.num_draft_syncs == 0


def _serve_both(pair, kernels: bool, strategy: str = "gls"):
    k = 1 if strategy in SINGLE else 4
    prompts = [np.random.RandomState(3 + i).randint(0, 300, n).astype(
        np.int32) for i, n in enumerate((5, 17, 40, 70))]
    (jtp, jt), (jdp, jd) = pair["jax"]
    (ttp, tt), (tdp, td) = pair["torch"]
    je = JEngine((jtp, jt), (jdp, jd),
                 JConfig(num_drafts=k, draft_len=3, strategy=strategy,
                         verifier_backend="pallas", decode_kernel=kernels,
                         prefill_kernel=kernels), pool_slots=2)
    js = JServer(je, max_batch=2, cache_mode="kv_fused")
    te = CachedSpecDecEngine((ttp, tt), (tdp, td),
                             SpecDecConfig(num_drafts=k, draft_len=3,
                                           strategy=strategy,
                                           verifier_backend="kernel",
                                           decode_kernel=kernels,
                                           prefill_kernel=kernels),
                             pool_slots=2, device="cpu")
    ts = SpecDecServer(te, max_batch=2)
    for p in prompts:
        js.submit(p, max_new=10)
        ts.submit(p, max_new=10)
    jdone = {r.uid: r.output for r in js.run(jax.random.PRNGKey(0))}
    tdone = {r.uid: r.output for r in ts.run(R.PRNGKey(0))}
    return js, ts, te, jdone, tdone


@pytest.mark.parametrize("strategy", J_STRATEGIES)
def test_server_matches_jax_kv_fused(pair, strategy):
    """Four requests, prompt lengths 5/17/40/70 (buckets 16, 32, 64 and a
    70-token prompt chunked past the 64 bucket), two slots: per-request
    token streams equal JAX's, with the fused-round sync accounting."""
    js, ts, te, jdone, tdone = _serve_both(pair, kernels=False,
                                           strategy=strategy)
    assert sorted(jdone) == sorted(tdone) == [1, 2, 3, 4]
    for uid in jdone:
        assert jdone[uid] == tdone[uid], uid
    m = ts.metrics
    assert m.rounds == js.metrics.rounds
    assert m.draft_syncs == 0 and m.host_syncs == m.rounds
    assert te.num_prefill_dispatches == js.engine.num_prefill_dispatches


def test_server_matches_jax_with_kernel_routes(pair):
    """The same serve with the decode- and prefill-attention routes on
    both sides (the port's plain versions vs JAX's references on the
    CPU): same tokens."""
    js, ts, _, jdone, tdone = _serve_both(pair, kernels=True)
    for uid in jdone:
        assert jdone[uid] == tdone[uid], uid
    assert ts.metrics.host_syncs == ts.metrics.rounds
