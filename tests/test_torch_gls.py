"""The port's GLS core (``repro_torch.core``) and the Wyner-Ziv outcome
guard (``repro_torch.serving.guard``) against the JAX package on the CPU,
on the same keys and numpy inputs.

Tolerances: the race sheets ``log(-log U)`` share their uniform bits
with JAX and differ only in the last ulp of the two logs (rtol and atol
2.4e-7); every selection (x, y, accept) is compared exactly -- a flip
would need a float near-tie, and none occurs on these seeds.  The bounds
are float32 reductions in another summation order (rtol 1e-6)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import core as J
from repro.serving.guard import GuardViolation as JGuardViolation
from repro.serving.guard import validate_wz_batch as j_validate
from repro_torch import core as T
from repro_torch import random as R
from repro_torch.serving.guard import GuardViolation, validate_wz_batch

SEEDS = (0, 1, 42)


def _t(x) -> torch.Tensor:
    x = np.asarray(x)
    return torch.from_numpy(x.astype(np.int64) if x.dtype == np.uint32
                            else x.copy())


def _dists(seed, k, n, zeros=True):
    rng = np.random.RandomState(seed)
    ps = rng.dirichlet(np.full(n, 0.5), k).astype(np.float32)
    q = rng.dirichlet(np.full(n, 0.5)).astype(np.float32)
    if zeros:                      # zero-probability symbols never win
        ps[:, :3] = 0.0
        q[n - 2:] = 0.0
    return ps, q


@pytest.mark.parametrize("seed", SEEDS)
def test_exponential_races_match(seed):
    j = np.asarray(J.exponential_races(jax.random.PRNGKey(seed), 6, 5000))
    t = T.exponential_races(R.PRNGKey(seed), 6, 5000).numpy()
    np.testing.assert_allclose(t, j, rtol=2.4e-7, atol=2.4e-7)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("k", [1, 3, 8])
def test_gls_sample_and_batch_match(seed, k):
    ps, q = _dists(seed, 1, 300)
    p = ps[0]
    key = jax.random.PRNGKey(seed)
    for j, t in ((J.gls_sample(key, jnp.asarray(p), jnp.asarray(q), k),
                  T.gls_sample(R.PRNGKey(seed), torch.from_numpy(p),
                               torch.from_numpy(q), k)),
                 (J.gls_sample_batch(key, jnp.asarray(p), jnp.asarray(q), k,
                                     64),
                  T.gls_sample_batch(R.PRNGKey(seed), torch.from_numpy(p),
                                     torch.from_numpy(q), k, 64))):
        for a, b in zip(j, t):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert t.x.dtype == t.y.dtype == torch.int32
        assert not np.isin(t.x.numpy(), [0, 1, 2]).any()


@pytest.mark.parametrize("seed", SEEDS)
def test_heterogeneous_conditional_and_importance_match(seed):
    k, n = 4, 257
    ps, q = _dists(seed, k, n)
    key = jax.random.PRNGKey(seed)
    tkey = R.PRNGKey(seed)
    j = J.gls_sample_heterogeneous(key, jnp.asarray(ps), jnp.asarray(q))
    t = T.gls_sample_heterogeneous(tkey, torch.from_numpy(ps),
                                   torch.from_numpy(q))
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert int(J.gls_conditional_encoder(key, jnp.asarray(q), k)) == \
        int(T.gls_conditional_encoder(tkey, torch.from_numpy(q), k))
    for which in range(k):
        assert int(J.gls_conditional_decoder(key, jnp.asarray(ps[which]), k,
                                             which)) == \
            int(T.gls_conditional_decoder(tkey, torch.from_numpy(ps[which]),
                                          k, which))
    rng = np.random.RandomState(seed + 1)
    log_w_q = rng.randn(n).astype(np.float32)
    log_w_p = rng.randn(k, n).astype(np.float32)
    log_w_p[:, ::3] = -np.inf                     # masked atoms
    j = J.gls_importance_sample(key, jnp.asarray(log_w_q),
                                jnp.asarray(log_w_p), k)
    t = T.gls_importance_sample(tkey, torch.from_numpy(log_w_q),
                                torch.from_numpy(log_w_p), k)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert (t.x.numpy() % 3 != 0).all()


def test_batched_keys_match_vmap():
    """A (B, 2) key batch draws what ``jax.vmap`` over keys draws."""
    ps, q = _dists(3, 5, 100)
    keys = jax.random.split(jax.random.PRNGKey(9), 16)
    j = jax.vmap(lambda kk: J.gls_sample_heterogeneous(
        kk, jnp.asarray(ps), jnp.asarray(q)))(keys)
    t = T.gls_sample_heterogeneous(_t(keys), torch.from_numpy(ps),
                                   torch.from_numpy(q))
    for a, b in zip(j, t):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("seed", SEEDS)
def test_bounds_match(seed):
    rng = np.random.RandomState(seed)
    n, k = 40, 3
    p = rng.dirichlet(np.ones(n)).astype(np.float32)
    q = rng.dirichlet(np.ones(n)).astype(np.float32)
    p[:4] = 0.0
    q[-3:] = 0.0
    p, q = p / p.sum(), q / q.sum()
    jp, jq, tp, tq = jnp.asarray(p), jnp.asarray(q), torch.from_numpy(p), \
        torch.from_numpy(q)
    info = rng.randn(200).astype(np.float32) * 3
    pairs = [
        (J.tv_distance(jp, jq), T.tv_distance(tp, tq)),
        (J.maximal_coupling_acceptance(jp, jq),
         T.maximal_coupling_acceptance(tp, tq)),
        (J.single_draft_gumbel_bound(jp, jq),
         T.single_draft_gumbel_bound(tp, tq)),
        (J.lml_bound(jp, jq, k), T.lml_bound(tp, tq, k)),
        (J.lml_conditional_bound(jp, jq, k),
         T.lml_conditional_bound(tp, tq, k)),
        (J.lml_relaxed_bound(jp, jq, k), T.lml_relaxed_bound(tp, tq, k)),
        (J.conditional_lml_bound(jq[5], jp[4:4 + k], k),
         T.conditional_lml_bound(tq[5], tp[4:4 + k], k)),
        (J.iid_draft_acceptance_upper(jp, jq, k),
         T.iid_draft_acceptance_upper(tp, tq, k)),
        (J.wz_error_upper_bound(jnp.asarray(info), k, 8),
         T.wz_error_upper_bound(torch.from_numpy(info), k, 8)),
    ]
    for j, t in pairs:
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=1e-7)
    lml, upper = float(pairs[3][1]), float(pairs[7][1])
    assert 0.0 < lml <= upper <= 1.0


def _wz_outcome(b=6, k=3, n_atoms=100, l_max=8, seed=0):
    rng = np.random.RandomState(seed)
    y = rng.randint(0, n_atoms, b).astype(np.int32)
    x = rng.randint(0, n_atoms, (b, k)).astype(np.int32)
    x[:, 0] = y
    return dict(y=y, message=rng.randint(0, l_max, b).astype(np.int32), x=x,
                match=x == y[:, None], ok=np.ones(b, bool))


@pytest.mark.parametrize("poison,msg", [
    (None, None),
    ("ok", "non-finite race score"),
    ("y", "y indices outside"),
    ("x", "x indices outside"),
    ("message", "message indices outside"),
    ("match", "inconsistent"),
    ("dtype", "non-integer dtype"),
])
def test_validate_wz_batch_matches_reference(poison, msg):
    """A good outcome passes both guards; each poisoned field raises
    ``GuardViolation`` (an ``AssertionError``) with the same message."""
    out = _wz_outcome()
    if poison == "ok":
        out["ok"][2] = False
    elif poison in ("y", "x"):
        out[poison][1] = 100 if poison == "y" else -1
        out["match"] = out["x"] == out["y"][:, None]
    elif poison == "message":
        out["message"][0] = 8
    elif poison == "match":
        out["match"][3, 1] = ~out["match"][3, 1]
    elif poison == "dtype":
        out["x"] = out["x"].astype(np.float32)
    kw = dict(n_atoms=100, l_max=8, what="chunk")
    if poison is None:
        j_validate(**out, **kw)
        validate_wz_batch(**{k: torch.from_numpy(v) for k, v in out.items()},
                          **kw)
        return
    with pytest.raises(JGuardViolation, match=msg) as je:
        j_validate(**out, **kw)
    with pytest.raises(GuardViolation, match=msg) as te:
        validate_wz_batch(**out, **kw)
    assert str(te.value) == str(je.value)
    assert isinstance(te.value, AssertionError)
