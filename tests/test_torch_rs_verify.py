"""The port's rejection-sampling verifiers against the JAX package.

* the step verifiers ``specinfer_verify``, ``spectr_verify`` and
  ``single_draft_verify`` emit JAX's token, ``accepted`` and
  ``new_active`` on the same keys and numpy distributions, with partly
  and fully inactive masks, zero-probability symbols and q == p;
* ``block_verify_batched`` for specinfer, spectr and single equals JAX's
  at R = 3, L = 3, N = 300 (K = 4; 1 for single), under both device
  backends;
* ``legacy_block_verify`` (the per-token host loop) equals JAX's for all
  six strategies, with JAX's host-sync count, and equals the port's
  fused result;
* on the card, the batched verifier equals its CPU run on the same
  tensors (the ``cuda``-marked test).

Tokens are compared exactly: the key bits are exact, and a reduction
that differs from XLA's in the last ulp could only flip a categorical
near-tie, which would be a fault to trace.  JAX is imported inside the
``jx`` fixture, so the card test runs where JAX is not installed."""

import types

import numpy as np
import pytest
import torch

from repro_torch.specdec import block_verify as TB
from repro_torch.specdec import verify as TV

STRATEGIES = ("gls", "gls_strong", "specinfer", "spectr", "single", "daliri")
RS = ("specinfer", "spectr", "single")
SINGLE = ("single", "daliri")


@pytest.fixture(scope="module")
def jx():
    import importlib

    import jax
    import jax.numpy as jnp

    from repro.specdec import verify as JV
    # ``repro.specdec.block_verify`` the module (the package exports a
    # function of that name).
    JB = importlib.import_module("repro.specdec.block_verify")
    return types.SimpleNamespace(jax=jax, jnp=jnp, JB=JB, JV=JV)


def _dist(rng, shape, n):
    """Dirichlet rows with the symbols under 2e-3 zeroed (renormalised)."""
    d = rng.dirichlet(np.ones(n) * 0.3, shape).astype(np.float32)
    d[d < 2e-3] = 0.0
    return d / d.sum(-1, keepdims=True)


def _step_inputs(seed, case, k=4, n=300):
    """One step's (p, q, drafts, active) for a test case:
    "mixed" (q != p, a random partial mask), "equal" (q == p, the
    self-draft limit where u < q/p always accepts), "inactive" (no draft
    active: straight to the residual) or "overlap" (q a mix of p and
    another distribution, so most drafts pass)."""
    rng = np.random.RandomState(seed)
    p = _dist(rng, (k,), n)
    q = _dist(rng, (k,), n)
    if case == "equal":
        q = p.copy()
    elif case == "overlap":
        q = 0.7 * p + 0.3 * q
    d = np.array([rng.choice(n, p=row.astype(np.float64) / row.sum(
        dtype=np.float64)) for row in p], np.int32)
    active = rng.uniform(size=k) < 0.6
    if case == "inactive":
        active[:] = False
    elif case == "equal":
        active[0] = True
    return p, q, d, active


def _torch_key(jkey):
    return torch.from_numpy(np.asarray(jkey).astype(np.int64))


@pytest.mark.parametrize("case", ["mixed", "equal", "inactive", "overlap"])
@pytest.mark.parametrize("strategy", RS)
def test_step_verifiers_match_jax(jx, strategy, case):
    accepted = 0
    for seed in range(5 if case == "inactive" else 6):
        p, q, d, active = _step_inputs(seed + 100 * len(case), case)
        jkey = jx.jax.random.PRNGKey(seed)
        tkey = _torch_key(jkey)
        if strategy == "single":
            j = jx.JV.single_draft_verify(jkey, jx.jnp.asarray(p[0]),
                                          jx.jnp.asarray(d[0]),
                                          jx.jnp.asarray(q[0]))
            t = TV.single_draft_verify(tkey, torch.from_numpy(p[0]),
                                       torch.tensor(int(d[0])),
                                       torch.from_numpy(q[0]))
        else:
            jf = getattr(jx.JV, f"{strategy}_verify")
            tf = getattr(TV, f"{strategy}_verify")
            j = jf(jkey, jx.jnp.asarray(p), jx.jnp.asarray(d),
                   jx.jnp.asarray(q), jx.jnp.asarray(active))
            t = tf(tkey, torch.from_numpy(p), torch.from_numpy(d).long(),
                   torch.from_numpy(q), torch.from_numpy(active))
        assert int(j.token) == int(t.token), (seed, case)
        assert bool(j.accepted) == bool(t.accepted), (seed, case)
        np.testing.assert_array_equal(np.asarray(j.new_active),
                                      t.new_active.numpy())
        accepted += bool(t.accepted)
    if case == "equal":
        assert accepted > 0
    if case == "inactive" and strategy != "single":
        assert accepted == 0


def _block_inputs(seed, r=3, k=4, l=3, n=300):
    """R requests' blocks as an engine forms them: one drafter
    distribution per (request, step) shared by the K drafts (SpecTr's
    i.i.d. proposals), each draft its Gumbel race on the shared
    log-uniforms, q a mix of p and another distribution so blocks accept
    several tokens, and JAX's per-request ``split(key, L+1)`` keys."""
    import jax
    rng = np.random.RandomState(seed)
    p = np.repeat(_dist(rng, (r, 1, l), n), k, axis=1)
    q = _dist(rng, (r, k, l + 1), n)
    q[:, :, :l] = 0.75 * p + 0.25 * q[:, :, :l]
    q /= q.sum(-1, keepdims=True)
    log_u = np.log(rng.uniform(1e-6, 1.0, (r, l + 1, k, n))).astype(
        np.float32)
    score = np.log(-log_u[:, :l]).transpose(0, 2, 1, 3) - np.log(
        np.maximum(p, 1e-30))
    score[p <= 0] = np.inf
    d = score.argmin(-1).astype(np.int32)
    keys = np.asarray(jax.vmap(lambda s: jax.random.split(s, l + 1))(
        jax.random.split(jax.random.PRNGKey(seed), r)))
    return log_u, d, p, q, keys


def _as_torch(*arrays, device="cpu"):
    return [torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32
                             else a).to(device) for a in arrays]


@pytest.mark.parametrize("backend", ["torch", "kernel"])
@pytest.mark.parametrize("strategy", RS)
def test_block_verify_batched_matches_jax(jx, strategy, backend):
    k = 1 if strategy == "single" else 4
    accepted = []
    for seed in (0, 1, 2):
        log_u, d, p, q, keys = _block_inputs(seed, k=k)
        jnp = jx.jnp
        j = jx.JB.block_verify_batched(
            jnp.asarray(log_u), jnp.asarray(d), jnp.asarray(p),
            jnp.asarray(q), jnp.asarray(keys), strategy=strategy,
            backend="pallas" if backend == "kernel" else "xla")
        t = TB.block_verify_batched(*_as_torch(log_u, d, p, q, keys),
                                    strategy=strategy, backend=backend)
        np.testing.assert_array_equal(np.asarray(j.tokens), t.tokens.numpy())
        np.testing.assert_array_equal(np.asarray(j.num_accepted),
                                      t.num_accepted.numpy())
        np.testing.assert_array_equal(np.asarray(j.active), t.active.numpy())
        np.testing.assert_array_equal(np.asarray(j.bonus), t.bonus.numpy())
        accepted.extend(t.num_accepted.tolist())
    # Rejections and full blocks both occur, so the bonus draw runs.
    assert min(accepted) < 3 and max(accepted) == 3, accepted


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_legacy_matches_jax_and_fused(jx, strategy):
    """The per-token host loop equals JAX's (tokens, accepted count,
    active mask, host syncs) and the port's fused verifier."""
    k = 1 if strategy in SINGLE else 4
    syncs = set()
    for seed in (3, 4, 5):
        log_u, d, p, q, keys = _block_inputs(seed, r=2, k=k)
        for r in range(2):
            j = jx.JB.legacy_block_verify(
                jx.jnp.asarray(log_u[r]), d[r], jx.jnp.asarray(p[r]),
                jx.jnp.asarray(q[r]), jx.jnp.asarray(keys[r]),
                strategy=strategy)
            lu, dt, pp, qq, kk = _as_torch(log_u[r], d[r], p[r], q[r],
                                           keys[r])
            t = TB.run_block_verify(lu, d[r], pp, qq, kk, strategy=strategy,
                                    backend="legacy")
            f = TB.run_block_verify(lu, d[r], pp, qq, kk, strategy=strategy,
                                    backend="torch")
            assert t.new_tokens == j.new_tokens == f.new_tokens
            assert t.num_accepted == j.num_accepted == f.num_accepted
            np.testing.assert_array_equal(t.active, np.asarray(j.active))
            np.testing.assert_array_equal(t.active, f.active)
            assert t.host_syncs == j.host_syncs and f.host_syncs == 1
            syncs.add(t.host_syncs)
    assert len(syncs) > 1      # blocks of different lengths were verified


def test_batched_verifier_refuses_legacy():
    log_u, d, p, q, keys = _block_inputs(0)
    with pytest.raises(ValueError, match="host loop"):
        TB.block_verify_batched(*_as_torch(log_u, d, p, q, keys),
                                strategy="specinfer", backend="legacy")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: compares the card with the CPU")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", RS)
def test_block_verify_on_card_equals_cpu(cuda, strategy):
    """The same tensors through the batched verifier on the card and on
    the CPU: equal tokens, accepted counts, active masks and bonus
    flags (inputs drawn with the port's own generator, no JAX)."""
    from repro_torch import random as R
    from repro_torch.specdec.engine import probs_from_logits
    r_n, k, l, n = 4, 1 if strategy == "single" else 8, 4, 4096
    gen = torch.Generator().manual_seed(0)
    p = probs_from_logits(torch.randn(r_n, k, l, n, generator=gen), 1.0, 50,
                          n)
    q = probs_from_logits(torch.randn(r_n, k, l + 1, n, generator=gen) +
                          torch.nn.functional.pad(
                              p.log().clamp(min=-30), (0, 0, 0, 1)),
                          1.0, 50, n)
    d = torch.argmax(torch.log(p) + R.gumbel(R.split(R.PRNGKey(1), r_n),
                                             (k, l, n)), dim=-1)
    keys = R.split(R.split(R.PRNGKey(2), r_n), l + 1)
    cpu = TB.block_verify_batched(None, d, p, q, keys, strategy=strategy)
    card = TB.block_verify_batched(None, d.to(cuda), p.to(cuda), q.to(cuda),
                                   keys.to(cuda), strategy=strategy,
                                   backend="kernel")
    for a, b in zip(cpu, card):
        np.testing.assert_array_equal(a.numpy(), b.cpu().numpy())
