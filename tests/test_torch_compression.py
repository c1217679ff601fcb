"""The port's Wyner-Ziv compression path (``repro_torch.compression``)
against the JAX package on the CPU, on the same keys and numpy inputs:
the per-sample oracle, the batched pipeline on both backends ("kernel"
against JAX's "pallas" run in interpret mode, "torch" against "xla"),
and the Gaussian experiment (``run_experiment``).

Tolerances: keys, bins and every selection (y, message, x, match, ok)
are compared exactly.  The race sheets and the Gaussian weights are
float32 arithmetic over samplers that agree to 1-3 ulp (see
``test_torch_random.py``) and XLA fuses a multiply and an add into one
rounding where PyTorch rounds twice, so the weights agree to atol
1e-4 on log-weights of magnitude up to ~1e3, the distortion to rtol
1e-5 and the Prop.-4 bound to rtol 1e-5.  No selection flips: each
would need a near-tie between two atoms' race scores.

The JAX side is imported inside a fixture, so the ``cuda`` test runs on
a machine with the card and no JAX."""

import numpy as np
import pytest
import torch

from repro_torch import random as R
from repro_torch.compression import gaussian as TG
from repro_torch.compression import pipeline as TP
from repro_torch.compression import wz as TW
from repro_torch.kernels.mode import launch_counts, reset_launch_counts
from repro_torch.serving.guard import GuardViolation

WEIGHT_ATOL, STAT_RTOL = 1e-4, 1e-5


@pytest.fixture(scope="module")
def jx():
    import types

    import jax
    import jax.numpy as jnp
    from repro.compression import gaussian, pipeline, wz
    return types.SimpleNamespace(jax=jax, jnp=jnp, gaussian=gaussian,
                                 pipeline=pipeline, wz=wz)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _t(x) -> torch.Tensor:
    x = np.asarray(x)
    return torch.from_numpy(x.astype(np.int64) if x.dtype == np.uint32
                            else x.copy())


def _pipeline_inputs(b, k, n, l_max, seed, poison=False):
    """Per-round keys (uint32 words; the port's ``split`` equals JAX's),
    weights with dead atoms and +inf garbage, bins; optionally one
    NaN-poisoned encoder row."""
    rng = np.random.RandomState(seed)
    log_w_enc = rng.randn(b, n).astype(np.float32)
    log_w_enc[rng.uniform(size=(b, n)) < 0.1] = -np.inf
    log_w_dec = rng.randn(b, k, n).astype(np.float32)
    log_w_dec[rng.uniform(size=(b, k, n)) < 0.05] = -np.inf
    log_w_dec[0, 0, :5] = np.inf
    if poison:
        log_w_enc[1] = np.nan
    bins = rng.randint(0, l_max, (b, n)).astype(np.int32)
    keys = R.split(R.PRNGKey(seed), b).numpy().astype(np.uint32)
    return keys, log_w_enc, log_w_dec, bins


@pytest.mark.parametrize("seed", [0, 1])
def test_race_tables_and_bins_match(jx, seed):
    """log S equal to JAX's to 2.4e-7.  Both sides are first held to a
    float64 anchor, log(-log1p(-u)) on the same uniform bits (exact on
    both sides), so a failure names the side that drifted."""
    jkey = jx.jax.random.PRNGKey(seed)
    j = np.asarray(jx.wz._race_tables(jkey, 4, 3000))
    t = TW._race_tables(R.PRNGKey(seed), 4, 3000).numpy()
    u = np.asarray(jx.jax.random.uniform(jkey, (4, 3000)))
    np.testing.assert_array_equal(
        R.uniform(R.PRNGKey(seed), (4, 3000)).numpy().view(np.uint32),
        u.view(np.uint32))
    anchor = np.log(np.maximum(-np.log1p(-u.astype(np.float64)),
                               np.finfo(np.float32).tiny))
    np.testing.assert_allclose(j, anchor, rtol=2.4e-7, atol=2.4e-7,
                               err_msg="JAX's log S against float64")
    np.testing.assert_allclose(t, anchor, rtol=2.4e-7, atol=2.4e-7,
                               err_msg="the port's log S against float64")
    np.testing.assert_allclose(t, j, rtol=2.4e-7, atol=2.4e-7)
    assert np.isfinite(t).all()
    np.testing.assert_array_equal(
        np.asarray(jx.wz.make_bins(jkey, 3000, 8)),
        TW.make_bins(R.PRNGKey(seed), 3000, 8).numpy())


@pytest.mark.parametrize("shared_sheet", [False, True])
def test_wz_round_matches(jx, shared_sheet):
    """The per-sample oracle on shared inputs, round by round."""
    keys, we, wd, bins = _pipeline_inputs(12, 3, 700, 8, seed=3)
    for i in range(len(keys)):
        j = jx.wz.wz_round(jx.jnp.asarray(keys[i]), jx.jnp.asarray(we[i]),
                           jx.jnp.asarray(wd[i]), jx.jnp.asarray(bins[i]), 3,
                           shared_sheet=shared_sheet)
        t = TW.wz_round(_t(keys[i]), torch.from_numpy(we[i]),
                        torch.from_numpy(wd[i]), torch.from_numpy(bins[i]),
                        3, shared_sheet=shared_sheet)
        for a, b in zip(j, t):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("shared_sheet", [False, True])
@pytest.mark.parametrize("backends", [("torch", "xla"), ("kernel", "pallas")])
@pytest.mark.parametrize("b,k,n,l_max", [(16, 3, 1024, 8), (8, 4, 4096, 64),
                                         (24, 1, 500, 2)])
def test_wz_round_batch_matches(jx, backends, shared_sheet, b, k, n, l_max):
    """y, message, x, match and ok equal JAX's, including a NaN-poisoned
    round (ok False) and +inf weights (dead)."""
    ours, theirs = backends
    keys, we, wd, bins = _pipeline_inputs(b, k, n, l_max, seed=n + k,
                                          poison=True)
    jnp = jx.jnp
    j = jx.pipeline.wz_round_batch(
        jnp.asarray(keys), jnp.asarray(we), jnp.asarray(wd),
        jnp.asarray(bins), l_max=l_max, shared_sheet=shared_sheet,
        backend=theirs, interpret=True if theirs == "pallas" else None)
    t = TP.wz_round_batch(_t(keys), torch.from_numpy(we),
                          torch.from_numpy(wd), torch.from_numpy(bins),
                          l_max=l_max, shared_sheet=shared_sheet,
                          backend=ours)
    for name, a, c in zip(TP.WZBatch._fields, j, t):
        np.testing.assert_array_equal(np.asarray(a), c.numpy(), err_msg=name)
    assert not bool(t.ok[1]) and bool(t.ok[0])
    with pytest.raises(GuardViolation, match="non-finite race score"):
        TP.check_wz_batch(t, n_atoms=n, l_max=l_max)
    clean = TP.WZBatch(*(f[2:] for f in t))
    assert TP.check_wz_batch(clean, n_atoms=n, l_max=l_max) is clean


def test_pipeline_matches_per_sample_oracle():
    """Both port backends reproduce the port's own per-sample oracle."""
    keys, we, wd, bins = _pipeline_inputs(10, 3, 600, 8, seed=11)
    for shared in (False, True):
        oracle = [TW.wz_round(_t(keys[i]), torch.from_numpy(we[i]),
                              torch.from_numpy(wd[i]),
                              torch.from_numpy(bins[i]), 3,
                              shared_sheet=shared) for i in range(10)]
        for backend in TP.BACKENDS:
            out = TP.wz_pipeline(_t(keys), torch.from_numpy(we),
                                 torch.from_numpy(wd), torch.from_numpy(bins),
                                 l_max=8, shared_sheet=shared,
                                 backend=backend)
            for f in ("y", "message", "x", "match"):
                np.testing.assert_array_equal(
                    getattr(out, f).numpy(),
                    np.stack([getattr(c, f).numpy() for c in oracle]))
    with pytest.raises(ValueError, match="unknown pipeline backend"):
        TP.wz_round_batch(_t(keys), torch.from_numpy(we),
                          torch.from_numpy(wd), torch.from_numpy(bins),
                          l_max=8, backend="xla")


def test_trial_setup_matches(jx):
    """The Gaussian source, side information, atoms, weights and bins of
    a batch of trials (keys and bins exact, floats within tolerance)."""
    cfg_j = jx.gaussian.GaussianWZ(sigma2_w_given_a=0.005, n_atoms=1024)
    cfg_t = TG.GaussianWZ(sigma2_w_given_a=0.005, n_atoms=1024)
    keys = jx.jax.random.split(jx.jax.random.PRNGKey(3), 32)
    j = jx.jax.vmap(lambda kk: jx.gaussian._trial_setup(kk, cfg_j, 4, 8))(
        keys)
    t = TG._trial_setup(_t(keys), cfg_t, 4, 8)
    names = ("k_race", "a", "t", "atoms", "log_w_enc", "log_w_dec", "bins")
    for name, a, c in zip(names, j, t):
        a = np.asarray(a)
        if name in ("k_race", "bins"):
            np.testing.assert_array_equal(a.astype(np.int64),
                                          c.numpy().astype(np.int64))
        else:
            np.testing.assert_allclose(c.numpy(), a, rtol=1e-6,
                                       atol=WEIGHT_ATOL, err_msg=name)


@pytest.mark.parametrize("shared_sheet", [False, True])
def test_simulate_trial_matches(jx, shared_sheet):
    cfg_j = jx.gaussian.GaussianWZ(n_atoms=512)
    cfg_t = TG.GaussianWZ(n_atoms=512)
    for seed in range(6):
        j = jx.gaussian.simulate_trial(jx.jax.random.PRNGKey(seed), cfg_j,
                                       3, 4, shared_sheet=shared_sheet)
        t = TG.simulate_trial(R.PRNGKey(seed), cfg_t, 3, 4,
                              shared_sheet=shared_sheet)
        np.testing.assert_array_equal(np.asarray(j[0]), t[0].numpy())
        np.testing.assert_allclose(t[2].numpy(), np.asarray(j[2]),
                                   rtol=STAT_RTOL, atol=1e-7)


@pytest.mark.parametrize("shared_sheet", [False, True])
@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("backends", [("torch", "xla"), ("kernel", "pallas")])
def test_run_experiment_matches(jx, backends, k, shared_sheet):
    """The Gaussian experiment: equal match rates, distortion and bound
    within tolerance, 200 trials in chunks of 64 (a padded tail)."""
    ours, theirs = backends
    cfg_j = jx.gaussian.GaussianWZ(sigma2_w_given_a=0.005, n_atoms=512)
    cfg_t = TG.GaussianWZ(sigma2_w_given_a=0.005, n_atoms=512)
    j = jx.gaussian.run_experiment(jx.jax.random.PRNGKey(4), cfg_j, k, 8,
                                   trials=200, shared_sheet=shared_sheet,
                                   backend=theirs, batch_size=64)
    t = TG.run_experiment(R.PRNGKey(4), cfg_t, k, 8, 200,
                          shared_sheet=shared_sheet, backend=ours,
                          batch_size=64, device="cpu")
    assert set(t) == set(j)
    for key in ("match_prob_any", "match_prob_each", "rate_bits"):
        assert t[key] == j[key], key
    for key in ("match_lower_bound", "distortion", "distortion_db"):
        np.testing.assert_allclose(t[key], j[key], rtol=STAT_RTOL,
                                   err_msg=key)


def test_gls_equals_baseline_at_k1_and_wins_above():
    cfg = TG.GaussianWZ(sigma2_w_given_a=0.005, n_atoms=512)
    runs = {(k, s): TG.run_experiment(R.PRNGKey(1), cfg, k, 4, 128,
                                      shared_sheet=s, device="cpu")
            for k in (1, 4) for s in (False, True)}
    assert runs[(1, False)] == runs[(1, True)]
    assert runs[(4, False)]["match_prob_any"] > \
        runs[(4, True)]["match_prob_any"]


def test_chunked_batch_map_pads_and_validates():
    seen = []

    def fn(x):
        seen.append(len(x))
        return x * 2, x + 1

    a, b = TP.chunked_batch_map(fn, (torch.arange(10),), 10, 4)
    assert seen == [4, 4, 4]
    np.testing.assert_array_equal(a, np.arange(10) * 2)
    np.testing.assert_array_equal(b, np.arange(10) + 1)

    def bad(res):
        raise GuardViolation("poisoned")

    with pytest.raises(GuardViolation):
        TP.chunked_batch_map(fn, (torch.arange(3),), 3, 2, validate=bad)


def test_run_experiment_refuses_cpu_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    with pytest.raises(RuntimeError, match="CUDA"):
        TG.run_experiment(R.PRNGKey(0), TG.GaussianWZ(n_atoms=64), 1, 2, 8)


def _backends_agree(ins, l_max):
    """The kernel and torch backends on the same inputs: equal ``ok``, and
    equal selections on every round that resolved (a poisoned round's
    selections are garbage on both, and differ: the kernel layout
    reports bin 0, the oracle the bin of atom 0)."""
    for shared in (False, True):
        reset_launch_counts()
        got = TP.wz_round_batch(*ins, l_max=l_max, shared_sheet=shared,
                                backend="kernel")
        launches = dict(launch_counts)
        want = TP.wz_round_batch(*ins, l_max=l_max, shared_sheet=shared,
                                 backend="torch")
        assert torch.equal(got.ok, want.ok) and not bool(got.ok.all())
        for a, c in zip(got, want):
            assert torch.equal(a[got.ok], c[got.ok])
    return launches


def test_kernel_backend_matches_torch():
    keys, we, wd, bins = _pipeline_inputs(16, 3, 1000, 8, seed=5,
                                          poison=True)
    ins = [_t(keys)] + [torch.from_numpy(x) for x in (we, wd, bins)]
    assert _backends_agree(ins, 8) == {}          # the plain route


@pytest.mark.cuda
def test_kernel_backend_matches_torch_on_card(cuda):
    """On the card: one ``gls_binned_race`` launch per batch, outputs
    equal to the sequenced torch backend on the same keys."""
    keys, we, wd, bins = _pipeline_inputs(64, 4, 4096, 64, seed=2,
                                          poison=True)
    ins = [_t(keys).to(cuda)] + [torch.from_numpy(x).to(cuda)
                                 for x in (we, wd, bins)]
    assert _backends_agree(ins, 64) == {"gls_binned_race": 1}
