"""The port's threefry2x32 PRNG (``repro_torch.random``) against
``jax.random``: keys, splits, folds and uniform bits must be bit-exact,
because the serving path's shared-uniform coupling and the per-request
``fold_in(fold_in(key, uid), blocks)`` streams only carry over between
the packages if both draw the same bits."""

import jax
import numpy as np
import pytest
import torch

from repro.specdec.engine import block_randomness as jax_block_randomness
from repro_torch import random as R
from repro_torch.specdec.engine import block_randomness

SEEDS = (0, 1, 42, 2**31 - 1, -1, 123456789)
TINY = float(np.finfo(np.float32).tiny)


def _t(key) -> torch.Tensor:
    return torch.from_numpy(np.asarray(key).astype(np.int64))


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey_split_fold_in_bit_exact(seed):
    jk = jax.random.PRNGKey(seed)
    tk = R.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(jk), tk.numpy())
    for num in (2, 5):
        np.testing.assert_array_equal(np.asarray(jax.random.split(jk, num)),
                                      R.split(tk, num).numpy())
    for data in (0, 1, 7, 999, 2**31 - 1):
        np.testing.assert_array_equal(
            np.asarray(jax.random.fold_in(jk, data)),
            R.fold_in(tk, data).numpy())


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_nested_fold_in_scheduler_streams(seed):
    """The scheduler's per-request stream: fold_in(fold_in(key, uid),
    blocks), over several uids and block counts."""
    jk, tk = jax.random.PRNGKey(seed), R.PRNGKey(seed)
    for uid in (1, 2, 17):
        for blocks in (0, 1, 5, 1000):
            np.testing.assert_array_equal(
                np.asarray(jax.random.fold_in(jax.random.fold_in(jk, uid),
                                              blocks)),
                R.fold_in(R.fold_in(tk, uid), blocks).numpy())


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shape,minval", [((7,), 0.0), ((3, 5), 0.0),
                                          ((5, 8, 300), TINY),
                                          ((2, 3, 4, 9), TINY)])
def test_uniform_bits_bit_exact(seed, shape, minval):
    """Uniform floats compared as int32 bit patterns, including the
    (L+1, K, N) sheet of a block at N = 300."""
    ju = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                       minval=minval, maxval=1.0))
    tu = R.uniform(R.PRNGKey(seed), shape, minval, 1.0).numpy()
    np.testing.assert_array_equal(ju.view(np.int32), tu.view(np.int32))


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_batched_keys_match_vmap(seed):
    """One key per batch element draws what ``jax.vmap`` over keys does
    (the fused round draws every slot's sheet this way)."""
    keys = jax.random.split(jax.random.PRNGKey(seed), 4)
    ju = np.asarray(jax.vmap(lambda k: jax.random.uniform(
        k, (3, 4, 300), minval=TINY, maxval=1.0))(keys))
    tu = R.uniform(_t(keys), (3, 4, 300), TINY, 1.0).numpy()
    np.testing.assert_array_equal(ju.view(np.int32), tu.view(np.int32))
    np.testing.assert_array_equal(
        np.asarray(jax.vmap(lambda k: jax.random.split(k, 5))(keys)),
        R.split(_t(keys), 5).numpy())


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_categorical_matches(seed):
    """Gumbel-max categorical (daliri's bonus draw): the uniform bits are
    exact, the logs agree to an ulp, so the draws agree away from
    near-ties -- none occur on these inputs."""
    keys = jax.random.split(jax.random.PRNGKey(seed), 6)
    logits = np.random.RandomState(seed % 2**31).randn(6, 300).astype(
        np.float32)
    jc = np.asarray(jax.vmap(jax.random.categorical)(keys, logits))
    tc = R.categorical(_t(keys), torch.from_numpy(logits)).numpy()
    np.testing.assert_array_equal(jc, tc)


@pytest.mark.parametrize("seed", SEEDS[:3])
def test_block_randomness_matches(seed):
    """The per-block sheet: strategy keys bit-exact; log-uniforms equal
    up to the last ulp of ``log`` (the uniform bits themselves are
    exact, see above)."""
    sub = jax.random.PRNGKey(seed)
    jl, jkeys = jax_block_randomness(sub, 3, 4, 300)
    tl, tkeys = block_randomness(R.PRNGKey(seed), 3, 4, 300)
    np.testing.assert_array_equal(np.asarray(jkeys), tkeys.numpy())
    np.testing.assert_allclose(np.asarray(jl), tl.numpy(), rtol=2e-7,
                               atol=0)
    assert np.asarray(jl).shape == tuple(tl.shape) == (4, 4, 300)
    assert np.isfinite(tl.numpy()).all() and (tl.numpy() < 0).all()


# Tolerances of the float samplers: the uniform bits underneath are exact;
# torch's ``log1p`` differs from XLA's in the last ulp on ~7 % of inputs,
# so ``exponential`` (one log1p) agrees to rtol 2.4e-7 (1-2 ulp) and
# ``normal`` (log1p inside erf_inv, then a degree-8 polynomial) to
# rtol 4e-7 (about 3 ulp).
EXP_RTOL, NORMAL_RTOL = 2.4e-7, 4e-7


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("shape", [(7,), (3, 4, 300), (50_000,)])
def test_exponential_matches(seed, shape):
    je = np.asarray(jax.random.exponential(jax.random.PRNGKey(seed), shape))
    te = R.exponential(R.PRNGKey(seed), shape).numpy()
    np.testing.assert_allclose(te, je, rtol=EXP_RTOL, atol=0)
    assert (te.view(np.int32) == je.view(np.int32)).mean() > 0.85


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("shape", [(), (7,), (3, 4, 300), (50_000,)])
def test_normal_matches(seed, shape):
    jn = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape))
    tn = R.normal(R.PRNGKey(seed), shape).numpy()
    np.testing.assert_allclose(tn, jn, rtol=NORMAL_RTOL, atol=0)
    assert (tn.view(np.int32) == jn.view(np.int32)).mean() > 0.95


def test_erf_inv_matches_xla():
    """The port's erf_inv against ``jax.lax.erf_inv`` (XLA's float32
    polynomial) on 400k uniform inputs over (-1, 1) and the edges: within
    rtol 4e-7, ±1 -> ±inf, 0 -> 0; ``torch.erfinv`` misses the same bar
    (another approximation, off by up to ~6e-6 relative)."""
    lo = np.nextafter(np.float32(-1), np.float32(0))
    x = np.asarray(jax.random.uniform(jax.random.PRNGKey(7), (400_000,),
                                      minval=lo, maxval=1.0))
    # +-2^-23 is the smallest magnitude the uniform sampler gives besides
    # 0 (XLA flushes a subnormal result to 0, PyTorch keeps it, so
    # inputs below ~1e-38 are outside what the samplers reach).
    edges = np.array([-1.0, lo, -0.5, -2.0**-23, 0.0, 2.0**-23, 0.5,
                      np.nextafter(np.float32(1), np.float32(0)), 1.0],
                     np.float32)
    x = np.concatenate([x, edges])
    want = np.asarray(jax.lax.erf_inv(x))
    got = R.erf_inv(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=NORMAL_RTOL, atol=0)
    assert got[-1] == np.inf and got[-9] == -np.inf and got[-5] == 0.0
    assert (got.view(np.int32) == want.view(np.int32)).mean() > 0.95
    loose = torch.erfinv(torch.from_numpy(x[:-9])).numpy()
    assert not np.allclose(loose, want[:-9], rtol=NORMAL_RTOL, atol=0)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("lo,hi", [(0, 2), (0, 64), (0, 7), (-5, 1000),
                                   (3, 3), (0, 2**31 - 1),
                                   (-2**31, 2**31 - 1)])
def test_randint_bit_exact(seed, lo, hi):
    jr = np.asarray(jax.random.randint(jax.random.PRNGKey(seed), (3, 333),
                                       lo, hi))
    tr = R.randint(R.PRNGKey(seed), (3, 333), lo, hi)
    assert tr.dtype == torch.int32
    np.testing.assert_array_equal(jr, tr.numpy())


def test_randint_batched_keys_match_vmap():
    """``make_bins`` draws one bin row per trial key, as ``jax.vmap``."""
    keys = jax.random.split(jax.random.PRNGKey(5), 6)
    jr = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (500,), 0, 8))(
        keys))
    np.testing.assert_array_equal(jr, R.randint(_t(keys), (500,), 0,
                                                8).numpy())
    with pytest.raises(ValueError):
        R.randint(R.PRNGKey(0), (3,), 0, 2**31)
