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
