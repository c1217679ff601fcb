"""The port's beta-VAE / MNIST compression path (paper Fig. 4) against
the JAX package on the CPU, on the same numpy data and threefry keys.

* ``digits_dataset`` and ``wz_split``: bit-equal;
* ``init_vae`` from one key: atol 1e-6 (the normal sampler agrees to
  1-3 ulp, ``tests/test_torch_random.py``);
* ``vae_loss`` and its gradients on carried params
  (``vae_params_from_jax``): the loss to rtol 1e-5, the gradients to rtol
  1e-4 / atol 1e-6 (float32 convolutions and matmuls summed in another
  order);
* 5 ``train_vae`` steps from one key: the logged losses and the params
  to rtol 1e-4;
* ``compress_batch`` on carried params: ``y``, ``message``, ``x``,
  ``match`` and ``ok`` equal (both backends against JAX's "xla"), mse to
  atol 1e-6; ``evaluate_rd`` at N = 64, 8 trials equal to JAX's;
* ``train_vae`` and ``evaluate_rd`` refuse the CPU unless asked
  (``tests/test_torch_isolation.py``).

JAX is imported inside the CPU tests' fixtures, so the ``cuda`` test
runs on a machine with the card and no JAX:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_vae.py``."""

import types

import numpy as np
import pytest
import torch

from repro_torch import random as R
from repro_torch.compression import vae as V
from repro_torch.data import digits_dataset, wz_split
from repro_torch.kernels.mode import launch_counts, reset_launch_counts
from repro_torch.models import vae_params_from_jax
from repro_torch.optim import tree_leaves

# One intra-op thread: the suite runs under several pytest-xdist workers
# on a few cores, where torch's default of a thread a core makes the
# workers contend over tensors of a few kilobytes.
torch.set_num_threads(1)

RTOL_LOSS = 1e-5
RTOL_GRAD, ATOL_GRAD = 1e-4, 1e-6
RTOL_TRAIN = 1e-4


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from repro.compression import vae as jvae
    from repro.data import mnist as jmnist
    return types.SimpleNamespace(jax=jax, jnp=jnp, vae=jvae, mnist=jmnist)


@pytest.fixture(scope="module")
def carried(jx):
    """JAX's init_vae params from PRNGKey(3) and their port copy."""
    jp = jx.vae.init_vae(jx.jax.random.PRNGKey(3))
    return jp, vae_params_from_jax(jx.jax.tree.map(np.asarray, jp),
                                   device="cpu")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _jax_leaves(jx, tree):
    """JAX's leaves in ``tree_leaves`` order, as numpy."""
    return [np.asarray(x) for x in jx.jax.tree_util.tree_leaves(tree)]


def _close_trees(jx, got, want, rtol, atol):
    g, w = tree_leaves(got), _jax_leaves(jx, want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a.detach().numpy(), b, rtol=rtol,
                                   atol=atol)


def test_digits_and_wz_split_bit_equal(jx):
    imgs, labels = digits_dataset(50, seed=4)
    j_imgs, j_labels = jx.mnist.digits_dataset(50, seed=4)
    assert imgs.dtype == j_imgs.dtype and labels.dtype == j_labels.dtype
    assert np.array_equal(imgs, j_imgs) and np.array_equal(labels, j_labels)
    right, crops = wz_split(imgs, np.random.default_rng(9))
    j_right, j_crops = jx.mnist.wz_split(j_imgs, np.random.default_rng(9))
    assert np.array_equal(right, j_right) and np.array_equal(crops, j_crops)
    assert right.shape == (50, 28, 14) and crops.shape == (50, 7, 7)


def test_init_vae_matches_jax(jx, carried):
    jp, _ = carried
    got = V.init_vae(R.PRNGKey(3))
    _close_trees(jx, got, jp, rtol=0, atol=1e-6)
    assert all(t.dtype == torch.float32 for t in tree_leaves(got))


def _batch(seed=5, n=16):
    imgs, _ = digits_dataset(n, seed=seed)
    return wz_split(imgs, np.random.default_rng(seed))


def test_vae_loss_and_grads_match_jax(jx, carried):
    from repro_torch.train import value_and_grad
    jp, tp = carried
    src, crop = _batch()
    jkey = jx.jax.random.PRNGKey(11)
    (jl, jm), jg = jx.jax.value_and_grad(
        lambda p: jx.vae.vae_loss(p, jkey, jx.jnp.asarray(src),
                                  jx.jnp.asarray(crop), 0.35),
        has_aux=True)(jp)
    (tl, tm), tg = value_and_grad(
        lambda p: V.vae_loss(p, R.PRNGKey(11), torch.from_numpy(src),
                             torch.from_numpy(crop), 0.35), tp)
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL_LOSS)
    for name in ("mse", "kl", "bce"):
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=RTOL_LOSS)
    _close_trees(jx, tg, jg, RTOL_GRAD, ATOL_GRAD)


def test_train_vae_five_steps_match_jax(jx):
    imgs, _ = digits_dataset(200, seed=0)
    cfg = dict(steps=5, batch=16)
    j_log, t_log = [], []
    jp = jx.vae.train_vae(jx.jax.random.PRNGKey(0), imgs,
                          jx.vae.VAETrainConfig(**cfg), log=j_log.append)
    tp = V.train_vae(R.PRNGKey(0), imgs, V.VAETrainConfig(**cfg),
                     device="cpu", log=t_log.append)
    assert len(j_log) == len(t_log) == 2          # steps 0 and 4
    for a, b in zip(t_log, j_log):        # loss, mse, kl as logged
        ta = [float(w) for w in a.split()[4::2]]
        jb = [float(w) for w in b.split()[4::2]]
        # atol: the log's last printed digit.
        np.testing.assert_allclose(ta, jb, rtol=RTOL_TRAIN, atol=1e-3)
    _close_trees(jx, tp, jp, RTOL_TRAIN, 1e-5)


def _coding_inputs(b, k, seed=6):
    imgs, _ = digits_dataset(b, seed=seed)
    rng = np.random.default_rng(seed)
    srcs, crops = [], []
    for i in range(b):
        s, c = wz_split(np.repeat(imgs[i:i + 1], k, 0), rng)
        srcs.append(s[0])
        crops.append(c)
    return np.stack(srcs), np.stack(crops)


@pytest.mark.parametrize("k,l_max,shared", [(2, 4, False), (3, 16, False),
                                            (3, 16, True), (1, 8, False)])
def test_compress_batch_matches_jax(jx, carried, k, l_max, shared):
    jp, tp = carried
    b, n = 12, 128
    src, crops = _coding_inputs(b, k, seed=k + l_max)
    jkeys = jx.jax.random.split(jx.jax.random.PRNGKey(l_max), b)
    _, jcode, jmse = jx.vae.compress_batch(
        jkeys, jp, jx.jnp.asarray(src), jx.jnp.asarray(crops), n_atoms=n,
        l_max=l_max, k=k, shared_sheet=shared)
    tkeys = R.split(R.PRNGKey(l_max), b)
    for backend in ("torch", "kernel"):
        recons, code, mse = V.compress_batch(
            tkeys, tp, torch.from_numpy(src), torch.from_numpy(crops),
            n_atoms=n, l_max=l_max, k=k, shared_sheet=shared,
            backend=backend)
        for name in ("y", "message", "x", "match", "ok"):
            assert np.array_equal(getattr(code, name).numpy(),
                                  np.asarray(getattr(jcode, name))), name
        np.testing.assert_allclose(mse.numpy(), np.asarray(jmse), rtol=0,
                                   atol=1e-6)
        assert recons.shape == (b, k, 28, 14)


def test_compress_image_is_batch_lane(jx, carried):
    _, tp = carried
    src, crops = _coding_inputs(1, 2, seed=2)
    key = R.PRNGKey(4)
    recons, match, best = V.compress_image(
        key, tp, torch.from_numpy(src[0]), torch.from_numpy(crops[0]),
        n_atoms=64, l_max=4, k=2)
    r_b, code, mse = V.compress_batch(
        key[None], tp, torch.from_numpy(src), torch.from_numpy(crops),
        n_atoms=64, l_max=4, k=2)
    assert torch.equal(recons, r_b[0]) and torch.equal(match, code.match[0])
    assert float(best) == float(mse[0].min())


@pytest.mark.parametrize("k,shared", [(2, False), (2, True), (1, False)])
def test_evaluate_rd_matches_jax(jx, carried, k, shared):
    jp, tp = carried
    test, _ = digits_dataset(40, seed=1)
    kw = dict(n_atoms=64, l_max=4, k=k, trials=8, shared_sheet=shared,
              batch_size=3)
    want = jx.vae.evaluate_rd(jx.jax.random.PRNGKey(1), jp, test, **kw)
    reset_launch_counts()
    got = V.evaluate_rd(R.PRNGKey(1), tp, test, device="cpu",
                        backend="kernel", **kw)
    assert got["rate_bits"] == want["rate_bits"]
    assert got["match_prob_any"] == want["match_prob_any"]
    np.testing.assert_allclose(got["mse"], want["mse"], rtol=0, atol=1e-6)
    assert launch_counts.get("gls_binned_race", 0) == 0   # plain on the CPU


@pytest.mark.cuda
def test_vae_coding_kernel_equals_torch_on_card(cuda):
    """On the card: a short training run, then every chunk's code under
    the kernel backend equal to the torch backend's, one
    ``gls_binned_race`` launch per chunk."""
    imgs, _ = digits_dataset(300, seed=0)
    params = V.train_vae(R.PRNGKey(0), imgs, V.VAETrainConfig(steps=20),
                         device=cuda, log=lambda *_: None)
    src, crops = V.rd_inputs(imgs, 2, 16)
    keys = R.split(R.PRNGKey(1).to(cuda), 16)
    args = (keys, params, torch.from_numpy(src).to(cuda),
            torch.from_numpy(crops).to(cuda))
    reset_launch_counts()
    _, kc, kmse = V.compress_batch(*args, n_atoms=256, l_max=4, k=2,
                                   backend="kernel")
    torch.cuda.synchronize()
    assert launch_counts["gls_binned_race"] == 1
    _, tc, tmse = V.compress_batch(*args, n_atoms=256, l_max=4, k=2,
                                   backend="torch")
    for a, b in zip(kc, tc):
        assert torch.equal(a, b)
    assert torch.equal(kmse, tmse)
