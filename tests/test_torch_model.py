"""The port's dense model against the JAX package on the CPU: the JAX
parameter tree converted with ``params_from_jax`` must give allclose
logits (atol 1e-5: matmul, RoPE and softmax round in other orders) and
write the same cache rows from ``prefill_slots``, ``decode_step_slots``
and ``verify_step_slots``; rows a call must not touch stay bit-equal.

``prefill_slots`` is compared with JAX's ``prefill_slots`` itself, not
with ``write_prefill`` (whose bit-equality test fails on this tree)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import ModelConfig as JCfg
from repro.models import init_params as j_init
from repro.models import transformer as JT
from repro_torch.models import ModelConfig, init_params, params_from_jax
from repro_torch.models import transformer as TT

# One intra-op thread: the suite runs under several pytest-xdist workers
# on a few cores, where torch's default of a thread a core makes the
# workers contend over tensors of a few kilobytes.
torch.set_num_threads(1)

KW = dict(name="t", family="dense", num_layers=2, d_model=64, num_heads=6,
          num_kv_heads=2, head_dim=16, d_ff=128, vocab_size=300,
          dtype="float32")
ATOL_LOGITS = 1e-5
ATOL_KV = 1e-5
B, T = 4, 40


@pytest.fixture(scope="module")
def model():
    jcfg, tcfg = JCfg(**KW), ModelConfig(**KW)
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    return jcfg, tcfg, jp, tp


def _cache(seed):
    rng = np.random.RandomState(seed)
    shape = (KW["num_layers"], B, KW["num_kv_heads"], T, KW["head_dim"])
    return rng.randn(*shape).astype(np.float32), \
        rng.randn(*shape).astype(np.float32)


def _both(ck, cv):
    return ({"k": jnp.asarray(ck), "v": jnp.asarray(cv)},
            {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())})


def test_params_from_jax_layout(model):
    jcfg, tcfg, jp, tp = model
    assert len(tp["layers"]) == KW["num_layers"]
    assert tuple(tp["embed"].shape) == (tcfg.padded_vocab, KW["d_model"])
    assert tuple(tp["lm_head"].shape) == (KW["d_model"], tcfg.padded_vocab)
    np.testing.assert_array_equal(
        tp["layers"][1]["attn"]["wq"].numpy(),
        np.asarray(jp["layers"]["attn"]["wq"][1]))
    fresh = init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    for a, b in ((fresh["embed"], tp["embed"]),
                 (fresh["layers"][0]["mlp"]["w_down"],
                  tp["layers"][0]["mlp"]["w_down"])):
        assert a.shape == b.shape and a.dtype == b.dtype == torch.float32


def test_verify_step_slots_matches(model):
    """Per-row positions, one row whose chunk would run past T (the write
    start clamps, as dynamic_update_slice does)."""
    jcfg, tcfg, jp, tp = model
    ck, cv = _cache(1)
    jc, tc = _both(ck, cv)
    toks = np.random.RandomState(2).randint(0, 300, (B, 5)).astype(np.int32)
    pos = np.array([0, 3, 17, 37], np.int32)
    jl, jn = JT.verify_step_slots(jp, jcfg, jnp.asarray(toks), jc,
                                  jnp.asarray(pos))
    tl = TT.verify_step_slots(tp, tcfg, torch.from_numpy(toks), tc,
                              torch.from_numpy(pos))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL_LOGITS)
    for kk in ("k", "v"):
        np.testing.assert_allclose(tc[kk].numpy(), np.asarray(jn[kk]),
                                   rtol=0, atol=ATOL_KV)
    # Row 3 wrote [35, 40) (clamped from 37); untouched positions stay.
    np.testing.assert_array_equal(tc["k"].numpy()[:, 3, :, :35],
                                  ck[:, 3, :, :35])


@pytest.mark.parametrize("use_kernel", [False, True])
def test_decode_step_slots_matches(model, use_kernel):
    """Dense path and the decode-attention route (its plain version on
    the CPU, the JAX reference fallback there)."""
    jcfg, tcfg, jp, tp = model
    ck, cv = _cache(3)
    jc, tc = _both(ck, cv)
    toks = np.array([[5], [17], [299], [0]], np.int32)
    pos = np.array([0, 9, 39, 22], np.int32)
    jl, jn = JT.decode_step_slots(jp, jcfg, jnp.asarray(toks), jc,
                                  jnp.asarray(pos), use_kernel=use_kernel)
    tl = TT.decode_step_slots(tp, tcfg, torch.from_numpy(toks), tc,
                              torch.from_numpy(pos), use_kernel=use_kernel)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL_LOGITS)
    for kk in ("k", "v"):
        np.testing.assert_allclose(tc[kk].numpy(), np.asarray(jn[kk]),
                                   rtol=0, atol=ATOL_KV)
    for b, p in enumerate(pos):
        keep = np.ones(T, bool)
        keep[p] = False
        np.testing.assert_array_equal(tc["k"].numpy()[:, b, :, keep],
                                      ck[:, b, :, keep])


@pytest.mark.parametrize("use_kernel", [False, True])
def test_prefill_slots_matches(model, use_kernel):
    """A write mask (row 1 outside the wave) and a chunk tail past T (row
    3: positions >= T are dropped): written rows allclose to JAX's
    ``prefill_slots``; masked rows and dropped positions bit-untouched."""
    jcfg, tcfg, jp, tp = model
    ck, cv = _cache(4)
    jc, tc = _both(ck, cv)
    toks = np.random.RandomState(5).randint(0, 300, (B, 16)).astype(np.int32)
    pos = np.array([0, 3, 10, 30], np.int32)
    write = np.array([True, False, True, True])
    jn = JT.prefill_slots(jp, jcfg, jnp.asarray(toks), jc, jnp.asarray(pos),
                          jnp.asarray(write), use_kernel=use_kernel)
    TT.prefill_slots(tp, tcfg, torch.from_numpy(toks), tc, pos, write,
                     use_kernel=use_kernel)
    for kk, orig in (("k", ck), ("v", cv)):
        got = tc[kk].numpy()
        np.testing.assert_allclose(got, np.asarray(jn[kk]), rtol=0,
                                   atol=ATOL_KV)
        np.testing.assert_array_equal(got[:, 1], orig[:, 1])
        np.testing.assert_array_equal(got[:, 0, :, 16:], orig[:, 0, :, 16:])
        assert not np.array_equal(got[:, 3, :, 30:], orig[:, 3, :, 30:])
