"""The encoder-decoder family (whisper) in the port against the JAX
package on the CPU.

* ``whisper-small`` and its ``reduced()`` variant equal JAX's configs
  field by field.
* ``layernorm``, ``gelu_mlp`` (the tanh GELU) and ``sinusoids`` within
  atol 1e-6 of JAX's.
* ``params_from_jax`` carries the encdec tree leaf for leaf, bit for bit.
* The reduced model (2 + 2 layers), every LayerNorm bias and MLP bias
  set nonzero on both sides: ``forward`` (remat on and off, and
  ``return_hidden``), ``prefill``'s last logits and every cache leaf
  (``k``, ``v``, ``ck``, ``cv``, ``pos``), and 8 ``decode_step`` calls'
  logits and caches within atol 1e-5 of JAX's; the decode against the
  port's own ``forward`` (``tests/test_decode_consistency.py``'s
  contract); the decoder driven past its 64-slot self-cache (prefill 60,
  8 steps) against JAX's clipped positions and last-slot writes;
  ``encode`` over 2,100 frames (the chunked route) against JAX's.
* ``launch/serve.py`` refuses the arch under every cache mode (no engine
  passes stub inputs, as in JAX), and ``launch/train.py`` refuses it, as
  JAX's launcher does.
* One ``cuda`` case runs the reduced model on the card against the CPU.

JAX's outputs are computed once per module (``jx_run``).  JAX is
imported inside the CPU tests' fixtures, so the ``cuda`` test runs on a
machine with the card and no JAX:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_encdec.py``."""

import functools
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import encdec as TE
from repro_torch.models import layers as TL
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params, params_from_jax, prefill)
from repro_torch.models.convert import tree_family

# One intra-op thread: the suite runs under several pytest-xdist workers
# on a few cores, where torch's default of a thread a core makes the
# workers contend over tensors of a few kilobytes.
torch.set_num_threads(1)

ARCH = "whisper-small"
ATOL = 1e-5
LAYER_ATOL = 1e-6
B, S_ENC, S, PRE = 2, 48, 20, 12
LONG_PRE, LONG_STEPS = 60, 8        # past the reduced 64-slot self-cache
CHUNKED_FRAMES = 2100
BIASES = ("bias", "b_in", "b_out")


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get
    from repro.models import encdec as JE
    from repro.models import layers as JL
    from repro.models import registry as JR
    return types.SimpleNamespace(jax=jax, jnp=jnp, get=j_get, E=JE, L=JL,
                                 R=JR)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(jx, tree):
    return jx.jax.tree.map(np.asarray, tree)


def _bump_jax(jx, tree, seed: int):
    """Every bias leaf of a JAX tree set to normal(0, 0.5) from ``seed``:
    at init they are zero, and a zero bias would hide a missing one."""
    rng = np.random.default_rng(seed)

    def bump(path, a):
        if getattr(path[-1], "key", None) in BIASES:
            return jx.jnp.asarray(
                rng.normal(0, 0.5, a.shape).astype(np.float32))
        return a
    return jx.jax.tree_util.tree_map_with_path(bump, tree)


def _inputs(cfg, seed: int, s: int, s_enc: int = S_ENC):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, s))
            .astype(np.int32),
            "frames": rng.normal(size=(B, s_enc, cfg.d_model))
            .astype(np.float32)}


def _cache_np(cache) -> dict:
    return {k: np.asarray(v if not isinstance(v, torch.Tensor)
                          else v.numpy()) for k, v in cache.items()}


@pytest.fixture(scope="module")
def jx_run(jx):
    """JAX's reduced model (nonzero biases), its port, and JAX's outputs:
    forward logits and hidden state, prefill and 8 decode steps with
    their caches, the past-the-cache run and the chunked encode."""
    jcfg = jx.get(ARCH).reduced()
    tcfg = get_config(ARCH).reduced()
    jit = functools.partial(jx.jax.jit, static_argnums=1)
    jp = _bump_jax(jx, jit(jx.R.init_params)(jx.jax.random.PRNGKey(0), jcfg),
                   3)
    tp = params_from_jax(_np_tree(jx, jp), device="cpu")
    jnp = jx.jnp
    batch = _inputs(jcfg, 1, S)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    out = types.SimpleNamespace(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp,
                                batch=batch)
    def forward_both(params, cfg, b):    # one program: logits, hidden
        return (jx.R.forward(params, cfg, b, remat=False),
                jx.R.forward(params, cfg, b, remat=False, return_hidden=True))
    out.logits, out.hidden = map(np.asarray, jit(forward_both)(jp, jcfg, jb))
    prefill_j = jx.jax.jit(jx.R.prefill, static_argnums=1)
    decode_j = jx.jax.jit(jx.R.decode_step, static_argnums=1)

    def run(b, pre, steps):
        cache = jx.R.init_cache(jcfg, B, S_ENC)
        lg, cache = prefill_j(jp, jcfg, {**b, "tokens": b["tokens"][:, :pre]},
                              cache)
        seq = [(np.asarray(lg), _cache_np(cache))]
        for i in range(pre, pre + steps):
            lg, cache = decode_j(jp, jcfg, b["tokens"][:, i:i + 1], cache)
            seq.append((np.asarray(lg), _cache_np(cache)))
        return seq
    out.steps = run(jb, PRE, S - PRE)
    out.long = _inputs(jcfg, 2, LONG_PRE + LONG_STEPS)
    out.long_steps = run({k: jnp.asarray(v) for k, v in out.long.items()},
                         LONG_PRE, LONG_STEPS)
    out.frames_long = np.random.default_rng(4).normal(
        size=(1, CHUNKED_FRAMES, jcfg.d_model)).astype(np.float32)
    out.enc_long = np.asarray(jit(jx.E.encode)(jp, jcfg,
                                               jnp.asarray(out.frames_long)))
    return out


def _tb(batch):
    return {k: _t(v) for k, v in batch.items()}


def test_config_and_reduced_match_jax(jx):
    ours, theirs = get_config(ARCH), jx.get(ARCH)
    assert ours.family == "encdec" and ours.dtype == "float32"
    for o, t in ((ours, theirs), (ours.reduced(), theirs.reduced())):
        for field in ("name", "family", "num_layers", "encoder_layers",
                      "d_model", "num_heads", "num_kv_heads", "head_dim",
                      "d_ff", "vocab_size", "max_decoder_len", "norm_eps",
                      "max_seq_len", "resolved_head_dim", "kv_heads",
                      "padded_vocab"):
            assert getattr(o, field) == getattr(t, field), field
    assert ours.padded_vocab == 51_968
    assert (ours.reduced().encoder_layers, ours.reduced().max_decoder_len) \
        == (2, 64)


def _mlp_params(rng, d: int, exact: bool) -> dict:
    """GELU MLP weights d -> 4d -> d with normal(0, 0.5) biases.  ``exact``:
    signed permutations scaled by 1/2, so every matmul is one exact
    product per output and only the activation and the bias adds can
    differ; else the init's normal / sqrt(fan_in)."""
    def w(n, m):
        if not exact:
            return (rng.normal(size=(n, m)) / np.sqrt(n)).astype(np.float32)
        out = np.zeros((n, m), np.float32)
        rows = rng.permutation(np.arange(max(n, m)) % n)[:m]
        out[rows, np.arange(m)] = rng.choice([-0.5, 0.5], m)
        return out
    return {"w_in": w(d, 4 * d), "b_in": rng.normal(0, 0.5, 4 * d)
            .astype(np.float32), "w_out": w(4 * d, d),
            "b_out": rng.normal(0, 0.5, d).astype(np.float32)}


@pytest.mark.parametrize("shape", [(3, 7, 256), (2, 768)])
def test_layernorm_and_gelu_mlp_match_jax(jx, shape):
    """``layernorm`` on shifted, scaled rows (scale 1 + normal(0, 0.1),
    bias normal(0, 0.5)) within atol 1e-6; ``gelu_mlp`` on its output
    within 1e-6 where the matmuls are exact (``_mlp_params``), and with
    the init's weights within the models' 1e-5 (float32 sums of 4d terms
    in another order).  torch's default exact-erf GELU would miss JAX's
    tanh approximation by far more."""
    rng = np.random.default_rng(shape[-1])
    d = shape[-1]
    x = (rng.normal(size=shape) * 3 + 1).astype(np.float32)
    ln = {"scale": (1 + rng.normal(0, 0.1, d)).astype(np.float32),
          "bias": rng.normal(0, 0.5, d).astype(np.float32)}
    want = np.asarray(jx.L.layernorm(jx.jax.tree.map(jx.jnp.asarray, ln),
                                     jx.jnp.asarray(x)))
    xn = TL.layernorm({k: _t(v) for k, v in ln.items()}, _t(x))
    np.testing.assert_allclose(xn.numpy(), want, rtol=0, atol=LAYER_ATOL)
    for exact, atol in ((True, LAYER_ATOL), (False, ATOL)):
        mlp = _mlp_params(rng, d, exact)
        want = np.asarray(jx.L.gelu_mlp(
            jx.jax.tree.map(jx.jnp.asarray, mlp), jx.jnp.asarray(xn.numpy())))
        tm = {k: _t(v) for k, v in mlp.items()}
        got = TL.gelu_mlp(tm, xn).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=atol)
        erf = (torch.nn.functional.gelu(xn @ tm["w_in"] + tm["b_in"])
               @ tm["w_out"] + tm["b_out"]).numpy()
        assert np.abs(erf - want).max() > 10 * atol


@pytest.mark.parametrize("length,channels", [(64, 256), (CHUNKED_FRAMES, 256),
                                             (4096, 768)])
def test_sinusoids_match_jax(jx, length, channels):
    """Bit-equal frequencies (``encdec._exp_f32``): an ulp of one would
    move the angle at position 4,095 by 2e-4."""
    got = TE.sinusoids(length, channels, "cpu").numpy()
    want = np.asarray(jx.E.sinusoids(length, channels))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=LAYER_ATOL)


def test_params_from_jax_encdec_tree(jx, jx_run):
    jp, tp = _np_tree(jx, jx_run.jp), jx_run.tp
    assert tree_family(jp) == "encdec"
    assert "lm_head" not in tp
    assert len(tp["encoder"]) == len(tp["decoder"]) == 2
    for k in ("embed", "pos_dec"):
        np.testing.assert_array_equal(tp[k].numpy(), jp[k])
    for k in ("enc_norm", "dec_norm"):
        for leaf in ("scale", "bias"):
            np.testing.assert_array_equal(tp[k][leaf].numpy(), jp[k][leaf])
    for stack in ("encoder", "decoder"):
        flat = jx.jax.tree_util.tree_flatten_with_path(jp[stack])[0]
        for i, layer in enumerate(tp[stack]):
            for path, leaf in flat:
                got = layer
                for p in path:
                    got = got[p.key]
                np.testing.assert_array_equal(got.numpy(), leaf[i])


@pytest.mark.parametrize("remat,hidden", [(False, False), (True, False),
                                          (True, True)])
def test_forward_matches_jax(jx_run, remat, hidden):
    r = jx_run
    with torch.no_grad():
        got = forward(r.tp, r.tcfg, _tb(r.batch), remat=remat,
                      return_hidden=hidden).numpy()
    want = r.hidden if hidden else r.logits
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)


def _port_run(params, cfg, batch, pre: int, steps: int, device="cpu"):
    """``prefill`` of ``pre`` tokens, then ``steps`` ``decode_step``
    calls: [(logits, cache leaves as numpy)] after each call."""
    tb = {k: _t(v).to(device) for k, v in batch.items()}

    def host(lg, cache):     # copies: the cache is updated in place
        return lg.cpu().numpy(), {
            k: v.cpu().numpy().copy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in cache.items()}
    cache = init_cache(cfg, B, S_ENC, device)
    with torch.no_grad():
        lg, cache = prefill(params, cfg,
                            {**tb, "tokens": tb["tokens"][:, :pre]}, cache)
        seq = [host(lg, cache)]
        for i in range(pre, pre + steps):
            lg, cache = decode_step(params, cfg, tb["tokens"][:, i:i + 1],
                                    cache)
            seq.append(host(lg, cache))
    return seq


def _assert_runs_close(got, want):
    assert len(got) == len(want)
    for (gl, gc), (wl, wc) in zip(got, want):
        np.testing.assert_allclose(gl, wl, rtol=0, atol=ATOL)
        assert sorted(gc) == sorted(wc) == ["ck", "cv", "k", "pos", "v"]
        assert int(gc["pos"]) == int(wc["pos"])
        for k in ("k", "v", "ck", "cv"):
            assert gc[k].shape == wc[k].shape, k
            np.testing.assert_allclose(gc[k], wc[k], rtol=0, atol=ATOL,
                                       err_msg=k)


def test_prefill_matches_jax(jx_run):
    """``prefill``'s last logits and every cache leaf, ``ck``/``cv`` as
    long as the encoder."""
    got = _port_run(jx_run.tp, jx_run.tcfg, jx_run.batch, PRE, 0)
    assert got[0][1]["ck"].shape[3] == S_ENC
    _assert_runs_close(got, jx_run.steps[:1])


def test_decode_steps_match_jax(jx_run):
    r = jx_run
    _assert_runs_close(_port_run(r.tp, r.tcfg, r.batch, PRE, S - PRE),
                       r.steps)


def test_decode_matches_forward(jx_run):
    """Prefill + decode give the port's own ``forward`` logits at every
    position (the contract of ``tests/test_decode_consistency.py``)."""
    r = jx_run
    with torch.no_grad():
        full = forward(r.tp, r.tcfg, _tb(r.batch), remat=False).numpy()
    seq = _port_run(r.tp, r.tcfg, r.batch, PRE, S - PRE)
    for j, (lg, _) in enumerate(seq):
        np.testing.assert_allclose(lg, full[:, PRE - 1 + j], rtol=0,
                                   atol=ATOL)


def test_decoder_past_max_decoder_len_matches_jax(jx_run):
    """Prefill 60 tokens, then 8 steps to position 67 of a 64-slot
    self-cache: from position 64 on the key overwrites slot 63, the
    attention reads all 64 slots and the position embedding stays at 63,
    as JAX's ``decode_step`` does (not ``forward``'s function past the
    cache, by design)."""
    r = jx_run
    got = _port_run(r.tp, r.tcfg, r.long, LONG_PRE, LONG_STEPS)
    assert got[-1][1]["k"].shape[3] == r.tcfg.max_decoder_len == 64
    assert int(got[-1][1]["pos"]) == LONG_PRE + LONG_STEPS
    _assert_runs_close(got, r.long_steps)


def test_chunked_encode_matches_jax(jx_run):
    """``encode`` over 2,100 frames takes ``chunked_attention`` (above
    2,048), as JAX's does; it also equals the port's dense route."""
    r = jx_run
    frames = _t(r.frames_long)
    with torch.no_grad():
        got = TE.encode(r.tp, r.tcfg, frames).numpy()
        dense = TE.encode(r.tp, r.tcfg, frames, chunked=False).numpy()
    np.testing.assert_allclose(got, r.enc_long, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, dense, rtol=0, atol=ATOL)


@pytest.mark.parametrize("mode", ["kv_fused", "kv", "reprefill"])
def test_serve_refuses_the_family(mode):
    """No serving engine passes stub inputs (JAX's pass tokens only):
    ``launch/serve.py`` refuses the arch under every cache mode."""
    from repro_torch.launch.serve import check_cache_mode
    with pytest.raises(ValueError, match="no serving engine"):
        check_cache_mode(ARCH, mode)


def test_train_launcher_refuses_the_family():
    """``launch/train.py`` refuses the arch, as JAX's launcher does
    (``lm_dataset`` makes no frames or images); the trainer takes it."""
    from repro_torch.launch import train as launch
    with pytest.raises(SystemExit, match="decoder-only"):
        launch.main(["--arch", ARCH, "--reduced", "--device", "cpu"])


def _bump_port(tree, gen):
    """The port's counterpart of ``_bump_jax``, in place."""
    for k, v in (tree.items() if isinstance(tree, dict) else enumerate(tree)):
        if isinstance(v, (dict, list)):
            _bump_port(v, gen)
        elif k in BIASES:
            tree[k] = torch.randn(v.shape, generator=gen) * 0.5
    return tree


@pytest.mark.cuda
def test_reduced_model_on_card_matches_cpu(cuda):
    """The reduced model (nonzero biases) on the card against the CPU:
    ``forward``, ``prefill`` + 8 ``decode_step`` logits and caches,
    within 1e-4."""
    from repro_torch.optim import tree_map
    cfg = get_config(ARCH).reduced()
    gen = torch.Generator().manual_seed(0)
    tp = _bump_port(init_params(gen, cfg, "cpu"), gen)
    dev_p = tree_map(lambda t: t.to(cuda), tp)
    batch = _inputs(cfg, 1, S)
    with torch.no_grad():
        want = forward(tp, cfg, _tb(batch)).numpy()
        got = forward(dev_p, cfg, {k: _t(v).to(cuda) for k, v in
                                   batch.items()}).cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    card = _port_run(dev_p, cfg, batch, PRE, S - PRE, device=cuda)
    host = _port_run(tp, cfg, batch, PRE, S - PRE)
    for (gl, gc), (wl, wc) in zip(card, host):
        np.testing.assert_allclose(gl, wl, rtol=0, atol=1e-4)
        for k in ("k", "v", "ck", "cv"):
            np.testing.assert_allclose(gc[k], wc[k], rtol=0, atol=1e-4)
