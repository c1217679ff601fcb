"""The VLM family (llama-3.2-vision) in the port against the JAX package
on the CPU.

* ``llama-3.2-vision-11b`` and its ``reduced()`` variant equal JAX's
  configs field by field, and ``layout`` gives JAX's units.
* ``params_from_jax`` carries the vlm tree leaf for leaf, bit for bit,
  and tells it from the hybrid tree (both have ``units``) by its keys.
* The reduced model (one unit: 4 self-attention blocks and one gated
  cross block), its two gates set nonzero on both sides (at init they
  are 0, and ``tanh(0)`` would drop the cross block): ``forward`` (remat
  on and off, and ``return_hidden``), ``prefill``'s last logits and
  every cache leaf (``k``, ``v``, ``ck``, ``cv``, ``pos``), and 8
  ``decode_step`` calls' logits and caches within atol 1e-5 of JAX's;
  the decode against the port's own ``forward``; other images move
  every step's logits (the image cache is read).
* ``launch/serve.py`` refuses the arch under every cache mode (no engine
  passes stub inputs, as in JAX), and ``launch/train.py`` refuses it, as
  JAX's launcher does.
* One ``cuda`` case runs the reduced model on the card against the CPU.

JAX's outputs are computed once per module (``jx_run``).  JAX is
imported inside the CPU tests' fixtures, so the ``cuda`` test runs on a
machine with the card and no JAX:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_vlm.py``."""

import functools
import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.models import vlm as TV
from repro_torch.models import (decode_step, forward, init_cache,
                                init_params, params_from_jax, prefill)
from repro_torch.models.convert import tree_family

# One intra-op thread: the suite runs under several pytest-xdist workers
# on a few cores, where torch's default of a thread a core makes the
# workers contend over tensors of a few kilobytes.
torch.set_num_threads(1)

ARCH = "llama-3.2-vision-11b"
ATOL = 1e-5
B, S, PRE, MAX_LEN = 2, 20, 12, 32
GATES = ("gate_attn", "gate_mlp")


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as j_get
    from repro.models import registry as JR
    from repro.models import vlm as JV
    return types.SimpleNamespace(jax=jax, jnp=jnp, get=j_get, V=JV, R=JR)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _t(a):
    return torch.from_numpy(np.array(a))


def _np_tree(jx, tree):
    return jx.jax.tree.map(np.asarray, tree)


def _gate_values(seed: int, n: int) -> np.ndarray:
    return np.random.default_rng(seed).uniform(0.3, 1.2, n).astype(
        np.float32) * np.where(np.arange(n) % 2, -1, 1).astype(np.float32)


def _bump_jax(jx, tree, seed: int):
    """Both gates of every cross block set to +-(0.3..1.2) from
    ``seed``."""
    units = dict(tree["units"])
    cross = dict(units["cross"])
    for i, g in enumerate(GATES):
        n = cross[g].shape[0]
        cross[g] = jx.jnp.asarray(_gate_values(seed + i, n))
    units["cross"] = cross
    return {**tree, "units": units}


def _inputs(cfg, seed: int, s: int = S):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, cfg.vocab_size, (B, s))
            .astype(np.int32),
            "images": rng.normal(size=(B, cfg.num_image_tokens, cfg.d_model))
            .astype(np.float32)}


def _cache_np(cache) -> dict:
    return {k: np.asarray(v) for k, v in cache.items()}


@pytest.fixture(scope="module")
def jx_run(jx):
    """JAX's reduced model (nonzero gates), its port, and JAX's outputs:
    forward logits and hidden state, prefill and 8 decode steps with
    their caches."""
    jcfg = jx.get(ARCH).reduced()
    tcfg = get_config(ARCH).reduced()
    jit = functools.partial(jx.jax.jit, static_argnums=1)
    jp = _bump_jax(jx, jit(jx.R.init_params)(jx.jax.random.PRNGKey(0), jcfg),
                   3)
    tp = params_from_jax(_np_tree(jx, jp), device="cpu")
    batch = _inputs(jcfg, 1)
    jb = {k: jx.jnp.asarray(v) for k, v in batch.items()}
    out = types.SimpleNamespace(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=tp,
                                batch=batch)

    def forward_both(params, cfg, b):    # one program: logits, hidden
        return (jx.R.forward(params, cfg, b, remat=False),
                jx.R.forward(params, cfg, b, remat=False, return_hidden=True))
    out.logits, out.hidden = map(np.asarray, jit(forward_both)(jp, jcfg, jb))
    prefill_j = jx.jax.jit(jx.R.prefill, static_argnums=1)
    decode_j = jx.jax.jit(jx.R.decode_step, static_argnums=1)
    cache = jx.R.init_cache(jcfg, B, MAX_LEN)
    lg, cache = prefill_j(jp, jcfg, {**jb, "tokens": jb["tokens"][:, :PRE]},
                          cache)
    out.steps = [(np.asarray(lg), _cache_np(cache))]
    for i in range(PRE, S):
        lg, cache = decode_j(jp, jcfg, jb["tokens"][:, i:i + 1], cache)
        out.steps.append((np.asarray(lg), _cache_np(cache)))
    return out


def _tb(batch, device="cpu"):
    return {k: _t(v).to(device) for k, v in batch.items()}


def _port_run(params, cfg, batch, pre: int, steps: int, device="cpu"):
    """``prefill`` of ``pre`` tokens, then ``steps`` ``decode_step``
    calls: [(logits, cache leaves as numpy)] after each call."""
    tb = _tb(batch, device)

    def host(lg, cache):     # copies: the cache is updated in place
        return lg.cpu().numpy(), {
            k: v.cpu().numpy().copy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in cache.items()}
    cache = init_cache(cfg, B, MAX_LEN, device)
    with torch.no_grad():
        lg, cache = prefill(params, cfg,
                            {**tb, "tokens": tb["tokens"][:, :pre]}, cache)
        seq = [host(lg, cache)]
        for i in range(pre, pre + steps):
            lg, cache = decode_step(params, cfg, tb["tokens"][:, i:i + 1],
                                    cache)
            seq.append(host(lg, cache))
    return seq


def _assert_runs_close(got, want, atol=ATOL):
    assert len(got) == len(want)
    for (gl, gc), (wl, wc) in zip(got, want):
        np.testing.assert_allclose(gl, wl, rtol=0, atol=atol)
        assert sorted(gc) == sorted(wc) == ["ck", "cv", "k", "pos", "v"]
        assert int(gc["pos"]) == int(wc["pos"])
        for k in ("k", "v", "ck", "cv"):
            assert gc[k].shape == wc[k].shape, k
            np.testing.assert_allclose(gc[k], wc[k], rtol=0, atol=atol,
                                       err_msg=k)


def test_config_and_reduced_match_jax(jx):
    ours, theirs = get_config(ARCH), jx.get(ARCH)
    assert ours.family == "vlm" and ours.dtype == "float32"
    for o, t in ((ours, theirs), (ours.reduced(), theirs.reduced())):
        for field in ("name", "family", "num_layers", "d_model",
                      "num_heads", "num_kv_heads", "head_dim", "d_ff",
                      "vocab_size", "rope_theta", "norm_eps",
                      "cross_attn_period", "num_image_tokens",
                      "max_seq_len", "resolved_head_dim", "kv_heads",
                      "padded_vocab"):
            assert getattr(o, field) == getattr(t, field), field
        assert TV.layout(o) == jx.V.layout(t)
    assert TV.layout(ours) == (8, 4) and TV.layout(ours.reduced()) == (1, 4)
    assert ours.reduced().num_image_tokens == 16


def test_params_from_jax_vlm_tree(jx, jx_run):
    """Every leaf bit for bit; the vlm tree is not taken for a hybrid
    one (both keep ``units``), nor the hybrid tree for a vlm one."""
    jp, tp = _np_tree(jx, jx_run.jp), jx_run.tp
    assert tree_family(jp) == "vlm"
    # The hybrid tree's layout, its leaves zeros (no init needed).
    hybrid_cfg = jx.get("recurrentgemma-2b").reduced()
    hybrid = jx.jax.tree.map(
        lambda a: np.zeros(a.shape, a.dtype),
        jx.jax.eval_shape(lambda k: jx.R.init_params(k, hybrid_cfg),
                          jx.jax.random.PRNGKey(0)))
    assert tree_family(hybrid) == "hybrid"
    assert "rec" in params_from_jax(hybrid, device="cpu")["units"][0]
    for k in ("embed", "lm_head"):
        np.testing.assert_array_equal(tp[k].numpy(), jp[k])
    np.testing.assert_array_equal(tp["final_norm"]["scale"].numpy(),
                                  jp["final_norm"]["scale"])
    n_units, n_self = TV.layout(jx_run.tcfg)
    assert len(tp["units"]) == n_units
    for part, idx in (("self", lambda u, i: (u, i)),
                      ("cross", lambda u, i: u)):
        for path, leaf in jx.jax.tree_util.tree_flatten_with_path(
                jp["units"][part])[0]:
            for u in range(n_units):
                for i in range(n_self if part == "self" else 1):
                    got = tp["units"][u][part]
                    if part == "self":
                        got = got[i]
                    for p in path:
                        got = got[p.key]
                    np.testing.assert_array_equal(got.numpy(),
                                                  leaf[idx(u, i)])
    gates = [float(tp["units"][0]["cross"][g]) for g in GATES]
    assert all(abs(g) >= 0.3 for g in gates), gates


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


def test_prefill_matches_jax(jx_run):
    r = jx_run
    got = _port_run(r.tp, r.tcfg, r.batch, PRE, 0)
    assert got[0][1]["ck"].shape[3] == r.tcfg.num_image_tokens
    _assert_runs_close(got, r.steps[:1])


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
    for j, (lg, _) in enumerate(_port_run(r.tp, r.tcfg, r.batch, PRE,
                                          S - PRE)):
        np.testing.assert_allclose(lg, full[:, PRE - 1 + j], rtol=0,
                                   atol=ATOL)


def test_images_reach_every_step(jx_run):
    """Other images (the same tokens) move the prefill's and every decode
    step's logits: the gated block reads the image cache."""
    r = jx_run
    other = dict(r.batch, images=_inputs(r.tcfg, 9)["images"])
    a = _port_run(r.tp, r.tcfg, r.batch, PRE, S - PRE)
    b = _port_run(r.tp, r.tcfg, other, PRE, S - PRE)
    for (la, _), (lb, _) in zip(a, b):
        assert np.abs(la - lb).max() > 1e-2


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


def _bump_port(params, seed: int):
    """The port's counterpart of ``_bump_jax``."""
    for i, g in enumerate(GATES):
        vals = _gate_values(seed + i, len(params["units"]))
        for u, v in zip(params["units"], vals):
            u["cross"][g] = torch.tensor(float(v))
    return params


@pytest.mark.cuda
def test_reduced_model_on_card_matches_cpu(cuda):
    """The reduced model (nonzero gates) on the card against the CPU:
    ``forward``, ``prefill`` + 8 ``decode_step`` logits and caches,
    within 1e-4."""
    from repro_torch.optim import tree_map
    cfg = get_config(ARCH).reduced()
    tp = _bump_port(init_params(torch.Generator().manual_seed(0), cfg,
                                "cpu"), 3)
    dev_p = tree_map(lambda t: t.to(cuda), tp)
    batch = _inputs(cfg, 1)
    with torch.no_grad():
        want = forward(tp, cfg, _tb(batch)).numpy()
        got = forward(dev_p, cfg, _tb(batch, cuda)).cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    _assert_runs_close(_port_run(dev_p, cfg, batch, PRE, S - PRE, cuda),
                       _port_run(tp, cfg, batch, PRE, S - PRE), atol=1e-4)
