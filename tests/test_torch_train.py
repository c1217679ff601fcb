"""The port's training path against the JAX package on the CPU, on the
same numpy data and carried parameters (``params_from_jax``).

* ``lm_dataset`` batches: bit-equal;
* the warmup-cosine and cosine schedules: rtol 1e-6;
* ``clip_by_global_norm`` and ``adam_update`` on identical params and
  grads: rtol 1e-6 (float32 constants formed as JAX forms them);
* ``lm_loss`` and its gradients for the reduced dense (also through
  ``chunked_ce``), moe (with its aux loss), ssm, hybrid, encdec (the
  tied head, with frames) and vlm (with images) configs, encdec and vlm
  also through ``chunked_ce``, their zero-at-init biases and gates set
  nonzero: the loss to rtol 1e-5, the grads to rtol 1e-4 / atol 1e-6
  (float32 sums in another order; the port's per-layer grads restacked
  into JAX's layout);
* ``chunked_ce`` and its gradients;
* the losses of 3 ``make_train_step`` steps with ``warmup=1`` (step 0's
  lr is 0, so steps 1 and 2 move the params): rtol 1e-4;
* ``remat`` changes no number, and the ``ssd_chunk`` autograd function's
  gradients equal autograd through ``ssd_chunk_plain``;
* ``python -m repro_torch.launch.train --reduced --device cpu --steps 2``.

JAX is imported inside the CPU tests' fixtures, so the ``cuda`` test
runs on a machine with the card and no JAX:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train.py``."""

import types

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.data import lm_dataset
from repro_torch.kernels.mode import launch_counts, reset_launch_counts
from repro_torch.kernels.ssd_chunk.ops import ssd_chunk
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_plain
from repro_torch.models import forward, params_from_jax
from repro_torch.optim import (
    adam_init,
    adam_update,
    clip_by_global_norm,
    cosine_schedule,
    tree_leaves,
    tree_map,
    warmup_cosine_schedule,
)
from repro_torch.train import TrainConfig, lm_loss, make_train_step
from repro_torch.train import loop as TL

# One intra-op thread: the suite runs under several pytest-xdist workers
# on a few cores, where torch's default of a thread a core makes the
# workers contend over tensors of a few kilobytes.
torch.set_num_threads(1)

RTOL_SCHED = RTOL_ADAM = 1e-6
RTOL_LOSS = 1e-5
RTOL_GRAD, ATOL_GRAD = 1e-4, 1e-6
RTOL_STEPS = 1e-4
FAMILIES = {"dense": "smollm-360m", "moe": "granite-moe-1b-a400m",
            "ssm": "mamba2-370m", "hybrid": "recurrentgemma-2b",
            "encdec": "whisper-small", "vlm": "llama-3.2-vision-11b"}
S_FRAMES = 32          # the encdec batch's frames
BATCH, SEQ = 2, 48


@pytest.fixture(scope="module")
def jx():
    import jax
    import jax.numpy as jnp
    from repro import optim as jopt
    from repro.configs import get_config as j_get_config
    from repro.data import text as jtext
    from repro.models import init_params as j_init
    from repro.train import loop as jloop
    return types.SimpleNamespace(jax=jax, jnp=jnp, opt=jopt, text=jtext,
                                 loop=jloop, get_config=j_get_config,
                                 init=j_init)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


# Leaves that start at zero: whisper's LayerNorm and MLP biases, the vlm's
# cross-attention gates (tanh(0) = 0 would cut its cross block out).
ZERO_AT_INIT = ("bias", "b_in", "b_out", "gate_attn", "gate_mlp")


def _bump(jx, tree, seed: int):
    """Every leaf named in ``ZERO_AT_INIT`` set to +-uniform(0.2, 0.8)
    from ``seed``."""
    rng = np.random.default_rng(seed)

    def bump(path, a):
        if getattr(path[-1], "key", None) not in ZERO_AT_INIT:
            return a
        v = rng.uniform(0.2, 0.8, a.shape) * rng.choice([-1, 1], a.shape)
        return jx.jnp.asarray(v.astype(np.float32))
    return jx.jax.tree_util.tree_map_with_path(bump, tree)


def _model(jx, family, seed=0):
    """(JAX cfg, port cfg, JAX params, port params) of a reduced config,
    its zero-at-init leaves made nonzero."""
    name = FAMILIES[family]
    jcfg, tcfg = jx.get_config(name).reduced(), get_config(name).reduced()
    init = jx.jax.jit(jx.init, static_argnums=1)
    jp = _bump(jx, init(jx.jax.random.PRNGKey(seed), jcfg), seed + 7)
    tp = params_from_jax(jx.jax.tree.map(np.asarray, jp), device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture(scope="module")
def models(jx):
    """``_model(jx, family)`` built once per module: the ``lm_loss``
    cases of a family share it (none of them changes it)."""
    cache = {}

    def get(family):
        if family not in cache:
            cache[family] = _model(jx, family)
        return cache[family]
    return get


def _batch(cfg, seed=1):
    """An ``lm_dataset`` batch, with the encdec family's stub frames or
    the vlm family's stub images (normal, from ``seed``)."""
    batch = next(iter(lm_dataset(BATCH, SEQ, cfg.vocab_size, seed=seed,
                                 num_sentences=200)))
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(size=(BATCH, S_FRAMES, cfg.d_model)
                                     ).astype(np.float32)
    if cfg.family == "vlm":
        batch["images"] = rng.normal(
            size=(BATCH, cfg.num_image_tokens, cfg.d_model)).astype(
            np.float32)
    return batch


def _stack(trees):
    """A list of trees (tensor or numpy leaves) -> one tree of stacked
    numpy leaves."""
    if isinstance(trees[0], dict):
        return {k: _stack([t[k] for t in trees]) for k in trees[0]}
    return np.stack([t.detach().numpy() if isinstance(t, torch.Tensor)
                     else t for t in trees])


def restack(grads: dict, like: dict) -> dict:
    """The port's per-layer grads in JAX's stacked layout (``layers``;
    the hybrid's ``units`` with the recurrent blocks on a second axis,
    ``extra_rec``; the vlm's ``units`` with the self blocks on a second
    axis; whisper's ``encoder`` and ``decoder``), keyed as the JAX tree
    ``like``."""
    out = {}
    for k in like:
        g = grads[k]
        if k in ("layers", "extra_rec", "encoder", "decoder"):
            out[k] = _stack(g)
        elif k == "units" and "cross" in like[k]:
            out[k] = {"self": _stack([_stack(u["self"]) for u in g]),
                      "cross": _stack([u["cross"] for u in g])}
        elif k == "units":
            out[k] = {"attn": _stack([u["attn"] for u in g]),
                      "rec": _stack([_stack(u["rec"]) for u in g])}
        else:
            out[k] = tree_map(lambda t: t.detach().numpy(), g)
    return out


def embed_term_scale(tp, tcfg, batch):
    """For each (token, column) of the embedding table, the sum over the
    token's positions of |dL/dx| at the embedding output: the scale of
    the terms its gradient sums.  Taken from the same loss with a table
    of one row per position (row i = the embedding of token i), whose
    gradient is the per-position terms themselves."""
    tokens = torch.from_numpy(batch["tokens"]).long()
    per_pos = dict(tp, embed=tp["embed"][tokens.reshape(-1)].clone()
                   .requires_grad_())
    pos_batch = {k: torch.from_numpy(v) for k, v in batch.items()}
    pos_batch["tokens"] = torch.arange(tokens.numel()).reshape(tokens.shape)
    loss, _ = lm_loss(per_pos, tcfg, pos_batch)
    (terms,) = torch.autograd.grad(loss, [per_pos["embed"]])
    return torch.zeros_like(tp["embed"]).index_add_(
        0, tokens.reshape(-1), terms.abs()).numpy()


def _close_trees(jx, got_np, want, rtol, atol):
    g = jx.jax.tree_util.tree_leaves(got_np)
    w = jx.jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                                   atol=atol)


def test_lm_dataset_bit_equal(jx):
    ours = iter(lm_dataset(4, 32, 300, seed=3, num_sentences=300))
    theirs = iter(jx.text.lm_dataset(4, 32, 300, seed=3, num_sentences=300))
    for _ in range(3):
        a, b = next(ours), next(theirs)
        for k in ("tokens", "targets"):
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])
    assert int(a["tokens"].max()) < 300


def test_schedules_match_jax(jx):
    steps = np.arange(0, 60, dtype=np.int32)
    for ours, theirs in (
            (warmup_cosine_schedule(3e-4, 5, 40),
             jx.opt.warmup_cosine_schedule(3e-4, 5, 40)),
            (warmup_cosine_schedule(1e-3, 1, 3),
             jx.opt.warmup_cosine_schedule(1e-3, 1, 3)),
            (cosine_schedule(1e-3, 20), jx.opt.cosine_schedule(1e-3, 20))):
        got = ours(torch.from_numpy(steps)).numpy()
        want = np.asarray(theirs(jx.jnp.asarray(steps)))
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=RTOL_SCHED, atol=0)
    assert float(warmup_cosine_schedule(3e-4, 20, 300)(
        torch.tensor(0, dtype=torch.int32))) == 0.0


def _opt_tree(rng):
    return {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": [rng.normal(size=(5,)).astype(np.float32),
                  {"c": rng.normal(size=(2, 2)).astype(np.float32)}]}


@pytest.mark.parametrize("max_norm,wd", [(0.5, 0.01), (100.0, 0.0),
                                         (None, 0.1)])
def test_clip_and_adam_match_jax(jx, max_norm, wd):
    rng = np.random.default_rng(7)
    params = _opt_tree(rng)
    t_p = tree_map(torch.from_numpy, params)
    j_p = jx.jax.tree.map(jx.jnp.asarray, params)
    t_opt, j_opt = adam_init(t_p), jx.opt.adam_init(j_p)
    if max_norm is not None:
        g = _opt_tree(rng)
        tc, tn = clip_by_global_norm(tree_map(torch.from_numpy, g), max_norm)
        jc, jn = jx.opt.clip_by_global_norm(
            jx.jax.tree.map(jx.jnp.asarray, g), max_norm)
        np.testing.assert_allclose(float(tn), float(jn), rtol=RTOL_ADAM)
        _close_trees(jx, tree_map(lambda t: t.numpy(), tc), jc, RTOL_ADAM, 0)
    t_lr, j_lr = (warmup_cosine_schedule(1e-2, 1, 5),
                  jx.opt.warmup_cosine_schedule(1e-2, 1, 5))
    for _ in range(4):
        g = _opt_tree(rng)
        t_p, t_opt, tm = adam_update(
            t_p, tree_map(torch.from_numpy, g), t_opt, t_lr(t_opt.step),
            weight_decay=wd, max_grad_norm=max_norm)
        j_p, j_opt, jm = jx.opt.adam_update(
            j_p, jx.jax.tree.map(jx.jnp.asarray, g), j_opt,
            j_lr(j_opt.step), weight_decay=wd, max_grad_norm=max_norm)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=RTOL_ADAM)
    assert int(t_opt.step) == int(j_opt.step) == 4
    for ours, theirs in ((t_p, j_p), (t_opt.mu, j_opt.mu),
                         (t_opt.nu, j_opt.nu)):
        _close_trees(jx, tree_map(lambda t: t.numpy(), ours), theirs,
                     RTOL_ADAM, 0)


@pytest.mark.parametrize("family,chunked", [("dense", False),
                                            ("dense", True),
                                            ("moe", False), ("ssm", False),
                                            ("hybrid", False),
                                            ("encdec", False),
                                            ("encdec", True),
                                            ("vlm", False), ("vlm", True)])
def test_lm_loss_and_grads_match_jax(jx, models, monkeypatch, family,
                                     chunked):
    from repro_torch.train import value_and_grad
    jcfg, tcfg, jp, tp = models(family)
    if chunked:      # the chunked cross-entropy at a test's size
        for mod in (TL, jx.loop):
            monkeypatch.setattr(mod, "CHUNKED_CE_THRESHOLD", 1)
            monkeypatch.setattr(mod, "CE_CHUNK", 16)
    batch = _batch(tcfg)
    (jl, jm), jg = jx.jax.jit(jx.jax.value_and_grad(
        lambda p, b: jx.loop.lm_loss(p, jcfg, b), has_aux=True))(
        jp, {k: jx.jnp.asarray(v) for k, v in batch.items()})
    (tl, tm), tg = value_and_grad(
        lambda p: lm_loss(p, tcfg, {k: torch.from_numpy(v) for k, v
                                    in batch.items()}), tp)
    np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL_LOSS)
    np.testing.assert_allclose(float(tm["nll"]), float(jm["nll"]),
                               rtol=RTOL_LOSS)
    # The head: whisper's is tied to its embedding, the others' untied.
    head = TL._head_matrix(tp, tcfg)
    if family == "encdec":
        assert "lm_head" not in tp and torch.equal(head, tp["embed"].T)
    else:
        assert head is tp["lm_head"]
    got = restack(tg, jg)
    if family != "encdec":
        # The embedding table's gradient sums one term per position of
        # its token, and those terms cancel (a row's sum can be 300x
        # smaller than its terms, summed in another order by each
        # package): its rtol is relative to the sum of the terms'
        # magnitudes.  (The tied table is also the head, whose terms this
        # scale leaves out: it is held as the other leaves.)
        scale = embed_term_scale(tp, tcfg, batch)
        err = np.abs(got.pop("embed") - np.asarray(jg["embed"]))
        assert (err <= ATOL_GRAD + RTOL_GRAD * scale).all(), float(err.max())
    _close_trees(jx, got, {k: v for k, v in jg.items() if k in got},
                 RTOL_GRAD, ATOL_GRAD)


def test_chunked_ce_matches_jax(jx):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 24, 16)).astype(np.float32)
    head = rng.normal(size=(16, 256)).astype(np.float32)
    tgt = rng.integers(0, 200, (2, 24)).astype(np.int32)

    def j_fn(x, h):
        nll, zz = jx.loop.chunked_ce(x, h, jx.jnp.asarray(tgt), 200, 8)
        return nll + 0.1 * zz, (nll, zz)
    (jl, (jn, jz)), jg = jx.jax.value_and_grad(j_fn, argnums=(0, 1),
                                               has_aux=True)(
        jx.jnp.asarray(x), jx.jnp.asarray(head))
    tx, th = (torch.from_numpy(a).requires_grad_() for a in (x, head))
    tn, tz = TL.chunked_ce(tx, th, torch.from_numpy(tgt), 200, 8)
    (tn + 0.1 * tz).backward()
    np.testing.assert_allclose([float(tn.detach()), float(tz.detach())],
                               [float(jn), float(jz)],
                               rtol=RTOL_LOSS)
    for t, j in ((tx, jg[0]), (th, jg[1])):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(j),
                                   rtol=RTOL_GRAD, atol=ATOL_GRAD)


def test_train_steps_match_jax(jx):
    jcfg, tcfg, jp, tp = _model(jx, "dense", seed=2)
    tc = TrainConfig(warmup=1, total_steps=3)
    j_step = jx.loop.make_train_step(jcfg, jx.loop.TrainConfig(
        warmup=1, total_steps=3))
    t_step = make_train_step(tcfg, tc)
    j_opt, t_opt = jx.opt.adam_init(jp), adam_init(tp)
    ds = iter(lm_dataset(BATCH, SEQ, tcfg.vocab_size, seed=4,
                         num_sentences=200))
    losses = []
    for _ in range(3):
        b = next(ds)
        jp, j_opt, jm = j_step(jp, j_opt, {k: jx.jnp.asarray(v)
                                           for k, v in b.items()})
        tp, t_opt, tm = t_step(tp, t_opt, {k: torch.from_numpy(v)
                                           for k, v in b.items()})
        losses.append((float(tm["loss"]), float(jm["loss"])))
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=RTOL_SCHED)
    got, want = np.array(losses).T
    np.testing.assert_allclose(got, want, rtol=RTOL_STEPS)
    _close_trees(jx, restack(tp, jp), jp, RTOL_STEPS, 1e-6)
    # Steps 1 and 2 moved the params (step 0's lr is 0).
    start = params_from_jax(jx.jax.tree.map(np.asarray, _model(
        jx, "dense", seed=2)[2]), device="cpu")
    assert not torch.equal(tp["lm_head"], start["lm_head"])


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_remat_changes_no_number(family):
    cfg = get_config(FAMILIES[family]).reduced()
    from repro_torch.models import init_params
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg)
             .items()}
    outs = []
    for remat in (True, False):
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss, _ = lm_loss(p, cfg, batch, remat=remat)
        grads = torch.autograd.grad(loss, tree_leaves(p))
        outs.append((loss.detach(), grads))
    assert torch.equal(outs[0][0], outs[1][0])
    for a, b in zip(outs[0][1], outs[1][1]):
        assert torch.equal(a, b)
    with torch.no_grad():
        assert torch.equal(forward(params, cfg, batch, remat=True),
                           forward(params, cfg, batch, remat=False))


def _ssd_inputs(device, b=2, nc=2, q=8, h=3, p=4, n=5, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=g, device=device)
    return [mk(b, nc, q, h, p),
            torch.nn.functional.softplus(mk(b, nc, q, h)),
            -torch.exp(0.3 * mk(h)), mk(b, nc, q, n), mk(b, nc, q, n)]


def _ssd_grads(fn, inputs, weights):
    ins = [t.clone().requires_grad_() for t in inputs]
    outs = fn(*ins)
    loss = sum((o * w).sum() for o, w in zip(outs, weights))
    return [o.detach() for o in outs], torch.autograd.grad(loss, ins)


def test_ssd_chunk_gradient_equals_plain_autograd():
    inputs = _ssd_inputs("cpu")
    b, nc, q, h, p, n = 2, 2, 8, 3, 4, 5
    g = torch.Generator().manual_seed(1)
    weights = [torch.randn(s, generator=g) for s in
               ((b, nc, q, h, p), (b, nc, h, p, n), (b, nc, h))]
    got = _ssd_grads(ssd_chunk, inputs, weights)
    want = _ssd_grads(ssd_chunk_plain, inputs, weights)
    for a, c in zip(got[0] + list(got[1]), want[0] + list(want[1])):
        assert torch.equal(a, c)
    # Only x asks for a gradient, and the total (independent of x) none.
    x = inputs[0].clone().requires_grad_()
    y, _, _ = ssd_chunk(x, *inputs[1:])
    y.sum().backward()
    assert x.grad.shape == x.shape


def test_launch_train_runs_on_cpu(capsys):
    from repro_torch.launch import train as launch
    history = launch.main(["--reduced", "--device", "cpu", "--steps", "2",
                           "--batch", "2", "--seq", "32"])
    out = capsys.readouterr().out
    assert "smollm-360m-smoke" in out and "step    1 loss" in out
    assert [h["step"] for h in history] == [0, 1]
    assert all(np.isfinite(h["loss"]) for h in history)


@pytest.mark.cuda
def test_ssd_chunk_gradient_on_card(cuda):
    """The autograd function on the card (kernel forward, torch-op
    backward) against autograd through the plain version, at the
    Mamba-2 tile: forward within the kernel's 5e-4 gate, input grads
    within 1e-3 of their max."""
    inputs = _ssd_inputs(cuda, b=2, nc=2, q=64, h=4, p=64, n=128)
    g = torch.Generator(device=cuda).manual_seed(1)
    weights = [torch.randn(s, generator=g, device=cuda) for s in
               ((2, 2, 64, 4, 64), (2, 2, 4, 64, 128), (2, 2, 4))]
    reset_launch_counts()
    got = _ssd_grads(ssd_chunk, inputs, weights)
    torch.cuda.synchronize()
    assert launch_counts["ssd_chunk"] == 1
    want = _ssd_grads(ssd_chunk_plain, inputs, weights)
    for a, c in zip(got[0], want[0]):
        assert bool(((a - c).abs() <= 5e-4 + 5e-4 * c.abs()).all())
    for a, c in zip(got[1], want[1]):
        assert float((a - c).abs().max()) <= 1e-3 * float(c.abs().max())
