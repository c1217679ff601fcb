"""The port's example twins against the JAX package's examples on the CPU
(``examples/quickstart.py``, ``serve_specdec.py``, ``serve_scheduler.py``
and ``repro_torch/launch/{quickstart,serve_specdec,serve_scheduler}.py``).

* quickstart: the port's printed table is JAX's, line for line (the
  Dirichlet draws to a few ulp, the race counts equal);
* each example pair, from JAX's initial weights, trains 2 steps through
  the port's trainer to JAX's losses (rtol 1e-4);
* from the same trained weights (JAX's, carried by ``params_from_jax``)
  the served token streams equal JAX's: the serve_specdec strategy table
  and its three verifier backends (legacy, torch, kernel = JAX's legacy,
  xla, pallas), and the serve_scheduler trace under each cache mode
  (reprefill, kv, kv_fused), with JAX's rounds, target forwards and sync
  counts (kv_fused: 0 draft syncs, one host sync a round);
* each twin's ``main`` runs on the CPU at a small size.

JAX's init, train steps and engines are jitted; each example's pair is
trained once a module."""

import importlib.util
import os
import types

import numpy as np
import pytest
import torch

from repro_torch import random as R
from repro_torch.launch import quickstart as TQ
from repro_torch.launch import serve_scheduler as TSCH
from repro_torch.launch import serve_specdec as TSD
from repro_torch.models import params_from_jax

# One intra-op thread: the suite runs under several pytest-xdist workers
# on a few cores, where torch's default of a thread a core makes the
# workers contend over tensors of a few kilobytes.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL_LOSS = 1e-4
STEPS = 2
SD_REQUESTS, SD_MAX_NEW = 2, 8
SCH_REQUESTS, SCH_MAX_NEW, SCH_BATCH = 3, 6, 2
JAX_BACKEND = {"legacy": "legacy", "torch": "xla", "kernel": "pallas"}
JAX_MODE = {"reprefill": "reprefill", "kv": "kv", "kv_fused": "kv_fused"}


def _example(name: str):
    path = os.path.join(ROOT, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"_example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jx():
    import jax
    from repro.data import lm_dataset
    from repro.models import init_params
    from repro.specdec import (CachedSpecDecEngine, SpecDecConfig,
                               SpecDecEngine, SpecDecServer)
    from repro.train import TrainConfig, train
    return types.SimpleNamespace(
        jax=jax, lm_dataset=lm_dataset, init=jax.jit(init_params,
                                                     static_argnums=1),
        train=train, TrainConfig=TrainConfig, SpecDecConfig=SpecDecConfig,
        SpecDecEngine=SpecDecEngine, CachedSpecDecEngine=CachedSpecDecEngine,
        SpecDecServer=SpecDecServer)


def _np(jx, tree):
    return jx.jax.tree.map(np.asarray, tree)


def _losses(history) -> list:
    return [h["loss"] for h in history]


def _quiet(*_):
    pass


# ----------------------------------------------------------------------
# quickstart
# ----------------------------------------------------------------------

def test_quickstart_prints_jax_numbers(jx, capsys):
    _example("quickstart").main()
    want = capsys.readouterr().out.rstrip("\n").split("\n")
    lines = []
    got = TQ.main(["--device", "cpu"],
                  log=lambda s: lines.extend(str(s).split("\n")))
    assert lines == want
    assert [r[0] for r in got["rows"]] == list(TQ.KS)


# ----------------------------------------------------------------------
# serve_specdec
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def sd_pair(jx):
    """JAX's example pair: initial weights, 2 trained steps each (the
    example's schedule), the histories."""
    ex = _example("serve_specdec")
    t0 = jx.init(jx.jax.random.PRNGKey(0), ex.TARGET)
    d0 = jx.init(jx.jax.random.PRNGKey(1), ex.DRAFTER)
    init = (_np(jx, t0), _np(jx, d0))    # JAX's train donates t0, d0
    tc = jx.TrainConfig(total_steps=STEPS, log_every=max(STEPS // 3, 1),
                        lr=1e-3)
    tp, th = jx.train(t0, ex.TARGET, tc,
                      jx.lm_dataset(16, 128, ex.VOCAB, seed=0,
                                    num_sentences=6000), log=_quiet)
    dp, dh = jx.train(d0, ex.DRAFTER, tc,
                      jx.lm_dataset(16, 128, ex.VOCAB, seed=1,
                                    num_sentences=6000), log=_quiet)
    return types.SimpleNamespace(ex=ex, init=init,
                                 jax_params=(tp, dp), hist=(th, dh))


def test_serve_specdec_training_matches_jax(sd_pair):
    init = tuple(params_from_jax(p, device="cpu") for p in sd_pair.init)
    _, _, hist = TSD.train_pair(STEPS, "cpu", init=init, log=_quiet)
    for got, want in zip(hist, sd_pair.hist):
        np.testing.assert_allclose(_losses(got), _losses(want),
                                   rtol=RTOL_LOSS)


@pytest.mark.parametrize("strategy,k,backend", [
    ("gls", 8, "legacy"), ("gls", 8, "torch"), ("gls", 8, "kernel"),
    ("specinfer", 8, "torch"), ("daliri", 1, "torch")])
def test_serve_specdec_streams_match_jax(jx, sd_pair, strategy, k, backend):
    ex = sd_pair.ex
    tp, dp = sd_pair.jax_params
    prompts = TSD.make_prompts(SD_REQUESTS)
    eng = jx.SpecDecEngine(
        (tp, ex.TARGET), [(dp, ex.DRAFTER)],
        jx.SpecDecConfig(num_drafts=k, draft_len=4, strategy=strategy,
                         top_k=50, max_new_tokens=SD_MAX_NEW,
                         verifier_backend=JAX_BACKEND[backend]))
    want = eng.serve(jx.jax.random.PRNGKey(7), prompts)
    got, _, _, syncs = TSD.measure(
        params_from_jax(_np(jx, tp), device="cpu"),
        params_from_jax(_np(jx, dp), device="cpu"), strategy, k, backend,
        prompts, SD_MAX_NEW, "cpu")
    assert len(got) == len(want) == SD_REQUESTS
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.output, np.asarray(w.output))
        assert (g.blocks, g.accepted_drafts, g.host_syncs) == (
            w.blocks, w.accepted_drafts, w.host_syncs)
    assert syncs == sum(w.host_syncs for w in want)


def test_serve_specdec_main_runs_on_cpu():
    out = TSD.main(["--device", "cpu", "--steps", "1", "--requests", "1",
                    "--max-new", "4"], log=_quiet)
    assert set(out["table"]) == {s for s, _ in TSD.TABLE}
    assert set(out["backends"]) == set(TSD.BACKEND_ORDER)
    streams = [list(r[0].output) for r in out["backends"].values()]
    assert all(len(s) == 4 for s in streams)


# ----------------------------------------------------------------------
# serve_scheduler
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def sch_pair(jx):
    ex = _example("serve_scheduler")
    t0 = jx.init(jx.jax.random.PRNGKey(0), ex.TARGET)
    d0 = jx.init(jx.jax.random.PRNGKey(1), ex.DRAFTER)
    init = (_np(jx, t0), _np(jx, d0))    # JAX's train donates t0, d0
    tp, th = jx.train(t0, ex.TARGET,
                      jx.TrainConfig(total_steps=STEPS,
                                     log_every=STEPS // 2, lr=1e-3),
                      jx.lm_dataset(16, 96, ex.VOCAB, seed=0,
                                    num_sentences=4000), log=_quiet)
    dp, dh = jx.train(d0, ex.DRAFTER,
                      jx.TrainConfig(total_steps=STEPS // 2, lr=1e-3,
                                     log_every=STEPS),
                      jx.lm_dataset(16, 96, ex.VOCAB, seed=1,
                                    num_sentences=4000), log=_quiet)
    return types.SimpleNamespace(ex=ex, init=init,
                                 jax_params=(tp, dp), hist=(th, dh))


def test_serve_scheduler_training_matches_jax(sch_pair):
    init = tuple(params_from_jax(p, device="cpu") for p in sch_pair.init)
    _, _, hist = TSCH.train_pair(STEPS, "cpu", init=init, log=_quiet)
    for got, want in zip(hist, sch_pair.hist):
        np.testing.assert_allclose(_losses(got), _losses(want),
                                   rtol=RTOL_LOSS)


def _jax_serve(jx, ex, tp, dp, mode):
    """The JAX example's ``serve(mode)``."""
    sd = jx.SpecDecConfig(num_drafts=4, draft_len=3, strategy="gls",
                          top_k=50)
    if mode in ("kv", "kv_fused"):
        eng = jx.CachedSpecDecEngine((tp, ex.TARGET), (dp, ex.DRAFTER), sd,
                                     pool_slots=SCH_BATCH)
        server = jx.SpecDecServer(eng, max_batch=SCH_BATCH, cache_mode=mode)
    else:
        eng = jx.SpecDecEngine((tp, ex.TARGET), [(dp, ex.DRAFTER)], sd)
        server = jx.SpecDecServer(eng, max_batch=SCH_BATCH)
    from repro.data import encode, synthetic_corpus
    corpus = encode(synthetic_corpus(60, seed=11)) % ex.VOCAB
    for i in range(SCH_REQUESTS):
        server.submit(corpus[i * 29:i * 29 + 12], max_new=SCH_MAX_NEW)
    done = server.run(jx.jax.random.PRNGKey(7))
    return server, done


@pytest.mark.parametrize("mode", TSCH.MODES)
def test_serve_scheduler_streams_match_jax(jx, sch_pair, mode):
    ex = sch_pair.ex
    tp, dp = sch_pair.jax_params
    jserver, jdone = _jax_serve(jx, ex, tp, dp, JAX_MODE[mode])
    server, done = TSCH.serve(params_from_jax(_np(jx, tp), device="cpu"),
                              params_from_jax(_np(jx, dp), device="cpu"),
                              mode, SCH_REQUESTS, SCH_MAX_NEW, SCH_BATCH,
                              "cpu")
    assert ({r.uid: list(r.output) for r in done}
            == {r.uid: [int(t) for t in r.output] for r in jdone})
    fields = ("completed", "rounds", "target_forwards", "draft_syncs",
              "host_syncs", "total_blocks")
    m, jm = server.metrics, jserver.metrics
    assert ([getattr(m, f) for f in fields]
            == [getattr(jm, f) for f in fields])
    if mode == "kv_fused":
        assert m.draft_syncs == 0 and m.host_syncs == m.rounds


def test_serve_scheduler_main_runs_on_cpu():
    out = TSCH.main(["--device", "cpu", "--steps", "2", "--requests", "2",
                     "--max-new", "4", "--max-batch", "2"], log=_quiet)
    outs = out["outputs"]
    assert outs["reprefill"] == outs["kv"] == outs["kv_fused"]
    m = out["metrics"]["kv_fused"]
    assert m.draft_syncs == 0 and m.host_syncs == m.rounds


def test_dirichlet_matches_jax(jx):
    """``random.dirichlet`` against ``jax.random.dirichlet`` (ones and a
    vector with shapes below 1, which takes the boost): rtol 2e-6."""
    jnp = jx.jax.numpy
    for seed in range(4):
        for alpha in ([1.0] * 10, [0.5, 2.0, 3.5, 0.1]):
            want = np.asarray(jx.jax.random.dirichlet(
                jx.jax.random.PRNGKey(seed), jnp.asarray(alpha, jnp.float32)))
            got = R.dirichlet(R.PRNGKey(seed), alpha).numpy()
            np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-7)
