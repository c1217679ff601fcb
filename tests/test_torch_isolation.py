"""The port stands alone: every module of ``repro_torch`` imports with JAX
and ``msgpack`` made unimportable and loads nothing of the JAX package
``repro``, and so its checkpoints and example twins run; its entry points (the engine, the trainer, the VAE's
training and evaluation) refuse to run on the CPU unless asked to;
``chip_smoke.py`` fails, printing no result, where there is no card."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

# One intra-op thread: the suite runs under several pytest-xdist workers
# on a few cores, where torch's default of a thread a core makes the
# workers contend over tensors of a few kilobytes.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")


def _run(code: str, cwd: str = ROOT):
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_every_module_imports_without_jax_or_repro():
    res = _run("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None          # any `import jax` now fails
        sys.modules["msgpack"] = None      # the card's machine has none
        import repro_torch
        names = ["repro_torch"] + [
            m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                  "repro_torch.")]
        for name in names:
            importlib.import_module(name)
        leaked = sorted(m for m in sys.modules
                        if m == "repro" or m.startswith("repro."))
        assert not leaked, leaked
        assert not any(m.startswith("jax.") for m in sys.modules)
        assert not any(m.startswith("msgpack.") for m in sys.modules)
        import torch
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.get_float32_matmul_precision() == "highest"
        print(len(names))
    """)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 20


def test_checkpoint_and_twins_run_without_jax_or_msgpack():
    """The checkpoint writer and reader (a hand-written msgpack codec) and
    the example twins need neither JAX nor ``msgpack``."""
    res = _run("""
        import os, sys, tempfile
        sys.modules["jax"] = None
        sys.modules["msgpack"] = None
        import torch
        from repro_torch.launch import quickstart, serve_scheduler
        from repro_torch.launch import serve_specdec  # noqa: F401
        from repro_torch.models import (ModelConfig, init_params,
                                        params_from_jax, params_to_jax)
        from repro_torch.train import load_checkpoint, save_checkpoint
        cfg = ModelConfig(name="t", family="dense", num_layers=2,
                          d_model=32, num_heads=2, d_ff=64, vocab_size=100,
                          dtype="float32")
        params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
        path = os.path.join(tempfile.mkdtemp(), "ck.msgpack")
        save_checkpoint(path, {"params": params_to_jax(params),
                               "bf16": torch.ones(3, dtype=torch.bfloat16)})
        back = load_checkpoint(path, device="cpu")
        again = params_from_jax(back["params"], device="cpu")
        assert torch.equal(again["layers"][1]["attn"]["wq"],
                           params["layers"][1]["attn"]["wq"])
        assert back["bf16"].dtype == torch.bfloat16
        quickstart.main(["--device", "cpu", "--trials", "200"],
                        log=lambda *_: None)
        out = serve_scheduler.main(["--device", "cpu", "--steps", "2",
                                    "--requests", "1", "--max-new", "3",
                                    "--max-batch", "1"], log=lambda *_: None)
        assert not any(m == "repro" or m.startswith(("repro.", "jax."))
                       for m in sys.modules)
        print(len(out["outputs"]))
    """)
    assert res.returncode == 0, res.stderr
    assert res.stdout.split()[-1] == "3"


def test_engine_without_device_refuses_cpu():
    """No ``device=`` means the card; without one the engine raises
    instead of silently running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    from repro_torch.device import resolve_device
    from repro_torch.models import ModelConfig, init_params
    from repro_torch.specdec import CachedSpecDecEngine, SpecDecConfig
    cfg = ModelConfig(name="t", family="dense", num_layers=1, d_model=32,
                      num_heads=2, d_ff=64, vocab_size=100, dtype="float32")
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        CachedSpecDecEngine((params, cfg), (params, cfg),
                            SpecDecConfig(num_drafts=2, draft_len=2))
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device(None)
    eng = CachedSpecDecEngine((params, cfg), (params, cfg),
                              SpecDecConfig(num_drafts=2, draft_len=2),
                              device="cpu")
    assert eng.device.type == "cpu"
    out = eng.generate(torch.tensor([0, 3]), np.array([1, 2, 3]), max_new=4)
    assert len(out.output) == 4


def test_training_entry_points_without_device_refuse_cpu():
    """``train``, ``train_vae`` and ``evaluate_rd`` with ``device=None``
    mean the card; without one they raise before any work."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    from repro_torch import random as R
    from repro_torch.compression import VAETrainConfig, evaluate_rd, train_vae
    from repro_torch.configs import get_config
    from repro_torch.data import digits_dataset, lm_dataset
    from repro_torch.models import init_params
    from repro_torch.train import TrainConfig, train
    cfg = get_config("smollm-360m").reduced()
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    ds = lm_dataset(2, 16, cfg.vocab_size, num_sentences=50)
    with pytest.raises(RuntimeError, match="CUDA"):
        train(params, cfg, TrainConfig(total_steps=1), ds)
    imgs, _ = digits_dataset(8)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_vae(R.PRNGKey(0), imgs, VAETrainConfig(steps=1))
    vae = train_vae(R.PRNGKey(0), imgs, VAETrainConfig(steps=1, batch=4),
                    device="cpu", log=lambda *_: None)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate_rd(R.PRNGKey(1), vae, imgs, n_atoms=16, l_max=2, k=1,
                    trials=2)
    got = evaluate_rd(R.PRNGKey(1), vae, imgs, n_atoms=16, l_max=2, k=1,
                      trials=2, device="cpu")
    assert got["rate_bits"] == 1.0
    _, hist = train(params, cfg, TrainConfig(total_steps=1), ds,
                    device="cpu", log=lambda *_: None)
    assert np.isfinite(hist[0]["loss"])


def test_chip_smoke_fails_without_card(tmp_path):
    """Without a card -- and in a directory holding chip_smoke.py alone --
    the script exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    script = os.path.join(ROOT, "chip_smoke.py")
    lone = tmp_path / "chip_smoke.py"
    lone.write_text(open(script).read())
    for path, cwd in ((script, ROOT), (str(lone), str(tmp_path))):
        res = subprocess.run([sys.executable, path], cwd=cwd,
                             capture_output=True, text=True, timeout=300)
        assert res.returncode != 0
        assert '"ok"' not in res.stdout
