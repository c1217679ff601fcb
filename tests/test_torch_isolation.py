"""The port stands alone: every module of ``repro_torch`` imports with JAX
made unimportable and loads nothing of the JAX package ``repro``; its
entry points refuse to run on the CPU unless asked to; ``chip_smoke.py``
fails, printing no result, where there is no card."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

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
        import torch
        assert torch.backends.cuda.matmul.allow_tf32 is False
        assert torch.backends.cudnn.allow_tf32 is False
        assert torch.get_float32_matmul_precision() == "highest"
        print(len(names))
    """)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 20


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
