"""``repro_torch.device.SyncCounter``: the engine's count of the host's
waits on the card (``draft_syncs``, ``host_syncs``).  On the CPU nothing
is waited for; on the card each synchronising operation counts once.
Also ``launch/profile_round.analyse``, which splits a profiler trace's
device time by phase, on a synthetic trace."""

import warnings

import numpy as np
import pytest
import torch

from repro_torch.device import SyncCounter, to_device


def test_sync_counter_is_zero_on_cpu_and_passes_other_warnings():
    x = torch.arange(10)
    with warnings.catch_warnings(record=True) as outer:
        warnings.simplefilter("always")
        with SyncCounter(torch.device("cpu")) as c:
            x.sum().item()
            x.cpu().numpy()
            warnings.warn("unrelated")
    assert c.count == 0
    assert [str(w.message) for w in outer] == ["unrelated"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: sync counting watches the card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_sync_counter_counts_host_waits_on_card(cuda):
    x = torch.arange(10, device=cuda)
    with SyncCounter(cuda) as none:
        to_device(np.arange(4), cuda)        # non-blocking: no wait
        y = x * 2
    with SyncCounter(cuda) as three:
        y.sum().item()
        x.cpu()
        x[:3].cpu()
    with warnings.catch_warnings(record=True) as outer:
        warnings.simplefilter("always")
        with SyncCounter(cuda) as other:
            warnings.warn("unrelated")
    assert (none.count, three.count, other.count) == (0, 3, 0)
    assert [str(w.message) for w in outer] == ["unrelated"]
    assert torch.cuda.get_sync_debug_mode() == 0


def test_params_from_jax_defaults_to_the_card(monkeypatch):
    """Like every entry point, ``params_from_jax`` runs on the card unless
    the caller asks for the CPU: with no card and no device it raises."""
    from repro_torch.models import params_from_jax
    tree = {"embed": np.zeros((4, 2), np.float32),
            "layers": {"attn_norm": {"scale": np.ones((1, 2), np.float32)},
                       "attn": {w: np.zeros((1, 2, 2), np.float32)
                                for w in ("wq", "wk", "wv", "wo")},
                       "mlp_norm": {"scale": np.ones((1, 2), np.float32)},
                       "mlp": {w: np.zeros((1, 2, 2), np.float32)
                               for w in ("w_gate", "w_up", "w_down")}},
            "final_norm": {"scale": np.ones(2, np.float32)},
            "lm_head": np.zeros((2, 4), np.float32)}
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_jax(tree)
    cpu = params_from_jax(tree, device="cpu")
    assert cpu["embed"].device.type == "cpu" and len(cpu["layers"]) == 1


def test_analyse_attributes_runtime_and_driver_launches():
    """A kernel belongs to the phase range its launch call falls in,
    whether the call is a runtime launch (PyTorch's own kernels) or a
    driver launch (cuBLAS's GEMMs): both kernels below count."""
    from repro_torch.launch.profile_round import analyse

    def x(cat, name, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": args}
    trace = {"traceEvents": [
        x("user_annotation", "serve/step", 0, 100),
        x("user_annotation", "block/forward", 0, 50),
        x("cuda_runtime", "cudaLaunchKernel", 10, 1, correlation=1),
        x("cuda_driver", "cuLaunchKernelEx", 20, 1, correlation=2),
        x("kernel", "elementwise", 30, 5, correlation=1),
        x("kernel", "sgemm", 40, 20, correlation=2),
    ]}
    res = analyse(trace, 1, prefix="block/")
    assert res["phases"]["block/forward"]["device_ms"] == pytest.approx(
        0.025)
    assert res["device_busy_ms_per_round"] == pytest.approx(0.025)
    assert res["launches_per_round"] == 2


def test_quantize_weight_layout_by_device():
    """A CPU weight's int8 payload is row-major; the values of a CUDA
    weight's (column-major, for torch._int_mm) are the same numbers."""
    from repro_torch.serving.quant import quantize_weight
    w = torch.from_numpy(np.random.RandomState(0).randn(24, 16).astype(
        np.float32))
    q = quantize_weight(w)["q"]
    assert q.is_contiguous() and q.dtype == torch.int8
    with pytest.raises(ValueError, match="multiples of 8"):
        from repro_torch.serving.quant import _int_mm
        _int_mm(torch.zeros((20, 12), dtype=torch.int8),
                torch.zeros((12, 16), dtype=torch.int8))


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(5, 960, 320), (160, 960, 960),
                                   (160, 2560, 960), (32, 960, 49152)])
def test_qdot_exact_int_product_on_card(cuda, m, k, n):
    """On the card ``qdot`` multiplies int8 by int8 into int32 exactly
    (``torch._int_mm``; fewer than 17 rows are padded), at smollm-360m's
    projection shapes including w_down's K = 2560 where the CPU's float32
    emulation is not exact: bit-equal to the exact integer product of the
    same quantized operands, rescaled by the same float32 operations on
    the card."""
    from repro_torch.serving.quant import qdot, quantize_weight
    rng = np.random.RandomState(m + k)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(cuda)
    w = torch.from_numpy((rng.randn(k, n) / 30).astype(np.float32))
    wq = quantize_weight(w.to(cuda))
    assert wq["q"].stride() == (1, k)           # column-major
    got = qdot(x, wq)
    sx = torch.clamp(x.abs().amax(-1, keepdim=True) / 127.0, min=1e-8)
    xq = torch.clamp(torch.round(x / sx), -127, 127)
    acc = (xq.cpu().long() @ wq["q"].cpu().long()).float().to(cuda)
    assert torch.equal(got, acc * sx * wq["s"])
