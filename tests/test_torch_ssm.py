"""The port's Mamba-2 path against the JAX package on the CPU.

* ``ssd_chunk_plain`` against JAX's Pallas ``ssd_chunk`` (interpret mode:
  its body on the CPU) and ``ssd_chunk_ref`` at the three shapes of
  ``tests/test_ssd_kernel.py``: atol = rtol = 5e-4 on ``y`` and the
  states, 1e-5 on the total log-decay -- the JAX test's own tolerances
  (einsum and cumsum orders differ; outputs reach |y| ~ 100);
* the port's ``ssd_chunked`` against ``mamba2.ssd_chunked`` and
  ``ssd_chunked_kernel``, ragged S = 20 and a given ``h0`` included:
  atol = rtol = 2e-3, the JAX test's tolerance for the chunked path;
* ``params_from_jax`` on the SSM tree, then ``forward`` logits and
  ``prefill``/``decode_step`` logits and caches against JAX's (the
  ``ssm`` case of ``tests/test_decode_consistency.py``): atol 1e-5;
* the port's own prefill + decode against its forward: 2e-3, the JAX
  test's tolerance;
* mamba2-370m's config equal to JAX's field by field, except ``dtype``.

The JAX side is imported inside the CPU tests, so the ``cuda`` tests run
on a machine with the card and no JAX:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ssm.py``."""

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.mode import launch_counts
from repro_torch.kernels.ssd_chunk.ops import ssd_chunk, ssd_chunked
from repro_torch.kernels.ssd_chunk.ref import ssd_chunk_plain
from repro_torch.models import (
    ModelConfig,
    decode_step,
    forward,
    init_cache,
    init_params,
    params_from_jax,
    prefill,
)

ATOL_CHUNK = RTOL_CHUNK = 5e-4
TOL_TOTAL = 1e-5
TOL_CHUNKED = 2e-3
ATOL_LOGITS = 1e-5
TOL_DECODE = 2e-3
# tests/test_decode_consistency.py:28, the ssm case.
SSM = dict(name="s", family="ssm", num_layers=2, d_model=64, num_heads=1,
           d_ff=0, vocab_size=256, ssm_state=16, ssm_head_dim=32,
           ssm_chunk=4, dtype="float32")
SHAPES = [(1, 1, 8, 1, 16, 8), (2, 3, 16, 4, 32, 16), (1, 2, 64, 2, 64, 128)]


@pytest.fixture(scope="module")
def jx():
    import types

    import jax
    import jax.numpy as jnp
    from repro.kernels.ssd_chunk.kernel import ssd_chunk as j_ssd_chunk
    from repro.kernels.ssd_chunk.ops import ssd_chunked_kernel
    from repro.kernels.ssd_chunk.ref import ssd_chunk_ref
    from repro.models import mamba2
    return types.SimpleNamespace(jax=jax, jnp=jnp, ssd_chunk=j_ssd_chunk,
                                 ssd_chunk_ref=ssd_chunk_ref,
                                 ssd_chunked_kernel=ssd_chunked_kernel,
                                 mamba2=mamba2)


@pytest.fixture(scope="module")
def model(jx):
    from repro.models import ModelConfig as JCfg
    from repro.models import init_params as j_init
    jcfg, tcfg = JCfg(**SSM), ModelConfig(**SSM)
    jp = j_init(jx.jax.random.PRNGKey(0), jcfg)
    tp = params_from_jax(jx.jax.tree_util.tree_map(np.asarray, jp),
                         device="cpu")
    return jcfg, tcfg, jp, tp


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _chunk_inputs(seed, b, nc, q, h, p, n):
    """x, B, C normal; dt = softplus(normal); a = -exp(0.3 normal): the
    distributions of tests/test_ssd_kernel.py, drawn with numpy."""
    rng = np.random.RandomState(seed)
    x = rng.randn(b, nc, q, h, p).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, nc, q, h))).astype(np.float32)
    a = (-np.exp(rng.randn(h) * 0.3)).astype(np.float32)
    b_in = rng.randn(b, nc, q, n).astype(np.float32)
    c_in = rng.randn(b, nc, q, n).astype(np.float32)
    return x, dt, a, b_in, c_in


def _seq_inputs(seed, b, s, h, p, n):
    x, dt, a, b_in, c_in = _chunk_inputs(seed, b, 1, s, h, p, n)
    return x[:, 0], dt[:, 0], a, b_in[:, 0], c_in[:, 0]


def _close(got, want, atol, rtol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


@pytest.mark.parametrize("b,nc,q,h,p,n", SHAPES)
def test_ssd_chunk_plain_matches_jax(jx, b, nc, q, h, p, n):
    args = _chunk_inputs(q + n, b, nc, q, h, p, n)
    got = ssd_chunk_plain(*map(torch.from_numpy, args))
    kern = jx.ssd_chunk(*map(jx.jnp.asarray, args), interpret=True)
    ref = jx.ssd_chunk_ref(*map(jx.jnp.asarray, args))
    for want in (kern, ref):
        _close(got[0], want[0], ATOL_CHUNK, RTOL_CHUNK)
        _close(got[1], want[1], ATOL_CHUNK, RTOL_CHUNK)
        _close(got[2], want[2], TOL_TOTAL, TOL_TOTAL)
    assert tuple(got[1].shape) == (b, nc, h, p, n)


@pytest.mark.parametrize("s,q,h0", [(48, 16, False), (20, 8, False),
                                    (20, 8, True)])
def test_ssd_chunked_matches_jax(jx, s, q, h0):
    b, h, p, n = 2, 4, 32, 16
    args = _seq_inputs(7 + s, b, s, h, p, n)
    init = (np.random.RandomState(11).randn(b, h, p, n).astype(np.float32)
            if h0 else None)
    y, hf = ssd_chunked(*map(torch.from_numpy, args), q,
                        h0=None if init is None else torch.from_numpy(init))
    jargs = list(map(jx.jnp.asarray, args))
    jinit = None if init is None else jx.jnp.asarray(init)
    for fn in (jx.mamba2.ssd_chunked, jx.ssd_chunked_kernel):
        jy, jh = fn(*jargs, q, jinit)
        _close(y, jy, TOL_CHUNKED, TOL_CHUNKED)
        _close(hf, jh, TOL_CHUNKED, TOL_CHUNKED)
    assert tuple(y.shape) == (b, s, h, p)


def test_ssd_chunk_wrapper_takes_plain_route_on_cpu():
    args = [torch.from_numpy(x) for x in _chunk_inputs(0, 1, 2, 8, 2, 16, 8)]
    before = dict(launch_counts)
    for a, b in zip(ssd_chunk(*args), ssd_chunk_plain(*args)):
        assert torch.equal(a, b)
    assert dict(launch_counts) == before


def test_params_from_jax_ssm_tree(model):
    jcfg, tcfg, jp, tp = model
    assert len(tp["layers"]) == SSM["num_layers"]
    leaves = {"norm", "in_proj", "conv_w", "conv_b", "a_log", "dt_bias",
              "d_skip", "y_norm", "out_proj"}
    assert set(tp["layers"][0]) == leaves
    np.testing.assert_array_equal(tp["layers"][1]["in_proj"].numpy(),
                                  np.asarray(jp["layers"]["in_proj"][1]))
    np.testing.assert_array_equal(
        tp["layers"][1]["y_norm"]["scale"].numpy(),
        np.asarray(jp["layers"]["y_norm"]["scale"][1]))
    fresh = init_params(torch.Generator().manual_seed(0), tcfg, "cpu")
    for name in leaves - {"norm", "y_norm"}:
        a, b = fresh["layers"][0][name], tp["layers"][0][name]
        assert a.shape == b.shape and a.dtype == b.dtype, name
    # The deterministic leaves of the init equal JAX's.
    for name in ("a_log", "dt_bias", "d_skip", "conv_b"):
        np.testing.assert_allclose(fresh["layers"][0][name].numpy(),
                                   np.asarray(jp["layers"][name][0]),
                                   rtol=1e-6)


def test_forward_prefill_decode_match_jax(jx, model):
    """Logits of forward, prefill and four decode steps, and the conv and
    SSD caches after each call, against JAX's on the same tokens."""
    from repro.models import decode_step as j_decode
    from repro.models import forward as j_forward
    from repro.models import init_cache as j_init_cache
    from repro.models import prefill as j_prefill
    jcfg, tcfg, jp, tp = model
    toks = np.random.RandomState(1).randint(0, 100, (2, 12)).astype(np.int32)
    jfull = j_forward(jp, jcfg, {"tokens": jx.jnp.asarray(toks)},
                      remat=False)
    full = forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    _close(full, jfull, ATOL_LOGITS, 0)
    jl, jc = j_prefill(jp, jcfg, {"tokens": jx.jnp.asarray(toks[:, :7])},
                       j_init_cache(jcfg, 2, 64))
    tl, tc = prefill(tp, tcfg, {"tokens": torch.from_numpy(toks[:, :7])},
                     init_cache(tcfg, 2, 64, "cpu"))
    for i in range(7, 12):
        _close(tl, jl, ATOL_LOGITS, 0)
        for k in ("conv", "ssm"):
            assert tuple(tc[k].shape) == tuple(jc[k].shape)
            _close(tc[k], jc[k], ATOL_LOGITS, 0)
        assert tc["pos"] == int(jc["pos"]) == i
        jl, jc = j_decode(jp, jcfg, jx.jnp.asarray(toks[:, i:i + 1]), jc)
        tl, tc = decode_step(tp, tcfg, torch.from_numpy(toks[:, i:i + 1]),
                             tc)
    _close(tl, jl, ATOL_LOGITS, 0)


def test_prefill_decode_matches_forward():
    """The port on its own (tests/test_decode_consistency.py's
    invariant): prefill of 6 tokens then 6 decode steps reproduce the
    full forward's logits at every position."""
    cfg = ModelConfig(**SSM)
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, 100, (2, 12)).astype(np.int32))
    full = forward(params, cfg, {"tokens": toks})
    last, cache = prefill(params, cfg, {"tokens": toks[:, :6]},
                          init_cache(cfg, 2, 64, "cpu"))
    errs = [float((last - full[:, 5]).abs().max())]
    for i in range(6, 12):
        lg, cache = decode_step(params, cfg, toks[:, i:i + 1], cache)
        errs.append(float((lg - full[:, i]).abs().max()))
    assert max(errs) < TOL_DECODE, errs


def test_mamba2_370m_config_matches_jax():
    from repro.configs import get_config as j_get_config
    ours, theirs = get_config("mamba2-370m"), j_get_config("mamba2-370m")
    for f in ("name", "family", "num_layers", "d_model", "num_heads",
              "d_ff", "vocab_size", "num_kv_heads", "head_dim", "rope_theta",
              "ssm_state", "ssm_head_dim", "ssm_expand", "ssm_conv_width",
              "ssm_chunk", "norm_eps"):
        assert getattr(ours, f) == getattr(theirs, f), f
    for f in ("padded_vocab", "ssm_d_inner", "ssm_num_heads"):
        assert getattr(ours, f) == getattr(theirs, f), f
    assert (ours.ssm_d_inner, ours.ssm_num_heads, ours.padded_vocab) == \
        (2048, 32, 50432)
    assert ours.dtype == "float32" and theirs.dtype == "bfloat16"


def test_config_families():
    with pytest.raises(ValueError, match="item 15"):
        ModelConfig(name="m", family="encdec", num_layers=1, d_model=8,
                    num_heads=2, d_ff=8, vocab_size=10)
    with pytest.raises(ValueError, match="num_heads"):
        ModelConfig(name="d", family="dense", num_layers=1, d_model=8,
                    num_heads=0, d_ff=8, vocab_size=10)
    assert ModelConfig(**SSM).ssm_num_heads == 4


def test_dense_serving_calls_raise_in_registry():
    """The registry's dense ``prefill``/``decode_step`` (they raised
    before the kv cache mode was ported) give ``forward``'s logits, and
    ``forward`` past 2,048 tokens takes the chunked attention, equal to
    the dense path (``tests/test_torch_kv_mode.py`` holds them to JAX)."""
    cfg = ModelConfig(name="d", family="dense", num_layers=1, d_model=16,
                      num_heads=2, d_ff=16, vocab_size=10, dtype="float32")
    params = init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.tensor([[1, 4, 2, 7]])
    full = forward(params, cfg, {"tokens": toks})
    assert tuple(full.shape) == (1, 4, 256)
    logits, cache = prefill(params, cfg, {"tokens": toks[:, :3]},
                            init_cache(cfg, 1, 8, "cpu"))
    torch.testing.assert_close(logits, full[:, 2], atol=1e-6, rtol=0)
    logits, cache = decode_step(params, cfg, toks[:, 3:], cache)
    torch.testing.assert_close(logits, full[:, 3], atol=1e-6, rtol=0)
    assert cache["pos"] == 4
    long = {"tokens": torch.arange(2049).reshape(1, -1) % 10}
    torch.testing.assert_close(forward(params, cfg, long),
                               forward(params, cfg, long, chunked=False),
                               atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# On the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------


def _ssd_float64(x, dt, a, b_in, c_in):
    """``ssd_chunk_ref``'s y and states in float64: the yardstick that
    says whether the kernel or the plain version sums more exactly."""
    x, dt, a, b_in, c_in = (t.double() for t in (x, dt, a, b_in, c_in))
    q = x.shape[2]
    cum = torch.cumsum(dt * a, dim=2)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    diff = cum[:, :, :, None] - cum[:, :, None]
    decay = torch.where(tri[..., None], torch.exp(torch.where(
        tri[..., None], diff, 0.0)), 0.0)
    w = torch.einsum("bcin,bcjn->bcij", c_in, b_in)[..., None] * decay
    xdt = x * dt[..., None]
    rem = torch.exp(cum[:, :, -1:] - cum)
    return (torch.einsum("bcijh,bcjhp->bcihp", w, xdt),
            torch.einsum("bcjh,bcjn,bcjhp->bchpn", rem, b_in, xdt))


@pytest.mark.cuda
@pytest.mark.parametrize("batch,chunks,heads", [(3, 2, 32), (3, 2, 12),
                                                (1, 1, 8), (5, 3, 20)])
def test_ssd_chunk_kernel_matches_plain_on_card(cuda, batch, chunks, heads):
    """The served tile (Q 64, P 64, N 128): four full groups of 8 heads,
    a partial group (12, 20 heads), one chunk, an odd batch.  The kernel
    against the plain version at atol = rtol = 5e-4, and no further from
    a float64 reference than the plain version on y and the states.  B
    and C are views at an offset of one float (the wrapper realigns them
    for the kernel's 16-byte loads)."""
    x, dt, a, b_in, c_in = (torch.from_numpy(t).to(cuda)
                            for t in _chunk_inputs(3, batch, chunks, 64,
                                                   heads, 64, 128))
    b_in = torch.cat([b_in.flatten(), b_in.new_zeros(1)])[:-1].reshape(
        b_in.shape)
    c_in = torch.cat([c_in.new_zeros(1), c_in.flatten()])[1:].reshape(
        c_in.shape)
    assert c_in.data_ptr() % 16 == 4
    args = (x, dt, a, b_in, c_in)
    before = launch_counts["ssd_chunk"]
    got = ssd_chunk(*args)
    want = ssd_chunk_plain(*args)
    torch.cuda.synchronize()
    assert launch_counts["ssd_chunk"] == before + 1
    for g, w, tol in zip(got, want, (ATOL_CHUNK, ATOL_CHUNK, TOL_TOTAL)):
        _close(g.cpu(), w.cpu(), tol, tol)
    for g, w, e in zip(got, want, _ssd_float64(*args)):
        err_kernel = float((g.double() - e).abs().max())
        err_plain = float((w.double() - e).abs().max())
        assert err_kernel <= err_plain, (err_kernel, err_plain)


@pytest.mark.cuda
def test_ssd_chunk_rejects_uncompiled_tile(cuda):
    args = [torch.from_numpy(x).to(cuda)
            for x in _chunk_inputs(0, 1, 2, 32, 2, 64, 128)]
    with pytest.raises(RuntimeError, match="not compiled"):
        ssd_chunk(*args)
