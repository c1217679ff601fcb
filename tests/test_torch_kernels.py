"""The port's kernels on the CPU: each plain PyTorch version against the
JAX Pallas kernel run in interpret mode (its body on the CPU) and
against the JAX reference, on the same numpy inputs.  The CUDA kernels
themselves run only on the card: their kernel-vs-plain tests carry the
``cuda`` marker and skip here.

Tolerances: the row race is bit-exact (a min/argmin reduction over the
same floats); attention is allclose at rtol 1e-5 / atol 1e-6, because
the Pallas kernel's online softmax sums in another float32 order than
one dense softmax.

The JAX side is imported inside the CPU tests, so the ``cuda`` tests run
on a machine with the card and no JAX:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels.py``."""

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.decode_attention.ref import decode_attention_plain
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_plain
from repro_torch.kernels.gls_race.ops import gls_row_race
from repro_torch.kernels.gls_race.ref import gls_row_race_plain
from repro_torch.kernels.mode import launch_counts, use_kernel

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module")
def jx():
    """The JAX kernels and references (interpret mode runs the Pallas
    bodies on the CPU)."""
    import types

    import jax.numpy as jnp
    from repro.kernels.decode_attention.kernel import decode_attention
    from repro.kernels.decode_attention.ref import decode_attention_ref
    from repro.kernels.flash_attention.kernel import flash_attention
    from repro.kernels.flash_attention.ref import flash_attention_ref
    from repro.kernels.gls_race.kernel import gls_row_race
    from repro.kernels.gls_race.ref import gls_row_race_ref
    return types.SimpleNamespace(
        jnp=jnp, decode=decode_attention, decode_ref=decode_attention_ref,
        flash=flash_attention, flash_ref=flash_attention_ref,
        row_race=gls_row_race, row_race_ref=gls_row_race_ref)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _race_inputs(b, k, n, seed):
    rng = np.random.RandomState(seed)
    u = rng.uniform(1e-6, 1.0, (b, k, n)).astype(np.float32)
    log_s = np.log(-np.log(u)).astype(np.float32)
    log_q = np.log(rng.dirichlet(np.ones(n), (b, k))).astype(np.float32)
    log_q[rng.uniform(size=(b, k, n)) < 0.3] = -np.inf   # dead symbols
    # Exact ties: two symbols of row (0, 0) share the best score.
    log_s[0, 0, [n // 3, n // 5]] = -30.0
    log_q[0, 0, [n // 3, n // 5]] = 0.0
    if b * k > 1:
        log_q[-1, -1] = -np.inf                          # all-dead row
    return log_s, log_q


@pytest.mark.parametrize("b,k,n", [(1, 1, 128), (3, 4, 300), (5, 8, 1000),
                                   (20, 8, 777)])
def test_row_race_plain_bit_exact(jx, b, k, n):
    """Plain row race == JAX interpret kernel == JAX ref, bit for bit,
    with -inf symbols, exact ties and N not a multiple of 128."""
    log_s, log_q = _race_inputs(b, k, n, seed=n)
    pm, pa = gls_row_race_plain(torch.from_numpy(log_s),
                                torch.from_numpy(log_q))
    jnp = jx.jnp
    km, ka = jx.row_race(jnp.asarray(log_s), jnp.asarray(log_q),
                         interpret=True)
    rm, ra = jx.row_race_ref(jnp.asarray(log_s), jnp.asarray(log_q))
    for m, a in ((km, ka), (rm, ra)):
        np.testing.assert_array_equal(np.asarray(m).view(np.int32),
                                      pm.numpy().view(np.int32))
        np.testing.assert_array_equal(np.asarray(a), pa.numpy())
    assert pa.dtype == torch.int32
    assert int(pa[0, 0]) == min(n // 3, n // 5)           # lower index wins
    if b * k > 1:
        assert float(pm[-1, -1]) == np.inf and int(pa[-1, -1]) == 0


def test_row_race_plain_masks_nonfinite_log_q(jx):
    """+inf log_q is dead under the reference's isfinite mask (the
    semantics the CUDA kernel implements), however small its score."""
    log_s = np.zeros((1, 1, 8), np.float32)
    log_q = np.full((1, 1, 8), -1.0, np.float32)
    log_q[0, 0, 3] = np.inf
    m, a = gls_row_race_plain(torch.from_numpy(log_s), torch.from_numpy(log_q))
    rm, ra = jx.row_race_ref(jx.jnp.asarray(log_s), jx.jnp.asarray(log_q))
    assert int(a[0, 0]) == int(ra[0, 0]) == 0
    assert float(m[0, 0]) == float(rm[0, 0]) == 1.0


def _attn_inputs(rng, b, h, hkv, s, t, d):
    q = rng.randn(b, h, s, d).astype(np.float32)
    k = rng.randn(b, hkv, t, d).astype(np.float32)
    v = rng.randn(b, hkv, t, d).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("t", [40, 130])
def test_decode_plain_matches_interpret_kernel(jx, t):
    """G = 3 grouped heads, ragged kv_len and a kv_len = 0 row: the plain
    version follows the Pallas kernel's contract (zeros on a fully
    masked row), compared with the interpret kernel on every row and
    with ``decode_attention_ref`` (plain softmax, NaN at kv_len = 0) on
    the rows with a live key."""
    rng = np.random.RandomState(t)
    q, k, v = _attn_inputs(rng, 5, 6, 2, 1, t, 16)
    q = q[:, :, 0]
    kv_len = np.array([0, 1, t // 3, t - 1, t], np.int32)
    plain = decode_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v),
                                   torch.from_numpy(kv_len)).numpy()
    jnp = jx.jnp
    kern = np.asarray(jx.decode(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), jnp.asarray(kv_len), tk=32,
                                interpret=True))
    ref = np.asarray(jx.decode_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), jnp.asarray(kv_len)))
    np.testing.assert_allclose(plain, kern, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(plain[1:], ref[1:], rtol=RTOL, atol=ATOL)
    assert (plain[0] == 0).all() and (kern[0] == 0).all()
    assert np.isnan(ref[0]).all()


@pytest.mark.parametrize("window", [0, 7])
def test_flash_plain_matches_interpret_kernel(jx, window):
    """Per-row q_offset/kv_len arena masks, a bucket-padded row (queries
    past kv_len), a row whose chunk runs past T, and a fully masked row
    (kv_len = 0) -- against the interpret kernel and the reference."""
    rng = np.random.RandomState(11 + window)
    b, h, hkv, s, t, d = 5, 6, 2, 16, 40, 16
    q, k, v = _attn_inputs(rng, b, h, hkv, s, t, d)
    q_off = np.array([0, 8, 3, 30, 0], np.int32)
    kv_len = np.array([16, 24, 10, 46, 0], np.int32)   # row 2: padded tail
    args = [jx.jnp.asarray(x) for x in (q, k, v, q_off, kv_len)]
    kern = np.asarray(jx.flash(*args, window=window, tq=8, tk=8,
                               interpret=True))
    ref = np.asarray(jx.flash_ref(*args, window=window))
    plain = flash_attention_plain(
        *[torch.from_numpy(x) for x in (q, k, v, q_off, kv_len)],
        window=window).numpy()
    np.testing.assert_allclose(plain, kern, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(plain, ref, rtol=RTOL, atol=ATOL)
    assert (plain[4] == 0).all()


def test_wrappers_take_plain_route_on_cpu():
    """On a CPU tensor each wrapper runs its plain version and launches
    nothing; an unsupported device raises instead of falling back."""
    rng = np.random.RandomState(0)
    before = dict(launch_counts)
    log_s, log_q = (torch.from_numpy(x) for x in _race_inputs(2, 3, 50, 0))
    for a, b_ in zip(gls_row_race(log_s, log_q),
                     gls_row_race_plain(log_s, log_q)):
        assert torch.equal(a, b_)
    q, k, v = (torch.from_numpy(x) for x in _attn_inputs(rng, 2, 6, 2, 4,
                                                          9, 16))
    kvl = torch.tensor([9, 3], dtype=torch.int32)
    off = torch.tensor([0, 2], dtype=torch.int32)
    assert torch.equal(decode_attention(q[:, :, 0], k, v, kvl),
                       decode_attention_plain(q[:, :, 0], k, v, kvl))
    assert torch.equal(flash_attention(q, k, v, off, kvl),
                       flash_attention_plain(q, k, v, off, kvl))
    assert dict(launch_counts) == before
    assert not use_kernel(log_s)
    with pytest.raises(RuntimeError):
        use_kernel(torch.empty(1, device="meta"))


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain version
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_row_race_kernel_bit_exact_on_card(cuda):
    for b, k, n in ((20, 8, 49152), (3, 4, 301)):
        log_s, log_q = (torch.from_numpy(x).to(cuda)
                        for x in _race_inputs(b, k, n, seed=n))
        km, ka = gls_row_race(log_s, log_q)
        pm, pa = gls_row_race_plain(log_s, log_q)
        assert torch.equal(ka, pa) and torch.equal(km, pm)


@pytest.mark.cuda
def test_decode_kernel_matches_plain_on_card(cuda):
    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(x).to(cuda)
               for x in _attn_inputs(rng, 32, 15, 5, 1, 370, 64))
    kvl = torch.from_numpy(rng.randint(0, 371, 32).astype(np.int32)).to(cuda)
    out = decode_attention(q[:, :, 0], k, v, kvl)
    ref = decode_attention_plain(q[:, :, 0], k, v, kvl)
    assert float((out - ref).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_flash_kernel_matches_plain_on_card(cuda):
    rng = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(x).to(cuda)
               for x in _attn_inputs(rng, 8, 15, 5, 64, 200, 64))
    off = torch.from_numpy(rng.randint(0, 150, 8).astype(np.int32)).to(cuda)
    kvl = off + 64
    kvl[0] = 0
    for window in (0, 33):
        out = flash_attention(q, k, v, off, kvl, window=window)
        ref = flash_attention_plain(q, k, v, off, kvl, window=window)
        assert float((out - ref).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_attention_kernels_reject_uncompiled_head_dim(cuda):
    """Only the served head dim (64) is compiled; another raises on the
    card instead of running, and so does a wrong dtype -- a failed
    check raises RuntimeError, it does not crash the process."""
    rng = np.random.RandomState(3)
    q, k, v = (torch.from_numpy(x).to(cuda)
               for x in _attn_inputs(rng, 2, 6, 2, 4, 9, 16))
    kvl = torch.tensor([9, 3], dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="head dim 16"):
        decode_attention(q[:, :, 0].contiguous(), k, v, kvl)
    with pytest.raises(RuntimeError, match="head dim 16"):
        flash_attention(q, k, v, torch.zeros_like(kvl), kvl)
    with pytest.raises(RuntimeError, match="q has dtype Double"):
        flash_attention(q.double(), k, v, torch.zeros_like(kvl), kvl)
