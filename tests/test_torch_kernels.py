"""The port's kernels on the CPU: each plain PyTorch version against the
JAX Pallas kernel run in interpret mode (its body on the CPU) and
against the JAX reference, on the same numpy inputs.  The CUDA kernels
themselves run only on the card: their kernel-vs-plain tests carry the
``cuda`` marker and skip here.

Tolerances: the three races (row, binned, joint) are bit-exact (min/
argmin reductions over the same floats); attention is allclose at rtol
1e-5 / atol 1e-6, because the Pallas kernel's online softmax sums in
another float32 order than one dense softmax.

The JAX side is imported inside the CPU tests, so the ``cuda`` tests run
on a machine with the card and no JAX:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels.py``."""

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention.ops import (INT8_TILE_KEYS,
                                                      decode_attention,
                                                      decode_split_plan,
                                                      resident_blocks_per_sm)
from repro_torch.kernels.decode_attention.ref import decode_attention_plain
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_plain
from repro_torch.kernels.gls_race.ops import (gls_binned_race, gls_race,
                                              gls_row_race,
                                              joint_race_split_plan,
                                              row_race_split_plan)
from repro_torch.kernels.gls_race.ref import (gls_binned_race_plain,
                                              gls_race_plain,
                                              gls_row_race_plain)
from repro_torch.kernels.mode import MAX_CLUSTER, launch_counts, use_kernel

# One intra-op thread: the suite runs under several pytest-xdist workers
# on a few cores, where torch's default of a thread a core makes the
# workers contend over tensors of a few kilobytes.
torch.set_num_threads(1)

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
    from repro.kernels.gls_race.kernel import (gls_binned_race, gls_race,
                                               gls_row_race)
    from repro.kernels.gls_race.ref import (gls_binned_race_ref, gls_race_ref,
                                            gls_row_race_ref)
    return types.SimpleNamespace(
        jnp=jnp, decode=decode_attention, decode_ref=decode_attention_ref,
        flash=flash_attention, flash_ref=flash_attention_ref,
        row_race=gls_row_race, row_race_ref=gls_row_race_ref,
        binned=gls_binned_race, binned_ref=gls_binned_race_ref,
        joint=gls_race, joint_ref=gls_race_ref)


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


def _binned_inputs(b, k, n, l_max, seed):
    """Race tables with dead atoms, +inf garbage weights, exact ties, an
    empty bin, an all-dead row, a -0.0 minimum tied with a later +0.0,
    and a bin id outside [0, l_max) (an atom of no bin)."""
    rng = np.random.RandomState(seed)
    log_s = np.log(rng.exponential(size=(b, k, n))).astype(np.float32)
    log_q = rng.randn(b, k, n).astype(np.float32)
    log_q[rng.uniform(size=(b, k, n)) < 0.2] = -np.inf
    log_q[rng.uniform(size=(b, k, n)) < 0.02] = np.inf
    bins = rng.randint(0, l_max, (b, n)).astype(np.int32)
    # Exact ties in one bin of row (0, 0): the lower atom index wins.
    i, j = n // 5, n // 3
    bins[0, [i, j]] = 0
    log_s[0, 0, [i, j]] = -30.0
    log_q[0, 0, [i, j]] = 0.0
    # A +inf weight with the smallest score of its row stays dead.
    log_s[0, -1, n // 2] = -100.0
    log_q[0, -1, n // 2] = np.inf
    if l_max > 1:
        bins[-1][bins[-1] == l_max - 1] = 0          # an empty bin
        bins[-1, 1] = l_max                          # an atom of no bin
    log_q[-1, -1] = -np.inf                          # an all-dead row
    if b > 1:
        # -0.0 at a lower index than +0.0, both the minimum of bin 0.
        in0 = np.flatnonzero(bins[1] == 0)
        log_s[1, 0, in0] = 5.0
        log_q[1, 0, in0] = 0.0
        log_s[1, 0, in0[:2]] = (-0.0, 0.0)
    return log_s, log_q, bins


@pytest.mark.parametrize("b,k,n,l_max", [(1, 1, 128, 1), (3, 5, 500, 2),
                                         (4, 3, 1000, 8), (2, 5, 777, 64)])
def test_binned_race_plain_bit_exact(jx, b, k, n, l_max):
    """Plain binned race == JAX ref bit for bit (minima compared as int32
    patterns), and == the JAX interpret kernel in value and index.  The
    two JAX versions differ in one bit: at a -0.0 minimum tied with a
    later +0.0 the reference gathers the winning atom's -0.0 while the
    Pallas body's ``min`` reports +0.0.  The port follows the
    reference."""
    log_s, log_q, bins = _binned_inputs(b, k, n, l_max, seed=n + l_max)
    pm, pa = gls_binned_race_plain(torch.from_numpy(log_s),
                                   torch.from_numpy(log_q),
                                   torch.from_numpy(bins), l_max=l_max)
    args = [jx.jnp.asarray(x) for x in (log_s, log_q, bins)]
    km, ka = jx.binned(*args, l_max=l_max, interpret=True)
    rm, ra = jx.binned_ref(*args, l_max=l_max)
    np.testing.assert_array_equal(np.asarray(rm).view(np.int32),
                                  pm.numpy().view(np.int32))
    np.testing.assert_array_equal(np.asarray(km), pm.numpy())
    for a in (ka, ra):
        np.testing.assert_array_equal(np.asarray(a), pa.numpy())
    assert pa.dtype == torch.int32 and pm.shape == (b, k, l_max)
    if b * k > 1:
        assert int(pa[0, 0, 0]) == n // 5              # lower index wins
    assert (pm[-1, -1] == np.inf).all() and (pa[-1, -1] == 0).all()
    if l_max > 1:
        assert (pm[-1, :, -1] == np.inf).all() and (pa[-1, :, -1] == 0).all()
    if b > 1:
        assert float(pm[1, 0, 0]) == 0.0 and np.signbit(float(pm[1, 0, 0]))


def _joint_inputs(b, k, n, seed, plant_posinf=True):
    rng = np.random.RandomState(seed)
    u = rng.uniform(1e-6, 1.0, (b, k, n)).astype(np.float32)
    log_s = np.log(-np.log(u)).astype(np.float32)
    log_p = np.log(rng.dirichlet(np.ones(n), (b, k))).astype(np.float32)
    log_q = np.log(rng.dirichlet(np.ones(n), (b, k))).astype(np.float32)
    log_p[rng.uniform(size=(b, k, n)) < 0.3] = -np.inf
    log_q[rng.uniform(size=(b, k, n)) < 0.3] = -np.inf
    active = rng.uniform(size=(b, k)) < 0.7
    active[:, 0] = True
    # Exact ties: draft (0, 0) and the target of row 0 (across drafts).
    i, j = n // 3, n // 5
    log_s[0, :, [i, j]] = -40.0
    log_p[0, 0, [i, j]] = 0.0
    log_q[0, 0, j] = 0.0
    log_q[0, -1, i] = 0.0
    active[0, -1] = True
    if plant_posinf:
        log_s[-1, 0, 7] = -100.0
        log_p[-1, 0, 7] = np.inf
        log_q[-1, 0, 7] = np.inf
    if b > 1:
        log_p[1, -1] = -np.inf        # an all-dead draft row
        active[2 % b] = False         # a row with no active draft
    return log_s, log_p, log_q, active


@pytest.mark.parametrize("b,k,n", [(1, 1, 128), (3, 4, 300), (5, 8, 1000)])
def test_joint_race_plain_bit_exact(jx, b, k, n):
    """Plain joint race == JAX ref on every input (ties, dead rows, no
    active draft, +inf weights), and == the interpret kernel where no
    weight is +inf: the Pallas body masks ``> -inf`` and would let a +inf
    weight win, the reference (and the port) mask ``isfinite``."""
    for posinf in (True, False):
        log_s, log_p, log_q, active = _joint_inputs(b, k, n, n, posinf)
        px, py = gls_race_plain(*[torch.from_numpy(x) for x in
                                  (log_s, log_p, log_q, active)])
        args = [jx.jnp.asarray(x) for x in (log_s, log_p, log_q, active)]
        outs = [jx.joint_ref(*args)]
        if not posinf:
            outs.append(jx.joint(*args, tile_n=128, interpret=True))
        for x, y in outs:
            np.testing.assert_array_equal(np.asarray(x), px.numpy())
            np.testing.assert_array_equal(np.asarray(y), py.numpy())
        assert px.dtype == py.dtype == torch.int32
        assert int(px[0, 0]) == n // 5 and int(py[0]) == n // 5
        if b > 1:
            assert int(px[1, -1]) == 0 and int(py[2 % b]) == 0
        if posinf:
            assert int(px[-1, 0]) != 7


def _attn_inputs(rng, b, h, hkv, s, t, d):
    q = rng.randn(b, h, s, d).astype(np.float32)
    k = rng.randn(b, hkv, t, d).astype(np.float32)
    v = rng.randn(b, hkv, t, d).astype(np.float32)
    return q, k, v


# (head dim, query heads over 2 KV heads): G = 3 as smollm-360m, G = 4 as
# granite-8b, at head dims 16 and 128 (granite's).
ATTN_DIMS = [(16, 6), (16, 8), (128, 6), (128, 8)]


@pytest.mark.parametrize("d,h", ATTN_DIMS)
@pytest.mark.parametrize("t", [40, 130])
def test_decode_plain_matches_interpret_kernel(jx, t, d, h):
    """G = 3 and 4 grouped heads, ragged kv_len and a kv_len = 0 row: the
    plain version follows the Pallas kernel's contract (zeros on a fully
    masked row), compared with the interpret kernel on every row and
    with ``decode_attention_ref`` (plain softmax, NaN at kv_len = 0) on
    the rows with a live key."""
    rng = np.random.RandomState(t)
    q, k, v = _attn_inputs(rng, 5, h, 2, 1, t, d)
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


@pytest.mark.parametrize("g", [48, 16])
@pytest.mark.parametrize("t", [40, 130])
def test_decode_int8_plain_matches_interpret_kernel_at_giant_groups(jx, t,
                                                                    g):
    """The int8 branch at the giants' groups (granite-34b's 48 and
    llama3-405b's 16 query heads over one KV head, D = 128): int8 K/V with
    per-vector scales, ragged kv_len and a kv_len = 0 row; the plain
    version against the Pallas kernel in interpret mode with scales on
    every row, and against ``decode_attention_ref`` on the rows with a
    live key."""
    rng = np.random.RandomState(t + g)
    b, hkv, d = 4, 1, 128
    q = rng.randn(b, g, d).astype(np.float32)
    k, v, ks, vs = (x.numpy() for x in _int8_kv(rng, b, hkv, t, d, "cpu"))
    kv_len = np.array([0, 1, t // 3, t], np.int32)
    plain = decode_attention_plain(
        *[torch.from_numpy(x) for x in (q, k, v, kv_len, ks, vs)]).numpy()
    args = [jx.jnp.asarray(x) for x in (q, k, v, kv_len, ks, vs)]
    kern = np.asarray(jx.decode(*args, tk=32, interpret=True))
    ref = np.asarray(jx.decode_ref(*args))
    np.testing.assert_allclose(plain, kern, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(plain[1:], ref[1:], rtol=RTOL, atol=ATOL)
    assert (plain[0] == 0).all() and (kern[0] == 0).all()


@pytest.mark.parametrize("d,h", ATTN_DIMS)
@pytest.mark.parametrize("window,causal", [(0, True), (7, True), (0, False)],
                         ids=["0", "7", "0-noncausal"])
def test_flash_plain_matches_interpret_kernel(jx, window, causal, d, h):
    """Per-row q_offset/kv_len arena masks, a bucket-padded row (queries
    past kv_len), a row whose chunk runs past T, and a fully masked row
    (kv_len = 0) -- against the interpret kernel and the reference, at
    G = 3 and 4, causal and not (JAX's static ``causal``)."""
    rng = np.random.RandomState(11 + window)
    b, hkv, s, t = 5, 2, 16, 40
    q, k, v = _attn_inputs(rng, b, h, hkv, s, t, d)
    q_off = np.array([0, 8, 3, 30, 0], np.int32)
    kv_len = np.array([16, 24, 10, 46, 0], np.int32)   # row 2: padded tail
    args = [jx.jnp.asarray(x) for x in (q, k, v, q_off, kv_len)]
    kern = np.asarray(jx.flash(*args, causal=causal, window=window, tq=8,
                               tk=8, interpret=True))
    ref = np.asarray(jx.flash_ref(*args, causal=causal, window=window))
    plain = flash_attention_plain(
        *[torch.from_numpy(x) for x in (q, k, v, q_off, kv_len)],
        causal=causal, window=window).numpy()
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
    ins = [torch.from_numpy(x) for x in _binned_inputs(2, 3, 50, 4, 0)]
    for a, b_ in zip(gls_binned_race(*ins, l_max=4),
                     gls_binned_race_plain(*ins, l_max=4)):
        assert torch.equal(a, b_)
    ins = [torch.from_numpy(x) for x in _joint_inputs(3, 2, 50, 0)]
    for a, b_ in zip(gls_race(*ins), gls_race_plain(*ins)):
        assert torch.equal(a, b_)
    assert dict(launch_counts) == before
    assert not use_kernel(log_s)
    with pytest.raises(RuntimeError):
        use_kernel(torch.empty(1, device="meta"))


def _ranges(splits, chunk, n):
    """Block i's [start, end) of n items under a split plan."""
    return [(min(i * chunk, n), min((i + 1) * chunk, n))
            for i in range(splits)]


def _assert_partition(splits, chunk, n):
    """Every item lands in exactly one block's range, in order; at most a
    portable cluster of blocks; ranges may be empty."""
    assert 1 <= splits <= MAX_CLUSTER and chunk >= 1
    covered = []
    for start, end in _ranges(splits, chunk, n):
        covered.extend(range(start, end))
    assert covered == list(range(n))


@pytest.mark.parametrize("b,hkv,t", [
    (32, 5, 370), (32, 5, 1), (32, 5, 63), (32, 5, 64), (32, 5, 65),
    (64, 5, 370), (2, 2, 0), (1, 1, 4096), (8, 1, 129), (27, 5, 300),
    (33, 4, 17)])
def test_decode_split_plan_partitions_keys(b, hkv, t):
    """The decode kernel's plan (``ops.decode_split_plan``, passed to the
    binding): the (row, KV head) clusters' key ranges partition [0, T);
    at the serve shape it gives 2 splits (320 blocks, one wave), and a
    grid too large for one wave takes no split."""
    splits, chunk = decode_split_plan(b, hkv, t)
    _assert_partition(splits, chunk, t)
    assert chunk == max(1, -(-t // splits))
    if (b, hkv, t) == (32, 5, 370):
        assert (splits, chunk) == (2, 185)
    if (b, hkv, t) == (64, 5, 370):
        assert splits == 1
    if t <= 16:
        assert splits == 1


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("b,hkv,t", [
    (32, 5, 370), (32, 8, 370), (16, 2, 370), (40, 5, 370), (5, 1, 257),
    (2, 2, 0), (1, 1, 4096), (32, 5, 1), (64, 8, 370), (8, 1, 129),
    (4, 2, 1000)])
def test_decode_int8_split_plan_partitions_keys(b, hkv, t, d):
    """The int8 instance's plan at both head dims: the clusters' key
    ranges partition [0, T) in at most a portable cluster; the grid is
    resident (its own 32 KB tiles and scales counted per SM); the fewest
    splits whose grid covers the 132 SMs, or the most resident where none
    does; one split at both serve shapes (smollm-360m's 32 x 5 rows at
    D = 64, granite-8b's 32 x 8 at D = 128)."""
    splits, chunk = decode_split_plan(b, hkv, t, head_dim=d, int8=True)
    _assert_partition(splits, chunk, t)
    assert chunk == max(1, -(-t // splits))
    rows, sms = max(1, b * hkv), 132
    resident = [s for s in range(1, MAX_CLUSTER + 1)
                if s <= max(1, -(-t // 16))
                and rows * s <= sms * resident_blocks_per_sm(-(-t // s), d,
                                                            True)]
    assert splits in resident or splits == 1
    if rows * splits >= sms:
        assert splits == 1 or rows * (splits - 1) < sms
    else:
        assert splits == max(resident, default=1)
    if (b, hkv, t) in ((32, 5, 370), (32, 8, 370)):
        assert (splits, chunk) == (1, 370)
    assert INT8_TILE_KEYS[d] * 2 * d == 32768


@pytest.mark.parametrize("b,k,n", [
    (20, 8, 49152), (5, 8, 50280), (3, 4, 301), (1, 1, 128), (20, 4, 49152),
    (2, 2, 9000), (2, 20, 1000), (1, 1, 100000), (4, 16, 4099),
    (1, 3, 20000)])
def test_joint_race_split_plan_covers_each_element_once(b, k, n):
    """The joint race's plan: the blocks of a row's cluster (at most a
    portable cluster, the fewest drafts a block that fit one) take every
    (draft, vocab) element exactly once, each block its drafts' whole
    rows; at the serving race shape (20, 8, 49152) one draft a block, at
    least 132 blocks."""
    kc = joint_race_split_plan(k)
    blocks = -(-k // kc)
    assert 1 <= blocks <= MAX_CLUSTER
    assert kc == 1 or -(-k // (kc - 1)) > MAX_CLUSTER
    seen = np.zeros((k, n), np.int64)
    for r in range(blocks):
        seen[r * kc:min(k, (r + 1) * kc), :] += 1
    assert (seen == 1).all()
    if (b, k, n) == (20, 8, 49152):
        assert kc == 1 and b * blocks >= 132


@pytest.mark.parametrize("rows,n", [
    (40, 50280), (160, 49152), (3, 301), (1, 1), (12, 4), (40, 50281),
    (1, 2 ** 20), (200, 777), (7, 16387)])
def test_row_race_split_plan_partitions_elements(rows, n):
    """The row race's plan: element ranges partition [0, N), every
    boundary a multiple of 4 (the float4 path holds in each block), and
    40 rows of the reprefill verifier get 8 splits (320 blocks)."""
    splits, chunk = row_race_split_plan(rows, n)
    _assert_partition(splits, chunk, n)
    assert chunk % 4 == 0
    assert all(start % 4 == 0 for start, _ in _ranges(splits, chunk, n))
    if (rows, n) == (40, 50280):
        assert splits == 8
    if (rows, n) == (160, 49152):
        assert splits * rows >= 2 * 132


def test_split_plan_allows_empty_ranges():
    """Ranges past the end are empty: a block there loads nothing and
    leaves the neutral partial."""
    splits, chunk = 8, 2
    assert _ranges(splits, chunk, 10)[5:] == [(10, 10)] * 3
    _assert_partition(splits, chunk, 10)
    s, c = row_race_split_plan(1, 20000)
    assert s == 8 and (s - 1) * c < 20000


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


def _plant_split_edges(log_s, log_q, chunk):
    """At the plan's first boundary: an exact tie across two splits (row
    (0, 1): the lower index must win), and a unique minimum on a split's
    first element (row (0, 2))."""
    n = log_s.shape[-1]
    if chunk < n:
        log_s[0, 1, [chunk - 1, chunk]] = -50.0
        log_q[0, 1, [chunk - 1, chunk]] = 0.0
        log_s[0, 2, chunk] = -50.0
        log_q[0, 2, chunk] = 0.0


# (b, k, n): the two serve shapes and N around the plan's edges; an odd
# N takes the scalar path.
ROW_RACE_SPLIT_CASES = [(5, 8, 50280), (20, 8, 49152), (5, 8, 50281),
                        (5, 8, 16388), (5, 3, 2049), (1, 3, 8192)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,n", ROW_RACE_SPLIT_CASES)
def test_row_race_kernel_bit_exact_at_split_edges_on_card(cuda, b, k, n):
    """Bitwise equal to plain at the cluster split's edges, including a
    tie across two splits and a misaligned view (an odd offset: the
    scalar path)."""
    log_s, log_q = (torch.from_numpy(x).to(cuda)
                    for x in _race_inputs(b, k, n, seed=n))
    _, chunk = row_race_split_plan(b * k, n)
    _plant_split_edges(log_s, log_q, chunk)
    km, ka = gls_row_race(log_s, log_q)
    pm, pa = gls_row_race_plain(log_s, log_q)
    assert torch.equal(ka, pa)
    assert torch.equal(km.view(torch.int32), pm.view(torch.int32))
    if chunk < n:
        assert int(ka[0, 1]) == chunk - 1 and int(ka[0, 2]) == chunk
    flat_s = torch.cat([torch.zeros(1, device=cuda), log_s.flatten()])
    flat_q = torch.cat([torch.zeros(1, device=cuda), log_q.flatten()])
    mis_s, mis_q = flat_s[1:].view(b, k, n), flat_q[1:].view(b, k, n)
    assert mis_s.data_ptr() % 16 != 0
    mm, ma = gls_row_race(mis_s, mis_q)
    assert torch.equal(ma, pa)
    assert torch.equal(mm.view(torch.int32), pm.view(torch.int32))


@pytest.mark.cuda
def test_decode_kernel_matches_plain_on_card(cuda):
    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(x).to(cuda)
               for x in _attn_inputs(rng, 32, 15, 5, 1, 370, 64))
    kvl = torch.from_numpy(rng.randint(0, 371, 32).astype(np.int32)).to(cuda)
    out = decode_attention(q[:, :, 0], k, v, kvl)
    ref = decode_attention_plain(q[:, :, 0], k, v, kvl)
    assert float((out - ref).abs().max()) <= 1e-4


# (b, hkv): B x Hkv below and above the card's 132 SMs.
DECODE_ROWS = [(16, 2), (40, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 2, 3])
@pytest.mark.parametrize("t", [1, 63, 64, 65, 370])
@pytest.mark.parametrize("b,hkv", DECODE_ROWS)
def test_decode_kernel_at_split_edges_on_card(cuda, g, t, b, hkv):
    """Within 1e-4 of plain with kv_len on the plan's split and tile edges
    (0, 1, a split boundary and one key either side, 64 and 65, T - 1,
    T); a kv_len == 0 row is exactly zero."""
    rng = np.random.RandomState(t + g)
    q, k, v = (torch.from_numpy(x).to(cuda)
               for x in _attn_inputs(rng, b, g * hkv, hkv, 1, t, 64))
    splits, chunk = decode_split_plan(b, hkv, t)
    edges = [0, 1, chunk, chunk - 1, chunk + 1, (splits - 1) * chunk, 64,
             65, t - 1, t]
    kvl = np.array([min(max(e, 0), t) for e in edges] * b, np.int32)[:b]
    kvl = torch.from_numpy(kvl).to(cuda)
    out = decode_attention(q[:, :, 0], k, v, kvl)
    ref = decode_attention_plain(q[:, :, 0], k, v, kvl)
    assert float((out - ref).abs().max()) <= 1e-4
    assert bool((out[kvl == 0] == 0).all())


# Edges of the D = 64 kernels' tiles: the float32 instance's (64 query
# rows per warp group, 64-key KV tiles, up to 3 query heads of one KV head
# per block) and the int8 instance's on the tensor cores (64-row q tiles
# of 16 rows a warp, two a block: two query heads of a KV head, or two q
# tiles of one head for an odd group; 64-key tiles): (b, h, hkv, s, t,
# q_offset, kv_len, windows).  None draws the offsets as the arena does.
FLASH_CARD_CASES = {
    "arena": (8, 15, 5, 64, 200, None, None, (0, 33)),
    "rows_not_tile_multiple": (3, 15, 5, 100, 256, [0, 0, 100],
                               [100, 70, 200], (0,)),
    "keys_not_tile_multiple": (2, 6, 2, 64, 130, [0, 66], [64, 130], (0,)),
    "kv_len_zero_row": (3, 6, 2, 80, 150, [0, 10, 0], [80, 0, 150], (0,)),
    "chunk_past_t": (2, 15, 5, 128, 150, [100, 0], [228, 128], (0,)),
    "window": (2, 6, 2, 200, 300, [0, 90], [200, 290], (1, 5, 70)),
    "one_head_per_kv_head": (2, 4, 4, 96, 160, [0, 40], [96, 136], (0, 9)),
    "two_heads_per_kv_head": (2, 4, 2, 96, 160, [0, 40], [96, 136], (0,)),
    # The tensor-core design's own edges: the 4 warps of a 64-row q tile
    # stop at causal limits 16 apart, off the 16-row grid at offset 5;
    # kv_len one short of, on and one past one and two 64-key tiles (two
    # and four 32-key ones); S not a multiple of a warp's 16 rows;
    # q_offset > 0 with kv_len > T; G = 3 (smollm-360m) as two q tiles of
    # one head, the last block's second tile past S.
    "warps_stop_apart": (2, 8, 2, 100, 200, [0, 5], [100, 105], (0, 9)),
    "keys_32_tile_edges": (6, 8, 2, 40, 130, [100] * 6,
                           [63, 64, 65, 127, 128, 129], (0,)),
    "rows_not_16_multiple": (2, 8, 2, 37, 100, [0, 20], [37, 57], (0,)),
    "offset_kv_len_past_t": (2, 8, 2, 48, 90, [60, 30], [108, 78], (0,)),
    "odd_group_q_tiles": (2, 6, 2, 130, 200, [0, 5], [130, 135], (0, 9)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(FLASH_CARD_CASES))
def test_flash_kernel_matches_plain_on_card(cuda, case):
    """Against the plain version within 1e-4 (float32 summation order);
    a row with kv_len == 0 is exactly zero on both routes."""
    b, h, hkv, s, t, off, kvl, windows = FLASH_CARD_CASES[case]
    rng = np.random.RandomState(2)
    q, k, v = (torch.from_numpy(x).to(cuda)
               for x in _attn_inputs(rng, b, h, hkv, s, t, 64))
    if off is None:
        off = rng.randint(0, 150, b)
        kvl = off + s
        kvl[0] = 0
    off, kvl = (torch.tensor(np.asarray(x, np.int32), device=cuda)
                for x in (off, kvl))
    for window in windows:
        out = flash_attention(q, k, v, off, kvl, window=window)
        ref = flash_attention_plain(q, k, v, off, kvl, window=window)
        assert float((out - ref).abs().max()) <= 1e-4, window
        assert bool((out[kvl == 0] == 0).all())


# The D = 128 instances (granite-8b): groups 1, 4 (granite's) and 8 (the
# cap), on split edges and on the 32-key tile's edges.
D128_GROUPS = [1, 4, 8]
D128_KEYS = [1, 31, 32, 33, 64, 65, 370]


def _decode_edges(b, t, splits, chunk):
    edges = [0, 1, chunk, chunk - 1, chunk + 1, (splits - 1) * chunk, 32,
             33, 64, 65, t - 1, t]
    return np.array([min(max(e, 0), t) for e in edges] * b, np.int32)[:b]


@pytest.mark.cuda
@pytest.mark.parametrize("g", D128_GROUPS)
@pytest.mark.parametrize("t", D128_KEYS)
@pytest.mark.parametrize("b,hkv", DECODE_ROWS)
def test_decode_kernel_d128_at_split_edges_on_card(cuda, g, t, b, hkv):
    """The D = 128 instance within 1e-4 of plain with kv_len on its split
    plan's edges and the 32/33/64/65-key tile edges; a kv_len == 0 row is
    exactly zero; only ``decode_attention_d128`` counts the launch."""
    rng = np.random.RandomState(t + g + 200)
    q, k, v = (torch.from_numpy(x).to(cuda)
               for x in _attn_inputs(rng, b, g * hkv, hkv, 1, t, 128))
    splits, chunk = decode_split_plan(b, hkv, t, head_dim=128)
    kvl = torch.from_numpy(_decode_edges(b, t, splits, chunk)).to(cuda)
    before = dict(launch_counts)
    out = decode_attention(q[:, :, 0], k, v, kvl)
    ref = decode_attention_plain(q[:, :, 0], k, v, kvl)
    assert float((out - ref).abs().max()) <= 1e-4
    assert bool((out[kvl == 0] == 0).all())
    assert launch_counts["decode_attention_d128"] == \
        before.get("decode_attention_d128", 0) + 1
    assert launch_counts["decode_attention"] == \
        before.get("decode_attention", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("g", D128_GROUPS)
@pytest.mark.parametrize("t", D128_KEYS)
@pytest.mark.parametrize("b,hkv", DECODE_ROWS)
def test_decode_int8_kernel_d128_at_split_edges_on_card(cuda, g, t, b, hkv):
    """The int8 D = 128 instance (128-byte key rows) within 1e-4 of plain
    on its own split plan's edges; only ``decode_attention_int8_d128``
    counts the launch."""
    rng = np.random.RandomState(t + g + 300)
    q = torch.from_numpy(rng.randn(b, g * hkv, 128).astype(np.float32)).to(
        cuda)
    k8, v8, ks, vs = _int8_kv(rng, b, hkv, t, 128, cuda)
    splits, chunk = decode_split_plan(
        b, hkv, t, head_dim=128, int8=True)
    kvl = torch.from_numpy(_decode_edges(b, t, splits, chunk)).to(cuda)
    before = dict(launch_counts)
    out = decode_attention(q, k8, v8, kvl, ks, vs)
    ref = decode_attention_plain(q, k8, v8, kvl, ks, vs)
    assert float((out - ref).abs().max()) <= 1e-4
    assert bool((out[kvl == 0] == 0).all())
    assert launch_counts["decode_attention_int8_d128"] == \
        before.get("decode_attention_int8_d128", 0) + 1
    assert launch_counts["decode_attention_int8"] == \
        before.get("decode_attention_int8", 0)


# The float32 instance's cases at D = 128, plus granite's group (32 query
# heads over 8 KV heads, the serve buffer) and the cap of 8.
FLASH_D128_CASES = dict(
    FLASH_CARD_CASES,
    granite_group=(2, 32, 8, 100, 370, [0, 256], [100, 356], (0,)),
    group_8=(2, 16, 2, 96, 160, [0, 40], [96, 136], (0, 9)),
    keys_32_33=(3, 8, 2, 64, 65, [0, 1, 0], [32, 65, 33], (0,)))


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("case", sorted(FLASH_D128_CASES))
def test_flash_kernel_d128_matches_plain_on_card(cuda, case, int8):
    """The D = 128 instances (float32 and int8 K/V) within 1e-4 of plain on
    the tile-edge cases (32-key tiles, up to two query heads per block);
    a row with kv_len == 0 is exactly zero; each counts under its own
    name."""
    b, h, hkv, s, t, off, kvl, windows = FLASH_D128_CASES[case]
    rng = np.random.RandomState(8)
    q = torch.from_numpy(rng.randn(b, h, s, 128).astype(np.float32)).to(
        cuda)
    if int8:
        kv = _int8_kv(rng, b, hkv, t, 128, cuda)
    else:
        kv = tuple(torch.from_numpy(rng.randn(b, hkv, t, 128).astype(
            np.float32)).to(cuda) for _ in range(2)) + (None, None)
    if off is None:
        off = rng.randint(0, 150, b)
        kvl = off + s
        kvl[0] = 0
    off, kvl = (torch.tensor(np.asarray(x, np.int32), device=cuda)
                for x in (off, kvl))
    name = "flash_attention_int8_d128" if int8 else "flash_attention_d128"
    before = launch_counts[name]
    for window in windows:
        out = flash_attention(q, kv[0], kv[1], off, kvl, kv[2], kv[3],
                              window=window)
        ref = flash_attention_plain(q, kv[0], kv[1], off, kvl, kv[2], kv[3],
                                    window=window)
        assert float((out - ref).abs().max()) <= 1e-4, window
        assert bool((out[kvl == 0] == 0).all())
    assert launch_counts[name] == before + len(windows)


def _tf32(x, rounded=True):
    """x (float32) as a TF32 operand: rounded as ``cvt.rna.tf32.f32`` does,
    to the nearest value with 10 explicit mantissa bits, ties away from
    zero (add half a TF32 ulp to the magnitude, clear the 13 low bits); or
    truncated (the 13 low bits cleared)."""
    bits = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    return (((bits + 0x1000) if rounded else bits) & 0xFFFFE000).astype(
        np.uint32).view(np.float32).astype(np.float64)


def _split_products(a, b, n):
    """a @ b from TF32 operands as the tensor-core flash kernel forms it:
    n = 3 (float32 operands: a_lo b_hi + a_hi b_lo + a_hi b_hi), 2 (b exact
    in TF32, the int8 K/V: a_lo b + a_hi b) or 1 (one TF32 product).  hi is
    x rounded to TF32; lo = x - hi goes to the tensor cores unrounded,
    emulated as truncated to TF32 (the coarser of what they may make of
    its low bits).  The products of TF32 values are exact in float64 and
    summed there; n = 0 is the float64 product itself."""
    if n == 0:
        return a @ b
    a_hi = _tf32(a)
    a_lo = _tf32(np.float32(a) - np.float32(a_hi), rounded=False)
    b_hi = _tf32(b)
    b_lo = _tf32(np.float32(b) - np.float32(b_hi), rounded=False)
    if n == 1:
        return a_hi @ b_hi
    if n == 2:
        assert (b_lo == 0).all()
        return a_lo @ b_hi + a_hi @ b_hi
    return a_lo @ b_hi + a_hi @ b_lo + a_hi @ b_hi


def _split_attention(q, k, v, ks, vs, mask, n):
    """One head group's attention with Q K^T and P V as ``_split_products``
    of ``n`` products: q (G, S, D) f32 pre-scaled by 1/sqrt(D), k/v (T, D)
    (int8 values as float, with scales ks/vs (T, 1): s = ks (q . k8),
    o += (p vs) . v8), mask (S, T); the softmax in float64 with the
    masked-row contract, P rounded to float32 as the kernel holds it (n =
    0: all in float64)."""
    g, s, d = q.shape
    scores = _split_products(q.reshape(g * s, d), k.T, n).reshape(g, s, -1)
    if ks is not None:
        scores = scores * ks[:, 0]
    neg = np.where(mask, scores, -np.inf)
    m = neg.max(-1, keepdims=True)
    p = np.where(mask, np.exp(neg - np.where(np.isfinite(m), m, 0.0)), 0.0)
    denom = np.maximum(p.sum(-1, keepdims=True), 1e-30)
    if n:
        p = p.astype(np.float32)
    if vs is not None:
        p = p * vs[:, 0]
    out = _split_products(p.reshape(g * s, -1), v, n).reshape(g, s, d)
    return out / denom


@pytest.mark.parametrize("int8,d,g", [(False, 128, 4), (True, 128, 4),
                                      (True, 64, 3)],
                         ids=["False", "True", "int8-d64-g3"])
def test_tf32_split_attention_holds_float32_accuracy(int8, d, g):
    """The arithmetic of the tensor-core flash kernel (3xTF32 for float32
    K/V, 2 products for int8 K/V, whose values are exact in TF32),
    emulated in numpy on a small granite-shaped head group (D = 128, G =
    4) and a smollm-shaped int8 one (D = 64, G = 3), each with a fully
    masked row: within 1e-5 of float64 attention and of
    ``flash_attention_plain``.  The split's dropped and truncated terms
    are below 2^-20 of each product (~3e-7 on these outputs) and the
    plain version's float32 sums err ~1e-6, so 1e-5 holds both with a
    margin.
    One TF32 product (11 significant bits) misses 1e-4: why the kernel
    splits."""
    rng = np.random.RandomState(20)
    b, hkv, s, t = 3, 1, 24, 40
    q = rng.randn(b, hkv * g, s, d).astype(np.float32)
    q_off = np.array([0, 10, 0], np.int32)
    kv_len = np.array([24, 34, 0], np.int32)            # row 2: all masked
    if int8:
        from repro_torch.serving.quant import quantize_kv
        (k, ks), (v, vs) = (quantize_kv(torch.from_numpy(
            rng.randn(b, hkv, t, d).astype(np.float32))) for _ in range(2))
        k, v, ks, vs = k.numpy(), v.numpy(), ks.numpy(), vs.numpy()
        kf, vf = k.astype(np.float32), v.astype(np.float32)
        k64 = kf.astype(np.float64) * ks.astype(np.float64)
        v64 = vf.astype(np.float64) * vs.astype(np.float64)
    else:
        k, v = (rng.randn(b, hkv, t, d).astype(np.float32) for _ in range(2))
        kf, vf, ks, vs = k, v, None, None
        k64, v64 = k.astype(np.float64), v.astype(np.float64)
    qs = q * np.float32(1 / np.sqrt(d))
    pos = q_off[:, None, None] + np.arange(s)[None, :, None]
    mask = (np.arange(t)[None, None, :] <= pos) & (
        np.arange(t)[None, None, :] < kv_len[:, None, None])
    plain = flash_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(q_off), torch.from_numpy(kv_len),
        None if ks is None else torch.from_numpy(ks),
        None if vs is None else torch.from_numpy(vs)).double().numpy()
    outs = {}
    for n in (1, 2 if int8 else 3):
        outs[n] = np.stack([np.stack([_split_attention(
            qs[bi, hi * g:(hi + 1) * g], kf[bi, hi], vf[bi, hi],
            None if ks is None else ks[bi, hi],
            None if vs is None else vs[bi, hi], mask[bi], n)
            for hi in range(hkv)]).reshape(hkv * g, s, d) for bi in range(b)])
    exact = np.stack([np.stack([_split_attention(
        q[bi, hi * g:(hi + 1) * g].astype(np.float64) / np.sqrt(d),
        k64[bi, hi], v64[bi, hi], None, None, mask[bi], 0)
        for hi in range(hkv)]).reshape(hkv * g, s, d) for bi in range(b)])
    split = outs[2 if int8 else 3]
    assert np.abs(split - exact).max() <= 1e-5
    assert np.abs(split - plain).max() <= 1e-5
    assert (split[2] == 0).all() and (plain[2] == 0).all()
    assert np.abs(outs[1] - exact).max() > 1e-4


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("g", [48, 16])
def test_tf32_split_group_decode_holds_float32_accuracy(g, int8):
    """The arithmetic of the decode's group instance at the giants'
    groups (one query a head, granite-34b's 48 and llama3-405b's 16 query
    heads over one KV head, D = 128), emulated in numpy on three rows, the
    last fully masked: 3 TF32 products a product for float32 K/V, 2 for
    int8 K/V (exact in TF32) with the per-key scales (the K scale on the
    score, the V scale on the weight).  Within 1e-5 of float64 attention
    (of the dequantized K/V) and of ``decode_attention_plain``, as the
    flash kernel's split (``test_tf32_split_attention_holds_float32_
    accuracy``); one TF32 product misses 1e-4."""
    rng = np.random.RandomState(30 + g)
    b, d, t = 3, 128, 40
    q = rng.randn(b, g, d).astype(np.float32)
    kv_len = np.array([40, 17, 0], np.int32)
    if int8:
        k, v, ks, vs = (x.numpy() for x in _int8_kv(rng, b, 1, t, d, "cpu"))
        kf, vf = k.astype(np.float32), v.astype(np.float32)
        k64 = kf.astype(np.float64) * ks.astype(np.float64)
        v64 = vf.astype(np.float64) * vs.astype(np.float64)
    else:
        k, v = (rng.randn(b, 1, t, d).astype(np.float32) for _ in range(2))
        kf, vf, ks, vs = k, v, None, None
        k64, v64 = k.astype(np.float64), v.astype(np.float64)
    plain = decode_attention_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        torch.from_numpy(kv_len),
        None if ks is None else torch.from_numpy(ks),
        None if vs is None else torch.from_numpy(vs)).double().numpy()
    qs = q * np.float32(1 / np.sqrt(d))
    mask = np.arange(t)[None, None, :] < kv_len[:, None, None]   # (B, 1, T)
    outs = {}
    for n in (1, 2 if int8 else 3):
        outs[n] = np.stack([_split_attention(
            qs[bi][:, None], kf[bi, 0], vf[bi, 0],
            None if ks is None else ks[bi, 0],
            None if vs is None else vs[bi, 0], mask[bi], n)[:, 0]
            for bi in range(b)])
    exact = np.stack([_split_attention(
        q[bi][:, None].astype(np.float64) / np.sqrt(d), k64[bi, 0],
        v64[bi, 0], None, None, mask[bi], 0)[:, 0] for bi in range(b)])
    split = outs[2 if int8 else 3]
    assert np.abs(split - exact).max() <= 1e-5
    assert np.abs(split - plain).max() <= 1e-5
    assert (split[2] == 0).all() and (plain[2] == 0).all()
    assert np.abs(outs[1] - exact).max() > 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
def test_attention_kernels_reject_head_dim_96(cuda, int8):
    """Head dims 64 and 128 are compiled; 96 (a multiple of 32 between
    them) raises on the card for every instance."""
    rng = np.random.RandomState(4)
    q = torch.from_numpy(rng.randn(2, 6, 4, 96).astype(np.float32)).to(cuda)
    if int8:
        k, v, ks, vs = _int8_kv(rng, 2, 2, 9, 96, cuda)
    else:
        k, v = (torch.from_numpy(rng.randn(2, 2, 9, 96).astype(
            np.float32)).to(cuda) for _ in range(2))
        ks = vs = None
    kvl = torch.tensor([9, 3], dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="head dim 96"):
        decode_attention(q[:, :, 0].contiguous(), k, v, kvl, ks, vs)
    with pytest.raises(RuntimeError, match="head dim 96"):
        flash_attention(q, k, v, torch.zeros_like(kvl), kvl, ks, vs)


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


def _int8_kv(rng, b, hkv, t, d, dev):
    """int8 K/V with per-vector scales, quantized as the arenas are (no
    JAX: the card tests run where there is none)."""
    from repro_torch.serving.quant import quantize_kv
    kv = [quantize_kv(torch.from_numpy(rng.randn(b, hkv, t, d).astype(
        np.float32))) for _ in range(2)]
    (k8, ks), (v8, vs) = kv
    return tuple(x.to(dev) for x in (k8, v8, ks, vs))


@pytest.mark.cuda
@pytest.mark.parametrize("g", [1, 3])
@pytest.mark.parametrize("t", [1, 63, 65, 370])
@pytest.mark.parametrize("b,hkv", DECODE_ROWS)
def test_decode_int8_kernel_at_split_edges_on_card(cuda, g, t, b, hkv):
    """The int8 instance within 1e-4 of plain on its own split plan's
    edges (T % 4 != 0 at 63, 65 and 370: scale rows that start 4- or
    8-byte aligned only), at T = 370 the serve shape's rows; a kv_len == 0
    row is exactly zero; only the int8 counter moves."""
    rng = np.random.RandomState(t + g + 100)
    q = torch.from_numpy(rng.randn(b, g * hkv, 64).astype(np.float32)).to(
        cuda)
    k8, v8, ks, vs = _int8_kv(rng, b, hkv, t, 64, cuda)
    splits, chunk = decode_split_plan(b, hkv, t, int8=True)
    edges = [0, 1, chunk, chunk - 1, chunk + 1, (splits - 1) * chunk, 64,
             65, t - 1, t]
    kvl = np.array([min(max(e, 0), t) for e in edges] * b, np.int32)[:b]
    kvl = torch.from_numpy(kvl).to(cuda)
    before = dict(launch_counts)
    out = decode_attention(q, k8, v8, kvl, ks, vs)
    ref = decode_attention_plain(q, k8, v8, kvl, ks, vs)
    assert float((out - ref).abs().max()) <= 1e-4
    assert bool((out[kvl == 0] == 0).all())
    assert launch_counts["decode_attention_int8"] == \
        before.get("decode_attention_int8", 0) + 1
    assert launch_counts["decode_attention"] == \
        before.get("decode_attention", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["arena", "keys_not_tile_multiple",
                                  "kv_len_zero_row", "chunk_past_t",
                                  "window", "two_heads_per_kv_head",
                                  "warps_stop_apart", "keys_32_tile_edges",
                                  "rows_not_16_multiple",
                                  "offset_kv_len_past_t",
                                  "odd_group_q_tiles"])
def test_flash_int8_kernel_matches_plain_on_card(cuda, case):
    """The int8 instance (the tensor-core kernel at D = 64) within 1e-4 of
    plain on the tile-edge cases of both D = 64 designs."""
    b, h, hkv, s, t, off, kvl, windows = FLASH_CARD_CASES[case]
    rng = np.random.RandomState(5)
    q = torch.from_numpy(rng.randn(b, h, s, 64).astype(np.float32)).to(cuda)
    k8, v8, ks, vs = _int8_kv(rng, b, hkv, t, 64, cuda)
    if off is None:
        off = rng.randint(0, 150, b)
        kvl = off + s
        kvl[0] = 0
    off, kvl = (torch.tensor(np.asarray(x, np.int32), device=cuda)
                for x in (off, kvl))
    for window in windows:
        out = flash_attention(q, k8, v8, off, kvl, ks, vs, window=window)
        ref = flash_attention_plain(q, k8, v8, off, kvl, ks, vs,
                                    window=window)
        assert float((out - ref).abs().max()) <= 1e-4, window
        assert bool((out[kvl == 0] == 0).all())


@pytest.mark.cuda
def test_flash_int8_kernel_at_serve_shape_on_card(cuda):
    rng = np.random.RandomState(6)
    q = torch.from_numpy(rng.randn(8, 15, 256, 64).astype(np.float32)).to(
        cuda)
    k8, v8, ks, vs = _int8_kv(rng, 8, 5, 370, 64, cuda)
    off = torch.tensor([0, 0, 0, 0, 256, 256, 100, 114], dtype=torch.int32,
                       device=cuda)
    kvl = off + 256
    out = flash_attention(q, k8, v8, off, kvl, ks, vs)
    ref = flash_attention_plain(q, k8, v8, off, kvl, ks, vs)
    assert float((out - ref).abs().max()) <= 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("d,int8", [(64, False), (64, True), (128, False),
                                    (128, True)])
@pytest.mark.parametrize("case", ["arena", "kv_len_zero_row", "window",
                                  "keys_32_tile_edges",
                                  "offset_kv_len_past_t",
                                  "odd_group_q_tiles"])
def test_flash_kernels_non_causal_match_plain_on_card(cuda, case, d, int8):
    """``causal=False`` (no served path passes it) on each of the four
    instances: within 1e-4 of plain, a kv_len == 0 row exactly zero."""
    b, h, hkv, s, t, off, kvl, windows = FLASH_CARD_CASES[case]
    rng = np.random.RandomState(9)
    q = torch.from_numpy(rng.randn(b, h, s, d).astype(np.float32)).to(cuda)
    if int8:
        kv = _int8_kv(rng, b, hkv, t, d, cuda)
    else:
        kv = tuple(torch.from_numpy(rng.randn(b, hkv, t, d).astype(
            np.float32)).to(cuda) for _ in range(2)) + (None, None)
    if off is None:
        off = rng.randint(0, 150, b)
        kvl = off + s
        kvl[0] = 0
    off, kvl = (torch.tensor(np.asarray(x, np.int32), device=cuda)
                for x in (off, kvl))
    for window in windows:
        out = flash_attention(q, kv[0], kv[1], off, kvl, kv[2], kv[3],
                              causal=False, window=window)
        ref = flash_attention_plain(q, kv[0], kv[1], off, kvl, kv[2], kv[3],
                                    causal=False, window=window)
        assert float((out - ref).abs().max()) <= 1e-4, window
        assert bool((out[kvl == 0] == 0).all())


@pytest.mark.cuda
def test_int8_attention_kernels_reject_bad_inputs(cuda):
    """A float32 scale beside int8 K/V is required: a wrong scale dtype or
    shape, or float32 K/V given scales, raises with one message."""
    rng = np.random.RandomState(7)
    q = torch.from_numpy(rng.randn(2, 6, 64).astype(np.float32)).to(cuda)
    k8, v8, ks, vs = _int8_kv(rng, 2, 2, 9, 64, cuda)
    kvl = torch.tensor([9, 3], dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="k_scale has dtype Double"):
        decode_attention(q, k8, v8, kvl, ks.double(), vs)
    with pytest.raises(RuntimeError, match=r"\(B, Hkv, T, 1\)"):
        decode_attention(q, k8, v8, kvl, ks[:, :, :8].contiguous(),
                         vs[:, :, :8].contiguous())
    with pytest.raises(RuntimeError, match="k has dtype Float"):
        decode_attention(q, k8.float(), v8.float(), kvl, ks, vs)
    q4 = q[:, :, None].expand(2, 6, 5, 64).contiguous()
    off = torch.zeros_like(kvl)
    with pytest.raises(RuntimeError, match="v_scale has dtype Double"):
        flash_attention(q4, k8, v8, off, kvl, ks, vs.double())
    with pytest.raises(RuntimeError, match="k has dtype Float"):
        flash_attention(q4, k8.float(), v8, off, kvl, ks, vs)


# (b, hkv, t): below the SMs (5 splits), above them (1 split), and
# B Hkv T % 4 != 0, whose last keys' scales lie past the 16-byte clip
# of the bulk copies (read from global memory; 8 splits).
INT8_EDGE_ROWS = [(16, 2, 370), (40, 5, 370), (5, 1, 257)]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("g", list(range(1, 9)))
@pytest.mark.parametrize("b,hkv,t", INT8_EDGE_ROWS)
def test_decode_int8_kernel_at_tile_edges_on_card(cuda, d, g, b, hkv, t):
    """The int8 instance within 1e-4 of plain with kv_len on its own
    tiles' edges (one key short of a 256-key tile at D = 64 or a 128-key
    one at D = 128, a tile, one key past, and the same at two tiles where
    T allows), 0 and T; at T = 370 every other (row, head) scale row
    starts only 8-byte aligned; G 1 to 8 at both head dims; a kv_len == 0
    row is exactly zero; one launch under the instance's name."""
    from repro_torch.kernels.mode import launch_name
    rng = np.random.RandomState(1000 * d + 10 * g + t)
    q = torch.from_numpy(rng.randn(b, g * hkv, d).astype(np.float32)).to(
        cuda)
    k8, v8, ks, vs = _int8_kv(rng, b, hkv, t, d, cuda)
    tile = INT8_TILE_KEYS[d]
    edges = [tile - 1, tile, tile + 1, 0, t, 2 * tile - 1, 2 * tile,
             2 * tile + 1, 1, t - 1]
    kvl = np.array([min(e, t) for e in edges] * b, np.int32)[:b]
    kvl = torch.from_numpy(kvl).to(cuda)
    name = launch_name("decode_attention", d, int8=True)
    before = dict(launch_counts)
    out = decode_attention(q, k8, v8, kvl, ks, vs)
    ref = decode_attention_plain(q, k8, v8, kvl, ks, vs)
    assert float((out - ref).abs().max()) <= 1e-4
    assert bool((out[kvl == 0] == 0).all())
    assert launch_counts[name] == before.get(name, 0) + 1


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,n", [(20, 8, 49152), (3, 4, 301), (2, 2, 9000),
                                   (2, 20, 1000), (4, 3, 20000),
                                   (1, 1, 100000), (2, 12, 4099)])
def test_joint_race_kernel_bit_exact_at_split_edges_on_card(cuda, b, k, n):
    """Bitwise equal to plain at the cluster plan's edges: equal target
    scores in two drafts' blocks (the lower index wins), where a block
    takes several drafts a tie across the boundary between two blocks'
    drafts (in the target and in a draft's own row), an all-dead draft
    row (argmin 0) and a row with no active draft (y = 0)."""
    log_s, log_p, log_q, active = _joint_inputs(b, k, n, seed=n + k)
    kc = joint_race_split_plan(k)
    i, j = n // 7, n // 2
    if k > 1:
        log_s[0, 0, j] = log_s[0, k - 1, i] = -60.0
        log_q[0, 0, j] = log_q[0, k - 1, i] = 0.0
        active[0, 0] = active[0, k - 1] = True
    if kc > 1:
        # Drafts kc - 1 (block 0's last) and kc (block 1's first).
        i2, j2 = n // 11, n // 3 + 1
        log_s[0, kc - 1, j2] = log_s[0, kc, [i2, j2]] = -70.0
        log_p[0, kc - 1, j2] = log_p[0, kc, [i2, j2]] = 0.0
        log_q[0, kc - 1, j2] = log_q[0, kc, [i2, j2]] = 0.0
        active[0, kc - 1] = active[0, kc] = True
    if b > 1:
        active[b - 1] = False
    ins = [torch.from_numpy(x).to(cuda)
           for x in (log_s, log_p, log_q, active)]
    x, y = gls_race(*ins)
    xp, yp = gls_race_plain(*ins)
    assert torch.equal(x, xp) and torch.equal(y, yp)
    if kc > 1:
        assert int(x[0, kc]) == i2 and int(x[0, kc - 1]) == j2
        assert int(y[0]) == i2
    elif k > 1:
        assert int(y[0]) == i
    if b > 1:
        assert int(x[1, -1]) == 0 and int(y[b - 1]) == 0


@pytest.mark.cuda
def test_binned_race_kernel_bit_exact_on_card(cuda):
    """At the compression shape class (K + 1 = 5 rows, l_max up to 64)
    and on the scalar-load path (N not a multiple of 4)."""
    for b, k, n, l_max in ((64, 5, 4096, 64), (8, 5, 65536, 2),
                           (16, 3, 301, 8), (2, 5, 777, 64)):
        ins = [torch.from_numpy(x).to(cuda)
               for x in _binned_inputs(b, k, n, l_max, seed=n + l_max)]
        km, ka = gls_binned_race(*ins, l_max=l_max)
        pm, pa = gls_binned_race_plain(*ins, l_max=l_max)
        assert torch.equal(ka, pa)
        assert torch.equal(km.view(torch.int32), pm.view(torch.int32))


@pytest.mark.cuda
def test_joint_race_kernel_bit_exact_on_card(cuda):
    for b, k, n in ((20, 8, 49152), (3, 4, 301), (5, 8, 1000)):
        ins = [torch.from_numpy(x).to(cuda)
               for x in _joint_inputs(b, k, n, seed=n)]
        for a, b_ in zip(gls_race(*ins), gls_race_plain(*ins)):
            assert torch.equal(a, b_)


@pytest.mark.cuda
def test_binned_race_rejects_too_many_bins(cuda):
    ins = [torch.from_numpy(x).to(cuda) for x in _binned_inputs(2, 3, 64, 4,
                                                                 0)]
    with pytest.raises(RuntimeError, match="l_max 65 outside"):
        gls_binned_race(*ins, l_max=65)
