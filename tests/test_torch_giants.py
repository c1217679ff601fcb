"""The dense giants, granite-34b (48 query heads over 1 KV head: MQA) and
llama3-405b (128 over 8: group 16), in the port against the JAX package
on the CPU, and the decode kernel at their groups on the card.

* The port's configs equal JAX's field by field (served in float32).
* ``decode_subgroup`` and ``decode_split_plan`` over sub-groups: 48 and
  16 run as sub-groups of 8, the plan counts Hkv x group / 8 head slots
  and still partitions the keys.
* Small models that keep head dim 128 and the giants' groups (48 query
  heads over 1 KV head; 16 over 1, llama3's group at one KV head), built
  from JAX's parameters: ``forward`` logits, the slot calls on the kernel
  routes (JAX's Pallas kernels in interpret mode, the port's plain
  versions), within ``tests/test_torch_granite.py``'s tolerances (atol
  1e-5: matmul, RoPE and softmax round in other orders).
* The kv_fused ``SpecDecServer`` emits JAX's token streams on those
  models (``decode_kernel=True``), float32 and ``quant=True``, exactly.
* ``cuda``: the float32 and int8 decode at groups 16 and 48 (D = 128)
  within 1e-4 of plain on the split plan's edges, each launch counted
  once under ``decode_attention[_int8]_d128_g<group>``, and the paged
  entry point equal to the contiguous kernel bit for bit.

The JAX side is imported inside the CPU fixtures, so the ``cuda`` tests
run on a machine with the card and no JAX:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_giants.py``."""

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.kernels.decode_attention.ops import (decode_attention,
                                                      decode_attention_paged,
                                                      decode_split_plan,
                                                      decode_subgroup)
from repro_torch.kernels.decode_attention.ref import decode_attention_plain
from repro_torch.kernels.mode import MAX_CLUSTER, launch_counts

ATOL_LOGITS = ATOL_KV = 1e-5
KERNEL_ATOL = 1e-4
GIANTS = {"granite-34b": 48, "llama3-405b": 16}
B, T = 4, 40


# ---------------------------------------------------------------------------
# Configs and the split plan (no JAX needed for the plan)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", sorted(GIANTS))
def test_config_matches_jax(arch):
    import importlib
    mod = {"granite-34b": "granite_34b", "llama3-405b": "llama3_405b"}[arch]
    theirs = importlib.import_module(f"repro.configs.{mod}").CONFIG
    ours = get_config(arch)
    assert arch in ARCH_NAMES
    for field in ("name", "family", "num_layers", "d_model", "num_heads",
                  "num_kv_heads", "head_dim", "d_ff", "vocab_size",
                  "rope_theta", "norm_eps", "sliding_window",
                  "resolved_head_dim", "kv_heads", "padded_vocab"):
        assert getattr(ours, field) == getattr(theirs, field), field
    assert ours.num_heads // ours.kv_heads == GIANTS[arch]
    assert ours.resolved_head_dim == 128 and ours.dtype == "float32"


@pytest.mark.parametrize("group,sub", [(1, 1), (3, 3), (8, 8), (10, 5),
                                       (12, 6), (16, 8), (48, 8), (13, 1),
                                       (128, 8)])
def test_decode_subgroup(group, sub):
    assert decode_subgroup(group) == sub
    assert group % sub == 0 and sub <= 8


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("b,hkv,group", [(32, 1, 48), (32, 8, 16),
                                         (4, 1, 48), (1, 8, 16)])
@pytest.mark.parametrize("t", [1, 33, 370, 4096])
def test_decode_split_plan_over_subgroups(b, hkv, group, t, int8):
    """The plan partitions the keys, and a group above 8 plans as its
    head slots would: the same plan as group 8 at hkv x group / 8 KV
    heads."""
    splits, chunk = decode_split_plan(b, hkv, t, head_dim=128, int8=int8,
                                      group=group)
    assert 1 <= splits <= MAX_CLUSTER
    assert (splits - 1) * chunk < t <= splits * chunk
    slots = hkv * group // decode_subgroup(group)
    assert (splits, chunk) == decode_split_plan(b, slots, t, head_dim=128,
                                                int8=int8, group=8)


# ---------------------------------------------------------------------------
# Small models of the giants' shapes against JAX
# ---------------------------------------------------------------------------

# The giants' geometry cut to size: head dim 128 and the group kept.
SMALL = {
    "granite-34b": dict(num_layers=2, d_model=256, d_ff=512,
                        vocab_size=512, num_heads=48, num_kv_heads=1,
                        dtype="float32"),
    "llama3-405b": dict(num_layers=2, d_model=256, d_ff=512,
                        vocab_size=512, num_heads=16, num_kv_heads=1,
                        dtype="float32"),
}


@pytest.fixture(scope="module")
def J():
    jax = pytest.importorskip("jax")
    import types

    import jax.numpy as jnp
    from repro.configs import get_config as j_get
    from repro.models import init_params
    from repro.models import transformer
    from repro.specdec import CachedSpecDecEngine as Engine
    from repro.specdec import SpecDecConfig as Config
    from repro.specdec import SpecDecServer as Server
    return types.SimpleNamespace(jax=jax, jnp=jnp, get=j_get,
                                 init=init_params, T=transformer,
                                 Engine=Engine, Config=Config, Server=Server)


def _conv(J, p):
    from repro_torch.models import params_from_jax
    return params_from_jax(J.jax.tree_util.tree_map(np.asarray, p),
                           device="cpu")


@pytest.fixture(scope="module", params=sorted(GIANTS))
def model(request, J):
    arch = request.param
    jcfg = J.get(arch).replace(**SMALL[arch])
    tcfg = get_config(arch).replace(**SMALL[arch])
    jp = J.init(J.jax.random.PRNGKey(0), jcfg)
    return arch, jcfg, tcfg, jp, _conv(J, jp)


def test_small_model_keeps_the_group(model):
    arch, jcfg, tcfg, jp, tp = model
    for cfg in (jcfg, tcfg):
        assert cfg.resolved_head_dim == 128
        assert cfg.num_heads // cfg.kv_heads == GIANTS[arch]
    assert tuple(tp["layers"][0]["attn"]["wk"].shape) == (256, 128)
    np.testing.assert_array_equal(tp["layers"][1]["attn"]["wq"].numpy(),
                                  np.asarray(jp["layers"]["attn"]["wq"][1]))


def test_forward_matches_jax(model, J):
    arch, jcfg, tcfg, jp, tp = model
    from repro_torch.models import transformer as TT
    toks = np.random.RandomState(1).randint(0, 512, (2, 24)).astype(
        np.int32)
    jl = J.T.forward(jp, jcfg, {"tokens": J.jnp.asarray(toks)})
    tl = TT.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL_LOGITS)


def test_slot_calls_on_kernel_routes_match_jax(model, J):
    """``prefill_slots`` (flash route: a write mask, a chunk tail past T)
    then ``decode_step_slots`` (decode route, the giants' group) on the
    arena it wrote: JAX's Pallas kernels in interpret mode against the
    port's plain versions; arenas and logits allclose, masked rows
    bit-untouched."""
    arch, jcfg, tcfg, jp, tp = model
    from repro_torch.models import transformer as TT
    jnp = J.jnp
    rng = np.random.RandomState(2)
    shape = (2, B, 1, T, 128)
    ck, cv = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    jc = {"k": jnp.asarray(ck), "v": jnp.asarray(cv)}
    tc = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}
    toks = rng.randint(0, 512, (B, 16)).astype(np.int32)
    pos = np.array([0, 3, 10, 30], np.int32)
    write = np.array([True, False, True, True])
    jc = J.T.prefill_slots(jp, jcfg, jnp.asarray(toks), jc,
                           jnp.asarray(pos), jnp.asarray(write),
                           use_kernel=True, interpret=True)
    TT.prefill_slots(tp, tcfg, torch.from_numpy(toks), tc, pos, write,
                     use_kernel=True)
    for kk, orig in (("k", ck), ("v", cv)):
        got = tc[kk].numpy()
        np.testing.assert_allclose(got, np.asarray(jc[kk]), rtol=0,
                                   atol=ATOL_KV)
        np.testing.assert_array_equal(got[:, 1], orig[:, 1])
    dpos = np.array([16, 19, 26, 39], np.int32)
    dtok = rng.randint(0, 512, (B, 1)).astype(np.int32)
    jl = J.T.decode_step_slots(jp, jcfg, jnp.asarray(dtok), jc,
                               jnp.asarray(dpos), use_kernel=True,
                               interpret=True)
    if isinstance(jl, tuple):
        jl = jl[0]
    tl = TT.decode_step_slots(tp, tcfg, torch.from_numpy(dtok), tc,
                              torch.from_numpy(dpos), use_kernel=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL_LOGITS)


@pytest.mark.parametrize("quant", [False, True])
def test_kv_fused_streams_match_jax(model, J, quant):
    """Two requests (prompts of 5 and 20 tokens) through the kv_fused
    server with both attention routes on (JAX's Pallas kernels in
    interpret mode, the port's plain versions) and a 1-layer drafter of
    the same geometry: per-request token streams equal JAX's, float32
    and ``quant=True``, with the fused round's sync accounting."""
    arch, jcfg, tcfg, jp, tp = model
    from repro_torch import random as R
    from repro_torch.specdec import CachedSpecDecEngine, SpecDecConfig
    from repro_torch.specdec import SpecDecServer
    jd_cfg, td_cfg = (c.replace(name="d", num_layers=1)
                      for c in (jcfg, tcfg))
    jdp = J.init(J.jax.random.PRNGKey(1), jd_cfg)
    kw = dict(num_drafts=4, draft_len=3, strategy="gls",
              decode_kernel=True, prefill_kernel=True, quant=quant)
    je = J.Engine((jp, jcfg), (jdp, jd_cfg),
                  J.Config(verifier_backend="pallas", **kw), pool_slots=2)
    js = J.Server(je, max_batch=2, cache_mode="kv_fused")
    te = CachedSpecDecEngine((tp, tcfg), (_conv(J, jdp), td_cfg),
                             SpecDecConfig(verifier_backend="kernel", **kw),
                             pool_slots=2, device="cpu")
    ts = SpecDecServer(te, max_batch=2)
    for i, n in enumerate((5, 20)):
        p = np.random.RandomState(3 + i).randint(0, 512, n).astype(np.int32)
        js.submit(p, max_new=8)
        ts.submit(p, max_new=8)
    jdone = {r.uid: r.output for r in js.run(J.jax.random.PRNGKey(0))}
    tdone = {r.uid: r.output for r in ts.run(R.PRNGKey(0))}
    assert sorted(jdone) == sorted(tdone) == [1, 2]
    for uid in jdone:
        assert jdone[uid] == tdone[uid], uid
    m = ts.metrics
    assert m.rounds == js.metrics.rounds
    assert m.draft_syncs == 0 and m.host_syncs == m.rounds


# ---------------------------------------------------------------------------
# The kernel at the giants' groups, on the card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _edges(b, t, splits, chunk):
    edges = [0, 1, chunk, chunk - 1, chunk + 1, (splits - 1) * chunk, 32,
             33, 64, 65, 128, 129, t - 1, t]
    return np.array([min(max(e, 0), t) for e in edges] * b, np.int32)[:b]


def _int8_kv(gen, b, hkv, t, dev):
    from repro_torch.serving.quant import quantize_kv
    (k8, ks), (v8, vs) = (quantize_kv(torch.randn(
        b, hkv, t, 128, device=dev, generator=gen)) for _ in range(2))
    return k8, v8, ks, vs


# (rows, KV heads, group): granite-34b's serve rows, llama3-405b's, and
# a few rows, across the plans' edges.
CARD_CASES = [(32, 1, 48), (32, 8, 16), (5, 1, 48), (3, 8, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("t", [1, 32, 33, 128, 129, 370])
@pytest.mark.parametrize("b,hkv,group", CARD_CASES)
def test_decode_kernel_at_giant_groups_on_card(cuda, b, hkv, group, t,
                                               int8):
    """The D = 128 instance at group 16 and 48 (sub-groups of 8) within
    1e-4 of plain with kv_len on the plan's split and tile edges; a
    kv_len == 0 row is exactly zero; the launch counts once under its
    group's name."""
    gen = torch.Generator(device=cuda).manual_seed(t + group + int8)
    q = torch.randn(b, hkv * group, 128, device=cuda, generator=gen)
    if int8:
        k, v, ks, vs = _int8_kv(gen, b, hkv, t, cuda)
    else:
        k, v = (torch.randn(b, hkv, t, 128, device=cuda, generator=gen)
                for _ in range(2))
        ks = vs = None
    splits, chunk = decode_split_plan(b, hkv, t, head_dim=128, int8=int8,
                                      group=group)
    kvl = torch.from_numpy(_edges(b, t, splits, chunk)).to(cuda)
    name = f"decode_attention{'_int8' if int8 else ''}_d128_g{group}"
    before = dict(launch_counts)
    out = decode_attention(q, k, v, kvl, ks, vs)
    ref = decode_attention_plain(q, k, v, kvl, ks, vs)
    assert float((out - ref).abs().max()) <= KERNEL_ATOL
    assert bool((out[kvl == 0] == 0).all())
    assert launch_counts[name] == before.get(name, 0) + 1
    plain_name = f"decode_attention{'_int8' if int8 else ''}_d128"
    assert launch_counts[plain_name] == before.get(plain_name, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("hkv,group", [(1, 48), (8, 16)])
def test_paged_decode_at_giant_groups_on_card(cuda, hkv, group, int8):
    """The paged entry point at groups 48 and 16 equals the contiguous
    kernel on the gathered view bit for bit."""
    from repro_torch.kernels.paged import gather_kv_pages
    gen = torch.Generator(device=cuda).manual_seed(group + int8)
    b, page, n_lp = 6, 16, 5
    pool_n = b * n_lp
    shape = (pool_n + 2, hkv, page, 128)
    if int8:
        kp, vp = (torch.randint(-127, 128, shape, device=cuda,
                                generator=gen).to(torch.int8)
                  for _ in range(2))
        ks, vs = (torch.rand(shape[:-1] + (1,), device=cuda, generator=gen)
                  * 0.05 for _ in range(2))
    else:
        kp, vp = (torch.randn(shape, device=cuda, generator=gen)
                  for _ in range(2))
        ks = vs = None
    table = (torch.randperm(pool_n, device=cuda, generator=gen) + 1) \
        .reshape(b, n_lp).to(torch.int32)
    table[0, 3:] = 0
    buf = page * n_lp
    kv_len = torch.randint(1, buf, (b,), device=cuda, generator=gen,
                           dtype=torch.int32)
    q = torch.randn(b, hkv * group, 128, device=cuda, generator=gen)
    got = decode_attention_paged(q, kp, vp, table, kv_len, ks, vs,
                                 buf_len=buf)
    view = [None if x is None else gather_kv_pages(x, table, buf)
            for x in (kp, vp, ks, vs)]
    want = decode_attention(q, *view[:2], kv_len, *view[2:])
    assert torch.equal(got, want)
    ref = decode_attention_plain(q, *view[:2], kv_len, *view[2:])
    assert float((got - ref).abs().max()) <= KERNEL_ATOL
