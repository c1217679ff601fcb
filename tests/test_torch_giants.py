"""The dense giants, granite-34b (48 query heads over 1 KV head: MQA) and
llama3-405b (128 over 8: group 16), in the port against the JAX package
on the CPU, and the decode kernel at their groups on the card.

* The port's configs equal JAX's field by field (served in float32).
* ``decode_group_plan`` and ``decode_split_plan`` at the giants' groups:
  both K/V types plan over the (row, KV head slot) clusters of the group
  instance (the keys partitioned, at most 8 splits, the grid resident at
  its shared-memory layout, which fits a block's 227 KB); int8 takes
  slots of 16 heads over a short row.
* Small models that keep head dim 128 and the giants' groups (48 query
  heads over 1 KV head; 16 over 1, llama3's group at one KV head), built
  from JAX's parameters: ``forward`` logits, the slot calls on the kernel
  routes (JAX's Pallas kernels in interpret mode, the port's plain
  versions), within ``tests/test_torch_granite.py``'s tolerances (atol
  1e-5: matmul, RoPE and softmax round in other orders).
* The kv_fused ``SpecDecServer`` emits JAX's token streams on those
  models (``decode_kernel=True``), float32 and ``quant=True``, exactly.
* ``cuda``: the float32 and int8 decode at groups 16 and 48 (D = 128)
  within 1e-4 of plain on the split plan's and tiles' edges, up to 4,096
  keys, and within 4x plain's error of float64, each launch counted once
  under ``decode_attention[_int8]_d128_g<group>``; the paged entry point
  equal to the contiguous kernel bit for bit.

The JAX side is imported inside the CPU fixtures, so the ``cuda`` tests
run on a machine with the card and no JAX:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_giants.py``."""

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.kernels.decode_attention.ops import (SMEM_PER_BLOCK,
                                                      decode_attention,
                                                      decode_attention_paged,
                                                      decode_group_plan,
                                                      decode_split_plan,
                                                      group_blocks_per_sm,
                                                      group_slices,
                                                      group_slots,
                                                      group_smem_bytes)
from repro_torch.kernels.mode import H100_SMS
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


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("b,hkv,group", [(32, 1, 48), (32, 8, 16),
                                         (4, 1, 48), (1, 8, 16),
                                         (8, 2, 56)])
@pytest.mark.parametrize("t", [1, 33, 370, 4096])
def test_decode_split_plan_over_subgroups(b, hkv, group, t, int8):
    """The plan partitions the keys.  Both K/V types plan over the (row,
    KV head slot) clusters of the group instance (float32: one slot up to
    48 heads; int8: the same, or slots of 16 heads over a row of at most
    8 tiles): its layout fits a block's 227 KB; one split while the row's
    32-key tiles are no more than the block's key slices; more splits
    only with every slice a tile a block and the grid within three
    quarters of the blocks the SMs hold."""
    splits, chunk = decode_split_plan(b, hkv, t, head_dim=128, int8=int8,
                                      group=group)
    assert 1 <= splits <= MAX_CLUSTER
    assert (splits - 1) * chunk < t <= splits * chunk
    slots = decode_group_plan(b, hkv, t, head_dim=128, group=group,
                              int8=int8)[0]
    assert (slots, splits, chunk) == decode_group_plan(
        b, hkv, t, head_dim=128, group=group, int8=int8)
    assert slots == group_slots(group, 16 if int8 and t <= 256 else 48)[0]
    assert group_smem_bytes(128, group, int8, slots) <= SMEM_PER_BLOCK
    per_sm = group_blocks_per_sm(128, group, int8, slots)
    clusters = b * hkv * slots
    slices = group_slices(group, slots, int8)[1]
    assert clusters * splits <= H100_SMS * per_sm
    if -(-t // 32) <= slices:
        assert splits == 1
    elif splits > 1:
        assert clusters * splits <= 3 * H100_SMS * per_sm // 4
        assert chunk >= 32 * slices


@pytest.mark.parametrize("group,slots,heads", [(9, 1, 9), (48, 1, 48),
                                               (49, 2, 25), (56, 2, 28),
                                               (96, 2, 48), (128, 3, 43)])
def test_group_slots(group, slots, heads):
    """A float32 group above 48 runs as the fewest head slots of at most
    48 heads; the slots cover the group."""
    assert group_slots(group) == (slots, heads)
    assert heads <= 48 and (slots - 1) * heads < group <= slots * heads


# (head dim, group, int8, slots, bytes, blocks an SM).  Float32: max(KS
# stages x 2 x 32 x D, (16 MT KS + 16 MT + 8) x (D + 4)) + 16 MT x (D +
# 16) floats, then 2 KS mbarriers: granite-34b's group (3 m-tiles, 4
# slices: the stages over the partials, one block an SM by its
# registers), llama3-405b's (1 m-tile, 2 slices: 3 blocks an SM by shared
# memory), 32 heads (2 m-tiles), and D = 64 at 3 m-tiles (the partials
# outgrow the stages).  int8: 4 slices, 2 KS stages of 2 x 32 x D bytes
# and two 36-float scale spans, the same partials and q, 4 KS mbarriers:
# granite-34b's group in one slot (the partials over the stages) and in 3
# slots of 16 heads (1 m-tile: the stages over the partials, 2 blocks an
# SM by registers and shared memory), llama3-405b's, and D = 64.
GROUP_LAYOUTS = [(128, 48, False, 0, 4 * (32768 + 6912) + 64, 1),
                 (128, 16, False, 0, 4 * (16384 + 2304) + 32, 3),
                 (128, 32, False, 0, 4 * (16384 + 4608) + 32, 2),
                 (64, 48, False, 0, 4 * (16864 + 3840) + 64, 1),
                 (128, 48, True, 1, 4 * (32736 + 6912) + 128, 1),
                 (128, 48, True, 3, 4 * (16960 + 2304) + 128, 2),
                 (128, 16, True, 0, 4 * (16960 + 2304) + 128, 2),
                 (64, 48, True, 0, 4 * (16864 + 3840) + 128, 1)]


@pytest.mark.parametrize("head_dim,group,int8,slots,nbytes,blocks",
                         GROUP_LAYOUTS)
def test_group_smem_bytes_counts_the_layout(head_dim, group, int8, slots,
                                            nbytes, blocks):
    """``group_smem_bytes`` counts the group instance's layout (the
    stages, the warps' and the cluster's partials over them, q, the
    barriers), and ``group_blocks_per_sm`` the blocks an SM holds."""
    assert group_smem_bytes(head_dim, group, int8, slots) == nbytes
    assert group_blocks_per_sm(head_dim, group, int8, slots) == blocks


# (rows, KV heads, keys, group, int8) -> (slots, splits, chunk): the
# giants' serve shapes (T = 86) and 4,096 keys.  int8 over a short row
# takes slots of 16 heads (granite-34b's 48 -> 3 slots, 96 blocks); over
# a long one, as float32, one slot with key splits.
GROUP_PLANS = [((32, 1, 86, 48, True), (3, 1, 86)),
               ((32, 1, 86, 48, False), (1, 1, 86)),
               ((32, 1, 4096, 48, True), (1, 3, 1366)),
               ((32, 8, 86, 16, True), (1, 1, 86)),
               ((32, 8, 4096, 16, True), (1, 1, 4096))]


@pytest.mark.parametrize("args,plan", GROUP_PLANS)
def test_decode_group_plan_at_the_giants_shapes(args, plan):
    b, hkv, t, group, int8 = args
    assert decode_group_plan(b, hkv, t, head_dim=128, group=group,
                             int8=int8) == plan


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
    """kv_len on the plan's split edges (a boundary, one key either side,
    the last split's start) and the tiles' (32-key float32 group tiles,
    128-key int8 tiles at D = 128: one short, on, one past, and a second
    tile into a split), repeated over the b rows."""
    edges = [0, 1, chunk, chunk - 1, chunk + 1, (splits - 1) * chunk,
             (splits - 1) * chunk + 1, 32, 33, 64, 65, 128, 129,
             chunk + 32, chunk + 33, t - 1, t]
    return np.array([min(max(e, 0), t) for e in edges] * b, np.int32)[:b]


def _float64_decode(q, k, v, kv_len, ks=None, vs=None):
    """The decode evaluated in float64 (int8 K/V dequantized there by
    their scales) with the plain version's masked-row contract."""
    from repro_torch.kernels.flash_attention.ref import masked_softmax
    b, h, d = q.shape
    hkv, t = k.shape[1:3]
    k, v = k.double(), v.double()
    if ks is not None:
        k, v = k * ks.double(), v * vs.double()
    s = torch.einsum("bhgd,bhtd->bhgt",
                     q.double().reshape(b, hkv, h // hkv, d), k) / d ** 0.5
    live = (torch.arange(t, device=q.device)[None, :]
            < kv_len.long()[:, None])[:, None, None, :]
    return torch.einsum("bhgt,bhtd->bhgd", masked_softmax(s, live),
                        v).reshape(b, h, d)


def _int8_kv(gen, b, hkv, t, dev, d=128):
    from repro_torch.serving.quant import quantize_kv
    (k8, ks), (v8, vs) = (quantize_kv(torch.randn(
        b, hkv, t, d, device=dev, generator=gen)) for _ in range(2))
    return k8, v8, ks, vs


# (rows, KV heads, group): granite-34b's serve rows, llama3-405b's, and
# a few rows, across the plans' edges.
CARD_CASES = [(32, 1, 48), (32, 8, 16), (5, 1, 48), (3, 8, 16)]


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("t", [1, 32, 33, 128, 129, 370, 4096])
@pytest.mark.parametrize("b,hkv,group", CARD_CASES)
def test_decode_kernel_at_giant_groups_on_card(cuda, b, hkv, group, t,
                                               int8):
    """The D = 128 group instance at group 16 and 48, float32 and int8
    K/V, within 1e-4 of plain with kv_len on the plan's split and tile
    edges; a kv_len == 0 row is exactly zero; the launch counts once under
    its group's name.  Its TF32 products (3 a product, 2 over int8 K/V):
    its error against float64 (of the dequantized attention for int8) at
    most 4x plain's (at least 1e-6: with one key plain is exact)."""
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
    want = _float64_decode(q, k, v, kvl, ks, vs)
    err64 = float((out.double() - want).abs().max())
    plain64 = float((ref.double() - want).abs().max())
    assert err64 <= 4 * max(plain64, 1e-6)


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


@pytest.mark.cuda
@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("d,hkv,group,t", [(128, 2, 9, 300), (128, 1, 12, 77),
                                           (64, 2, 16, 200), (64, 1, 48, 65),
                                           (128, 3, 40, 1000),
                                           (128, 2, 56, 300),
                                           (64, 1, 100, 90),
                                           (128, 1, 128, 4096)])
def test_decode_group_instance_other_groups_on_card(cuda, d, hkv, group, t,
                                                    int8):
    """The group instance, float32 and int8 K/V, at groups that leave
    warps short of heads (9: warp 4 one head, warps 5-7 none; 12, 40), at
    D = 64 and above 48 heads (head slots: 56 as 2 of 28, 100 as 3 of 34,
    128 as 3 of 43, the last slot short; int8 over a short row in slots
    of 16: 100 as 7 of 15), within 1e-4 of plain on its plan's edges;
    kv_len == 0 rows zero."""
    gen = torch.Generator(device=cuda).manual_seed(group + d + t + int8)
    b = 6
    q = torch.randn(b, hkv * group, d, device=cuda, generator=gen)
    if int8:
        k, v, ks, vs = _int8_kv(gen, b, hkv, t, cuda, d)
    else:
        k, v = (torch.randn(b, hkv, t, d, device=cuda, generator=gen)
                for _ in range(2))
        ks = vs = None
    splits, chunk = decode_split_plan(b, hkv, t, head_dim=d, int8=int8,
                                      group=group)
    kvl = torch.from_numpy(_edges(b, t, splits, chunk)).to(cuda)
    kvl[1:] = torch.tensor([t, chunk + 1, 33, (splits - 1) * chunk + 1,
                            t - 1][:b - 1], dtype=torch.int32)
    out = decode_attention(q, k, v, kvl, ks, vs)
    ref = decode_attention_plain(q, k, v, kvl, ks, vs)
    assert float((out - ref).abs().max()) <= KERNEL_ATOL
    assert bool((out[kvl == 0] == 0).all())


@pytest.mark.cuda
def test_decode_group_floor_and_limit_on_card(cuda):
    """The group instance's floor (no arithmetic, out zero) runs at
    granite-34b's serve shape and counts no launch; it is compiled at
    head dim 128 only, and a float32 group above 48 runs on head slots,
    the launch counted under its group's name."""
    from repro_torch.kernels.build import load_kernels
    gen = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn(32, 48, 128, device=cuda, generator=gen)
    k, v = (torch.randn(32, 1, 86, 128, device=cuda, generator=gen)
            for _ in range(2))
    kvl = torch.full((32,), 86, dtype=torch.int32, device=cuda)
    splits, chunk = decode_split_plan(32, 1, 86, head_dim=128, group=48)
    before = dict(launch_counts)
    out = load_kernels().decode_attention_group_floor(q, k, v, kvl, splits,
                                                      chunk)
    torch.cuda.synchronize()
    assert bool((out == 0).all())
    assert dict(launch_counts) == before
    with pytest.raises(RuntimeError, match="at head dim 128"):
        load_kernels().decode_attention_group_floor(
            q[..., :64].contiguous(), k[..., :64].contiguous(),
            v[..., :64].contiguous(), kvl, splits, chunk)
    q56 = torch.randn(2, 56, 128, device=cuda, generator=gen)
    out = decode_attention(q56, k[:2], v[:2], kvl[:2])
    ref = decode_attention_plain(q56, k[:2], v[:2], kvl[:2])
    assert float((out - ref).abs().max()) <= KERNEL_ATOL
    assert launch_counts["decode_attention_d128_g56"] == \
        before.get("decode_attention_d128_g56", 0) + 1


@pytest.mark.cuda
def test_decode_int8_group_floor_on_card(cuda):
    """The int8 group instance's floor (no arithmetic, out zero) runs at
    granite-34b's serve shape on the wrapper's plan (3 slots of 16 heads)
    and counts no launch; above 8 heads it is compiled at head dim 128
    only, and a slot count that leaves a slot above 48 heads raises."""
    from repro_torch.kernels.build import load_kernels
    gen = torch.Generator(device=cuda).manual_seed(8)
    q = torch.randn(32, 48, 128, device=cuda, generator=gen)
    k, v, ks, vs = _int8_kv(gen, 32, 1, 86, cuda)
    kvl = torch.full((32,), 86, dtype=torch.int32, device=cuda)
    slots, splits, chunk = decode_group_plan(32, 1, 86, head_dim=128,
                                             group=48, int8=True)
    assert slots == 3
    floor = load_kernels().decode_attention_int8_floor
    before = dict(launch_counts)
    out = floor(q, k, v, ks, vs, kvl, splits, chunk, slots)
    torch.cuda.synchronize()
    assert bool((out == 0).all())
    assert dict(launch_counts) == before
    with pytest.raises(RuntimeError, match="at head dim 128"):
        floor(q[..., :64].contiguous(), k[..., :64].contiguous(),
              v[..., :64].contiguous(), ks, vs, kvl, splits, chunk, slots)
    q56 = torch.randn(2, 56, 128, device=cuda, generator=gen)
    with pytest.raises(RuntimeError, match="head slots"):
        load_kernels().decode_attention_int8(q56, k[:2], v[:2], ks[:2],
                                             vs[:2], kvl[:2], 1, 86, 1)
