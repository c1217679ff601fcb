"""granite-8b in the port against the JAX package on the CPU: the
head-dim-128, 4-query-heads-per-KV-head geometry that the attention
kernels' D = 128 instances serve.

* The port's config equals JAX's ``configs/granite_8b.py`` field by
  field (the port serves it in float32).
* A small model of granite's shape (2 layers, d_model 256, 8 heads over
  2 KV heads: head dim 128, group 4 -- ``reduced()`` would force head dim
  64): JAX parameters carried over by ``convert.py`` give JAX's
  ``forward`` logits and, on the kernel routes (JAX's Pallas kernels in
  interpret mode, the port's plain versions), JAX's ``prefill_slots``
  arena writes and ``decode_step_slots`` logits, within the tolerances
  of ``tests/test_torch_model.py`` (atol 1e-5: matmul, RoPE and softmax
  round in other orders).
* The kv_fused ``SpecDecServer`` emits JAX's token streams on that model,
  float32 and ``quant=True``, compared exactly as in
  ``tests/test_torch_serving.py``.
* ``decode_split_plan`` partitions the keys with the D = 128 instance's
  key bytes and tiles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.granite_8b import CONFIG as J_GRANITE
from repro.models import init_params as j_init
from repro.models import transformer as JT
from repro.specdec import CachedSpecDecEngine as JEngine
from repro.specdec import SpecDecConfig as JConfig
from repro.specdec import SpecDecServer as JServer
from repro_torch import random as R
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.kernels.decode_attention.ops import (bytes_per_key,
                                                      decode_split_plan)
from repro_torch.kernels.mode import MAX_CLUSTER
from repro_torch.models import params_from_jax
from repro_torch.models import transformer as TT
from repro_torch.specdec import CachedSpecDecEngine, SpecDecConfig
from repro_torch.specdec import SpecDecServer

# granite-8b's shape cut to size: head dim 128 and group 4 kept.
SMALL = dict(num_layers=2, d_model=256, d_ff=512, vocab_size=512,
             num_heads=8, num_kv_heads=2, dtype="float32")
ATOL_LOGITS = ATOL_KV = 1e-5
B, T = 4, 40


def _conv(p):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, p),
                           device="cpu")


@pytest.fixture(scope="module")
def model():
    jcfg = J_GRANITE.replace(**SMALL)
    tcfg = get_config("granite-8b").replace(**SMALL)
    jp = j_init(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, _conv(jp)


def test_config_matches_jax():
    ours = get_config("granite-8b")
    assert "granite-8b" in ARCH_NAMES
    for field in ("name", "family", "num_layers", "d_model", "num_heads",
                  "num_kv_heads", "head_dim", "d_ff", "vocab_size",
                  "rope_theta", "norm_eps", "resolved_head_dim", "kv_heads",
                  "padded_vocab"):
        assert getattr(ours, field) == getattr(J_GRANITE, field), field
    assert (ours.resolved_head_dim, ours.num_heads // ours.kv_heads) == \
        (128, 4)
    assert ours.dtype == "float32"


def test_small_model_keeps_granites_shape(model):
    jcfg, tcfg, jp, tp = model
    for cfg in (jcfg, tcfg):
        assert cfg.resolved_head_dim == 128
        assert cfg.num_heads // cfg.kv_heads == 4
    layer = tp["layers"][1]
    assert tuple(layer["attn"]["wq"].shape) == (256, 8 * 128)
    assert tuple(layer["attn"]["wk"].shape) == (256, 2 * 128)
    np.testing.assert_array_equal(layer["attn"]["wk"].numpy(),
                                  np.asarray(jp["layers"]["attn"]["wk"][1]))
    np.testing.assert_array_equal(tp["lm_head"].numpy(),
                                  np.asarray(jp["lm_head"]))


def test_forward_matches_jax(model):
    jcfg, tcfg, jp, tp = model
    toks = np.random.RandomState(1).randint(0, 512, (2, 24)).astype(
        np.int32)
    jl = JT.forward(jp, jcfg, {"tokens": jnp.asarray(toks)})
    tl = TT.forward(tp, tcfg, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL_LOGITS)


def test_slot_calls_on_kernel_routes_match_jax(model):
    """``prefill_slots`` (flash route: a write mask, a chunk tail past T)
    then ``decode_step_slots`` (decode route) on the arena it wrote: JAX
    runs its Pallas kernels in interpret mode, the port its plain
    versions; arenas and logits allclose, masked rows bit-untouched."""
    jcfg, tcfg, jp, tp = model
    rng = np.random.RandomState(2)
    shape = (SMALL["num_layers"], B, SMALL["num_kv_heads"], T, 128)
    ck, cv = (rng.randn(*shape).astype(np.float32) for _ in range(2))
    jc = {"k": jnp.asarray(ck), "v": jnp.asarray(cv)}
    tc = {"k": torch.from_numpy(ck.copy()), "v": torch.from_numpy(cv.copy())}
    toks = rng.randint(0, 512, (B, 16)).astype(np.int32)
    pos = np.array([0, 3, 10, 30], np.int32)
    write = np.array([True, False, True, True])
    jc = JT.prefill_slots(jp, jcfg, jnp.asarray(toks), jc, jnp.asarray(pos),
                          jnp.asarray(write), use_kernel=True,
                          interpret=True)
    TT.prefill_slots(tp, tcfg, torch.from_numpy(toks), tc, pos, write,
                     use_kernel=True)
    for kk, orig in (("k", ck), ("v", cv)):
        got = tc[kk].numpy()
        np.testing.assert_allclose(got, np.asarray(jc[kk]), rtol=0,
                                   atol=ATOL_KV)
        np.testing.assert_array_equal(got[:, 1], orig[:, 1])
    step = np.array([[5], [17], [511], [0]], np.int32)
    dpos = np.array([16, 9, 26, 39], np.int32)
    jl, jc = JT.decode_step_slots(jp, jcfg, jnp.asarray(step), jc,
                                  jnp.asarray(dpos), use_kernel=True,
                                  interpret=True)
    tl = TT.decode_step_slots(tp, tcfg, torch.from_numpy(step), tc,
                              torch.from_numpy(dpos), use_kernel=True)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                               atol=ATOL_LOGITS)
    for kk in ("k", "v"):
        np.testing.assert_allclose(tc[kk].numpy(), np.asarray(jc[kk]),
                                   rtol=0, atol=ATOL_KV)


@pytest.mark.parametrize("quant", [False, True])
def test_server_matches_jax_kv_fused(model, quant):
    """Two requests (prompts of 5 and 20 tokens) through the kv_fused
    server with both attention routes on and a 1-layer drafter of the
    same widths: per-request token streams equal JAX's, with the
    fused-round sync accounting."""
    jcfg, tcfg, jp, tp = model
    jd_cfg, td_cfg = (c.replace(name="d", num_layers=1)
                      for c in (jcfg, tcfg))
    jdp = j_init(jax.random.PRNGKey(1), jd_cfg)
    kw = dict(num_drafts=4, draft_len=3, strategy="gls",
              decode_kernel=True, prefill_kernel=True, quant=quant)
    je = JEngine((jp, jcfg), (jdp, jd_cfg),
                 JConfig(verifier_backend="pallas", **kw), pool_slots=2)
    js = JServer(je, max_batch=2, cache_mode="kv_fused")
    te = CachedSpecDecEngine((tp, tcfg), (_conv(jdp), td_cfg),
                             SpecDecConfig(verifier_backend="kernel", **kw),
                             pool_slots=2, device="cpu")
    ts = SpecDecServer(te, max_batch=2)
    for i, n in enumerate((5, 20)):
        p = np.random.RandomState(3 + i).randint(0, 512, n).astype(np.int32)
        js.submit(p, max_new=8)
        ts.submit(p, max_new=8)
    jdone = {r.uid: r.output for r in js.run(jax.random.PRNGKey(0))}
    tdone = {r.uid: r.output for r in ts.run(R.PRNGKey(0))}
    assert sorted(jdone) == sorted(tdone) == [1, 2]
    for uid in jdone:
        assert jdone[uid] == tdone[uid], uid
    m = ts.metrics
    assert m.rounds == js.metrics.rounds
    assert m.draft_syncs == 0 and m.host_syncs == m.rounds
    assert te.pool.quant == quant


def _ranges(splits, chunk, n):
    return [(min(i * chunk, n), min((i + 1) * chunk, n))
            for i in range(splits)]


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("b,hkv,t", [
    (32, 8, 370), (32, 8, 338), (32, 8, 1), (32, 8, 31), (32, 8, 32),
    (32, 8, 33), (8, 8, 370), (2, 8, 65), (64, 8, 370), (1, 1, 4096)])
def test_decode_split_plan_partitions_keys_d128(b, hkv, t, int8):
    """The D = 128 instance's plan: the clusters' key ranges partition
    [0, T); at granite's serve shape the float32 grid (256 rows x 1
    split, two 32-key stages of 1 KB keys, 3 blocks per SM) stays in one
    wave, and the int8 instance's 256 (row, KV head) clusters already
    cover the 132 SMs with one split (two 128-key stages of 264-byte keys:
    its K, V and two scales)."""
    splits, chunk = decode_split_plan(b, hkv, t, head_dim=128, int8=int8)
    assert 1 <= splits <= MAX_CLUSTER and chunk == max(1, -(-t // splits))
    covered = []
    for start, end in _ranges(splits, chunk, t):
        covered.extend(range(start, end))
    assert covered == list(range(t))
    if (b, hkv, t) == (32, 8, 370):
        assert (splits, chunk) == (1, 370)
    if t <= 16:
        assert splits == 1
    assert bytes_per_key(128, int8) == (2 * 128 + 8 if int8 else 8 * 128)
