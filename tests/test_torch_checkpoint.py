"""The port's checkpoints against the JAX package's on the CPU.

* ``codec.packb`` gives exactly ``msgpack.packb(_pack(tree),
  use_bin_type=True)``, and the port's encoding of a tree JAX's bytes
  of it with sorted keys (hypothesis, over
  trees of the types the format uses, and every 16/32-bit header), and
  ``codec.unpackb`` reads back what msgpack-python reads;
* a file JAX's ``save_checkpoint`` wrote is read by the port, and a file
  the port wrote by JAX's ``load_checkpoint``, bit for bit, for every
  dtype (bfloat16 included), and the two writers' files are the same
  bytes;
* ``params_to_jax`` gives JAX's stacked tree for each of the six
  families (its structure, shapes and leaves), ``params_from_jax``
  undoes it bit for bit, also from the tensors ``load_checkpoint``
  returns;
* ``train(checkpoint_path=)`` after 2 steps writes what JAX's loop
  writes from the same start (rtol 1e-5 / atol 1e-6), and
  ``launch/train.py --checkpoint`` a file JAX reads;
* the ``.tmp`` file replaces the target atomically, and an array over
  4 GiB raises (by a patched limit, not a real allocation).

JAX and msgpack are imported inside the tests; the ``cuda`` test runs on
the card: ``PYTHONPATH=src python -m pytest -q -m cuda
tests/test_torch_checkpoint.py``."""

import os
import types

import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

from repro_torch.configs import get_config
from repro_torch.data import lm_dataset
from repro_torch.models import init_params, params_from_jax, params_to_jax
from repro_torch.optim import tree_leaves
from repro_torch.train import TrainConfig, load_checkpoint, save_checkpoint
from repro_torch.train import checkpoint as CK
from repro_torch.train import codec, train

# One intra-op thread: the suite runs under several pytest-xdist workers
# on a few cores, where torch's default of a thread a core makes the
# workers contend over tensors of a few kilobytes.
torch.set_num_threads(1)

FAMILIES = {"dense": "smollm-360m", "moe": "granite-moe-1b-a400m",
            "ssm": "mamba2-370m", "hybrid": "recurrentgemma-2b",
            "encdec": "whisper-small", "vlm": "llama-3.2-vision-11b"}
DTYPES = ("float32", "float16", "bfloat16", "int8", "int32", "uint32",
          "bool", "float64", "int64", "uint8")
# Params after AdamW steps: Adam divides by sqrt(v), so where a gradient
# sits near 0 its float32 rounding moves that element's update by up to
# a few 1e-7 (an update is at most lr = 3e-4 a step).
RTOL_TRAIN, ATOL_TRAIN = 1e-5, 1e-6


@pytest.fixture(scope="module")
def jx():
    import jax
    import msgpack
    from repro.configs import get_config as j_get_config
    from repro.models import init_params as j_init
    from repro.train import checkpoint as jck
    from repro.train import loop as jloop
    return types.SimpleNamespace(jax=jax, msgpack=msgpack, ck=jck,
                                 loop=jloop, get_config=j_get_config,
                                 init=j_init)


def _np_array(dtype: str, shape, seed: int) -> np.ndarray:
    """Random values of ``dtype`` (bfloat16 through ml_dtypes, which JAX
    brings)."""
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.integers(0, 2, shape).astype(bool)
    if dtype.startswith(("int", "uint")):
        info = np.iinfo(dtype)
        return rng.integers(info.min, info.max, shape, dtype=dtype,
                            endpoint=True)
    if dtype == "bfloat16":
        import ml_dtypes
        return rng.normal(size=shape).astype(ml_dtypes.bfloat16)
    return rng.normal(size=shape).astype(dtype)


def _torch(a: np.ndarray) -> torch.Tensor:
    if str(a.dtype) == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bits(x) -> np.ndarray:
    """The raw bytes of an array or tensor, for bitwise comparison."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous().reshape(-1)
        return x.view(torch.uint8).numpy()
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


def _dumps(tree) -> bytes:
    """The port's checkpoint bytes of ``tree`` (dict keys sorted)."""
    return codec.packb(CK._pack(tree), CK._default)


def _sorted(tree):
    """``tree`` with every dict's keys sorted, as JAX's ``save_checkpoint``
    rebuilds them (``jax.tree.map``)."""
    if isinstance(tree, dict):
        return {k: _sorted(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_sorted(v) for v in tree)
    return tree


def _assert_bitwise(jx, got, want):
    g = jx.jax.tree_util.tree_leaves(got)
    w = jx.jax.tree_util.tree_leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert tuple(a.shape) == tuple(np.shape(b))
        np.testing.assert_array_equal(_bits(a), _bits(b))


def _as_jax(jx, tree):
    """What JAX's ``load_checkpoint`` makes of these arrays: ``jnp.asarray``
    (64-bit types become 32-bit ones unless x64 is on)."""
    return jx.jax.tree.map(lambda a: np.asarray(jx.jax.numpy.asarray(a)),
                           tree)


# ----------------------------------------------------------------------
# The codec against msgpack-python
# ----------------------------------------------------------------------

_scalars = (st.none() | st.booleans()
            | st.integers(min_value=-2**63, max_value=2**64 - 1)
            | st.floats(allow_nan=False) | st.text(max_size=300)
            | st.binary(max_size=300))
_arrays = hnp.arrays(
    st.sampled_from([np.float32, np.float16, np.int8, np.int32, np.uint32,
                     np.bool_, np.float64, np.int64]),
    hnp.array_shapes(min_dims=0, max_dims=3, max_side=5))
_trees = st.recursive(
    _scalars | _arrays,
    lambda kids: (st.lists(kids, max_size=18)
                  | st.lists(kids, max_size=4).map(tuple)
                  | st.dictionaries(st.text(max_size=8), kids, max_size=18)),
    max_leaves=40)


def _plain(obj):
    """``codec.unpackb``'s result with each bin as bytes."""
    if isinstance(obj, memoryview):
        return bytes(obj)
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_plain(v) for v in obj]
    return obj


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(tree=_trees)
def test_codec_bytes_equal_msgpack(jx, tree):
    packed = jx.ck._pack(tree)
    want = jx.msgpack.packb(packed, use_bin_type=True)
    assert codec.packb(packed) == want
    assert _plain(codec.unpackb(want)) == jx.msgpack.unpackb(
        want, raw=False, strict_map_key=False)
    assert _dumps(tree) == jx.msgpack.packb(jx.ck._pack(_sorted(tree)),
                                            use_bin_type=True)


@pytest.mark.parametrize("n", [15, 16, 31, 32, 255, 256, 65535, 65536])
def test_codec_every_header_width(jx, n):
    """fix, 8-, 16- and 32-bit forms of str, bin, array and map, and the
    integer encodings around each boundary."""
    ints = [v for b in (7, 8, 15, 16, 31, 32, 63, 64)
            for v in (2**b - 1, 2**b, -2**(b - 1), -2**(b - 1) - 1)
            if -2**63 <= v <= 2**64 - 1]
    tree = {"s": "x" * n, "b": b"\x01" * n, "a": list(range(n)),
            "m": {str(i): i for i in range(n)}, "i": ints, "f": [0.1, -2.5]}
    want = jx.msgpack.packb(tree, use_bin_type=True)
    assert codec.packb(tree) == want
    assert _plain(codec.unpackb(want)) == jx.msgpack.unpackb(want,
                                                             raw=False)


def test_codec_reads_float32_and_refuses_ext(jx):
    b = jx.msgpack.packb([1.5, -0.25], use_single_float=True)
    assert b[1] == 0xca
    assert codec.unpackb(b) == [1.5, -0.25]
    with pytest.raises(ValueError, match="subset"):
        codec.unpackb(jx.msgpack.packb(jx.msgpack.ExtType(1, b"x")))
    with pytest.raises(OverflowError):
        codec.packb(2**64)


# ----------------------------------------------------------------------
# Files both ways
# ----------------------------------------------------------------------

def _mixed_tree(seed: int):
    """A tree of every dtype, a 0-d and an empty array, nested lists and
    tuples, and scalars, as numpy (JAX's side) and as torch (the
    port's)."""
    arrays = {d: _np_array(d, (3, 5) if i % 2 else (7,), seed + i)
              for i, d in enumerate(DTYPES)}
    arrays["scalar"] = np.asarray(np.float32(2.5))
    arrays["empty"] = np.zeros((0, 4), np.int32)
    meta = {"step": 3, "lr": 1e-3, "name": "ckpt", "flags": [True, None]}
    np_tree = {"arrays": arrays, "seq": (arrays["float32"], [arrays["int8"]]),
               "meta": meta}
    t_arrays = {k: _torch(v) for k, v in arrays.items()}
    t_tree = {"arrays": t_arrays,
              "seq": (t_arrays["float32"], [t_arrays["int8"]]), "meta": meta}
    return np_tree, t_tree


def test_jax_file_read_by_port(jx, tmp_path):
    np_tree, _ = _mixed_tree(0)
    path = str(tmp_path / "jax.msgpack")
    jx.ck.save_checkpoint(path, np_tree)
    got = load_checkpoint(path, device="cpu")
    assert isinstance(got["seq"], tuple) and isinstance(got["seq"][1], list)
    assert got["meta"] == np_tree["meta"]
    for k, v in np_tree["arrays"].items():
        t = got["arrays"][k]
        assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
        assert CK._NAMES[t.dtype] == str(v.dtype)
        assert tuple(t.shape) == v.shape
        np.testing.assert_array_equal(_bits(t), _bits(v))
    np.testing.assert_array_equal(_bits(got["seq"][1][0]),
                                  _bits(np_tree["arrays"]["int8"]))


def test_port_file_read_by_jax_and_bytes_equal(jx, tmp_path):
    np_tree, t_tree = _mixed_tree(1)
    ours, theirs = str(tmp_path / "port.msgpack"), str(tmp_path / "jax")
    save_checkpoint(ours, t_tree)
    jx.ck.save_checkpoint(theirs, np_tree)
    assert open(ours, "rb").read() == open(theirs, "rb").read()
    got = jx.ck.load_checkpoint(ours)
    assert got["meta"] == np_tree["meta"]
    for k in ("arrays", "seq"):
        _assert_bitwise(jx, got[k], _as_jax(jx, np_tree[k]))
    assert str(got["arrays"]["bfloat16"].dtype) == "bfloat16"


@pytest.mark.parametrize("dtype", DTYPES)
def test_each_dtype_round_trips(jx, tmp_path, dtype):
    a = _np_array(dtype, (4, 3), 11)
    path = str(tmp_path / "x")
    save_checkpoint(path, {"x": _torch(a)})
    back = load_checkpoint(path, device="cpu")["x"]
    np.testing.assert_array_equal(_bits(back), _bits(a))
    np.testing.assert_array_equal(_bits(jx.ck.load_checkpoint(path)["x"]),
                                  _bits(_as_jax(jx, a)))


def test_atomic_replace(tmp_path, monkeypatch):
    """The tree goes whole to ``path + ".tmp"``, which then replaces
    ``path``; until then ``path`` keeps its old bytes, and a failed write
    leaves it so and removes the ``.tmp``."""
    path = str(tmp_path / "ck.msgpack")
    save_checkpoint(path, {"v": torch.zeros(4)})
    old = open(path, "rb").read()
    new_tree = {"v": torch.arange(6.0)}
    seen = []
    real_replace = os.replace

    def replace(src, dst):
        seen.append((src, dst, open(src, "rb").read(), open(dst, "rb").read()))
        real_replace(src, dst)
    monkeypatch.setattr(CK.os, "replace", replace)
    save_checkpoint(path, new_tree)
    assert seen == [(path + ".tmp", path, _dumps(new_tree), old)]
    assert not os.path.exists(path + ".tmp")
    assert open(path, "rb").read() == _dumps(new_tree)

    new = _dumps(new_tree)
    monkeypatch.setattr(codec, "MAX_LEN", 15)
    with pytest.raises(ValueError, match="4 GiB"):
        save_checkpoint(path, {"w": torch.zeros(4, dtype=torch.float32)})
    assert open(path, "rb").read() == new
    assert not os.path.exists(path + ".tmp")


def test_array_over_4gib_raises(monkeypatch):
    """msgpack's bin32 holds at most 2**32 - 1 bytes: a larger array
    raises (the limit patched down, so no 4 GiB array is made)."""
    monkeypatch.setattr(codec, "MAX_LEN", 2**10 - 1)
    _dumps({"ok": torch.zeros(255)})
    with pytest.raises(ValueError, match="bin32 limit of 4 GiB"):
        _dumps({"big": torch.zeros(256)})


def test_load_defaults_to_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device exists")
    path = str(tmp_path / "x")
    save_checkpoint(path, {"x": torch.ones(2)})
    with pytest.raises(RuntimeError, match="CUDA"):
        load_checkpoint(path)


# ----------------------------------------------------------------------
# params_to_jax, the trainer and the launcher
# ----------------------------------------------------------------------

def _jax_params(jx, name: str, seed: int = 0):
    jcfg = jx.get_config(name).reduced()
    jp = jx.jax.jit(jx.init, static_argnums=1)(
        jx.jax.random.PRNGKey(seed), jcfg)
    return jcfg, jx.jax.tree.map(np.asarray, jp)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_params_to_jax_round_trips(jx, tmp_path, family):
    name = FAMILIES[family]
    _, jp = _jax_params(jx, name)
    tp = params_from_jax(jp, device="cpu")
    back = params_to_jax(tp)
    want_def = jx.jax.tree.structure(jp)
    assert jx.jax.tree.structure(back) == want_def
    _assert_bitwise(jx, back, jp)
    again = params_from_jax(back, device="cpu")
    _assert_bitwise(jx, again, tp)

    # Through a file: JAX reads the port's, the port reads it back.
    path = str(tmp_path / f"{family}.msgpack")
    save_checkpoint(path, {"params": back})
    loaded = jx.ck.load_checkpoint(path)["params"]
    assert jx.jax.tree.structure(loaded) == want_def
    _assert_bitwise(jx, loaded, jp)
    mine = params_from_jax(load_checkpoint(path, device="cpu")["params"],
                           device="cpu")
    _assert_bitwise(jx, mine, tp)

    # The port's own init has JAX's tree and shapes.
    tcfg = get_config(name).reduced()
    own = params_to_jax(init_params(torch.Generator().manual_seed(0), tcfg,
                                    "cpu"))
    assert jx.jax.tree.structure(own) == want_def
    assert ([tuple(a.shape) for a in jx.jax.tree.leaves(own)]
            == [a.shape for a in jx.jax.tree.leaves(jp)])


def test_train_checkpoint_matches_jax(jx, tmp_path):
    """Two steps (``warmup=1``: step 1 moves the params) from the same
    start; both loops' files, read by JAX, agree, and the port's equals
    the port's final params bit for bit."""
    import jax.numpy as jnp
    jcfg, jp = _jax_params(jx, FAMILIES["dense"])
    tcfg = get_config(FAMILIES["dense"]).reduced()
    kw = dict(total_steps=2, warmup=1, log_every=1)
    ds = dict(batch=2, seq=32, vocab_size=tcfg.vocab_size, seed=3,
              num_sentences=200)
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    j_final, _ = jx.loop.train(jx.jax.tree.map(jnp.asarray, jp), jcfg,
                               jx.loop.TrainConfig(**kw),
                               lm_dataset(**ds), checkpoint_path=theirs,
                               log=lambda *_: None)
    t_final, _ = train(params_from_jax(jp, device="cpu"), tcfg,
                       TrainConfig(**kw), lm_dataset(**ds),
                       checkpoint_path=ours, device="cpu",
                       log=lambda *_: None)
    got = jx.ck.load_checkpoint(ours)
    want = jx.ck.load_checkpoint(theirs)
    assert jx.jax.tree.structure(got) == jx.jax.tree.structure(want)
    g, w = jx.jax.tree.leaves(got), jx.jax.tree.leaves(want)
    for a, b in zip(g, w):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=RTOL_TRAIN, atol=ATOL_TRAIN)
    moved = [not np.array_equal(np.asarray(a), b)
             for a, b in zip(g, jx.jax.tree.leaves(jp))]
    assert any(moved)
    _assert_bitwise(jx, got["params"], params_to_jax(t_final))


def test_launch_train_writes_checkpoint_jax_reads(jx, tmp_path, capsys):
    from repro_torch.launch import train as launch
    path = str(tmp_path / "lm.msgpack")
    launch.main(["--reduced", "--device", "cpu", "--steps", "1", "--batch",
                 "2", "--seq", "16", "--checkpoint", path])
    got = jx.ck.load_checkpoint(path)
    _, jp = _jax_params(jx, FAMILIES["dense"])
    assert jx.jax.tree.structure(got) == jx.jax.tree.structure(
        {"params": jp})
    assert all(np.isfinite(np.asarray(a, np.float32)).all()
               for a in jx.jax.tree.leaves(got))


@pytest.mark.cuda
def test_checkpoint_round_trip_on_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tcfg = get_config("smollm-360m").reduced()
    params = init_params(torch.Generator("cuda").manual_seed(0), tcfg,
                         "cuda")
    path = str(tmp_path / "card.msgpack")
    save_checkpoint(path, {"params": params_to_jax(params)})
    back = params_from_jax(load_checkpoint(path)["params"])
    for a, b in zip(tree_leaves(back), tree_leaves(params)):
        assert a.device.type == "cuda"
        assert torch.equal(a, b)
