"""Checkpoints in the JAX package's byte format (``repro/train/
checkpoint.py``), written and read without ``msgpack``.

A tree of dicts, lists, tuples, arrays and scalars is encoded as JAX's
``_pack`` encodes it: an array as ``{"__nd__": True, "dtype", "shape",
"data"}`` (numpy's dtype name, C-order bytes), a list or tuple as
``{"__seq__": "list" | "tuple", "items"}``, and the whole as msgpack
with bin types (``codec.py``).  ``save_checkpoint`` sorts every dict's
keys, as JAX's ``jax.tree.map`` rebuilds them before it packs, so the
port and JAX write the same bytes for the same tree.  Arrays are copied
to the host one at a time and streamed to a ``.tmp`` file, which then
replaces ``path``.  ``load_checkpoint`` reads the file into one buffer
and makes each array with ``torch.frombuffer`` over it, then moves it to
``device`` (the card unless the caller asks for the CPU).
"""

from __future__ import annotations

import os

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.train import codec

# numpy's dtype names (JAX's ``str(arr.dtype)``) and torch's dtypes.
DTYPES = {
    "float64": torch.float64, "float32": torch.float32,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
    "int8": torch.int8, "uint64": torch.uint64, "uint32": torch.uint32,
    "uint16": torch.uint16, "uint8": torch.uint8, "bool": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}


class _Array:
    """An array leaf, turned into its host bytes only when it is written."""

    def __init__(self, a):
        self.a = a


def _pack(obj):
    if isinstance(obj, (torch.Tensor, np.ndarray, np.generic)):
        return _Array(obj)
    if isinstance(obj, dict):
        return {k: _pack(obj[k]) for k in sorted(obj)}
    if isinstance(obj, (list, tuple)):
        return {"__seq__": type(obj).__name__,
                "items": [_pack(v) for v in obj]}
    return obj


def _fields(leaf: _Array) -> dict:
    a = leaf.a
    if isinstance(a, torch.Tensor):
        t = a.detach().to("cpu").contiguous()
        if t.dtype not in _NAMES:
            raise TypeError(f"no checkpoint dtype for {t.dtype}")
        name, shape = _NAMES[t.dtype], list(t.shape)
        data = t.reshape(-1).view(torch.uint8).numpy()
    else:
        arr = np.asarray(a)
        if not arr.flags.c_contiguous:
            arr = arr.copy(order="C")
        name, shape = str(arr.dtype), list(arr.shape)
        data = arr.reshape(-1).view(np.uint8)
    return {"__nd__": True, "dtype": name, "shape": shape,
            "data": memoryview(data)}


def _default(obj):
    if isinstance(obj, _Array):
        return _fields(obj)
    raise TypeError(f"can not checkpoint {type(obj).__name__!r} object")


def save_checkpoint(path: str, tree) -> None:
    """Write ``tree`` to ``path`` in JAX's format, through ``path +
    ".tmp"`` and ``os.replace``.  An array over 4 GiB raises ValueError
    (msgpack's bin32 limit) and leaves ``path`` as it was."""
    tmp = path + ".tmp"
    try:
        with open(tmp, "wb") as f:
            codec.pack(_pack(tree), f.write, _default)
    except BaseException:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
    os.replace(tmp, path)


def _unpack(obj, device: torch.device):
    if isinstance(obj, dict):
        if obj.get("__nd__"):
            dtype, shape = DTYPES[obj["dtype"]], obj["shape"]
            if obj["data"].nbytes == 0:
                return torch.empty(shape, dtype=dtype, device=device)
            t = torch.frombuffer(obj["data"], dtype=dtype).reshape(shape)
            # A CPU tensor gets its own storage; the card's copy is one.
            return t.clone() if device.type == "cpu" else t.to(device)
        if "__seq__" in obj:
            items = [_unpack(v, device) for v in obj["items"]]
            return tuple(items) if obj["__seq__"] == "tuple" else items
        return {k: _unpack(v, device) for k, v in obj.items()}
    return obj


def load_checkpoint(path: str, device=None):
    """The tree saved at ``path`` (by the port or by JAX), its arrays as
    torch tensors on ``device`` (``None``: the card, or an error when
    there is none; pass ``"cpu"`` for the host)."""
    device = resolve_device(device)
    with open(path, "rb") as f:
        buf = bytearray(os.fstat(f.fileno()).st_size)
        view, got = memoryview(buf), 0
        while got < len(buf):
            n = f.readinto(view[got:])
            if not n:
                raise ValueError(f"{path}: short read at byte {got}")
            got += n
    return _unpack(codec.unpackb(buf), device)
