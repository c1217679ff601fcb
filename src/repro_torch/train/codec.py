"""A hand-written msgpack codec for the checkpoint format.

It covers the part of msgpack that the checkpoint trees use: nil, bool,
integers of every width, float64 (and float32 on read), str, bin 8/16/32,
and array and map in their fix, 16 and 32 forms.  For the same object
``pack`` writes exactly the bytes of msgpack-python's
``packb(obj, use_bin_type=True)``: the smallest integer encoding, Python
floats as float64, tuples as arrays, and dicts in insertion order.  The
port cannot import ``msgpack`` (the machine with the card lacks it).

``pack`` writes through a callable, so a payload (``bytes``,
``bytearray`` or ``memoryview``) goes to a file as it is, without one
bytes object for the whole tree.  ``unpackb`` returns every bin as a
``memoryview`` into the buffer it was given (no copy).
"""

from __future__ import annotations

import struct
from typing import Callable, Optional

# The largest length that a str, bin, array or map header can carry.
MAX_LEN = 2**32 - 1

_UINTS = ((0xcc, ">B", 2**8 - 1), (0xcd, ">H", 2**16 - 1),
          (0xce, ">I", 2**32 - 1), (0xcf, ">Q", 2**64 - 1))
_INTS = ((0xd0, ">b", -2**7), (0xd1, ">h", -2**15),
         (0xd2, ">i", -2**31), (0xd3, ">q", -2**63))
# (fix code, fix limit, ((code, format, max), ...)) of each sized type.
_STR = (0xa0, 32, ((0xd9, ">B", 2**8 - 1), (0xda, ">H", 2**16 - 1),
                   (0xdb, ">I", MAX_LEN)))
_BIN = (None, 0, ((0xc4, ">B", 2**8 - 1), (0xc5, ">H", 2**16 - 1),
                  (0xc6, ">I", MAX_LEN)))
_ARRAY = (0x90, 16, ((0xdc, ">H", 2**16 - 1), (0xdd, ">I", MAX_LEN)))
_MAP = (0x80, 16, ((0xde, ">H", 2**16 - 1), (0xdf, ">I", MAX_LEN)))


def _int(v: int) -> bytes:
    if 0 <= v < 128:
        return bytes((v,))
    if -32 <= v < 0:
        return bytes((v & 0xff,))
    if v > 0:
        for code, fmt, hi in _UINTS:
            if v <= hi:
                return bytes((code,)) + struct.pack(fmt, v)
    else:
        for code, fmt, lo in _INTS:
            if v >= lo:
                return bytes((code,)) + struct.pack(fmt, v)
    raise OverflowError("Integer value out of range")


def _head(kind, n: int, what: str) -> bytes:
    fix, fix_n, sized = kind
    if n < fix_n:
        return bytes((fix | n,))
    for code, fmt, hi in sized:
        if n <= hi:
            return bytes((code,)) + struct.pack(fmt, n)
    raise ValueError(f"a {what} of {n:,} is over msgpack's 32-bit length "
                     f"limit ({MAX_LEN:,}; for bin, 4 GiB)")


def pack(obj, write: Callable, default: Optional[Callable] = None) -> None:
    """Write ``obj``'s msgpack bytes through ``write``.  ``default(obj)``
    replaces an object of another type by one that packs (as in
    msgpack-python); without it such an object raises TypeError."""
    if obj is None:
        write(b"\xc0")
    elif obj is True or obj is False:
        write(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):
        write(_int(obj))
    elif isinstance(obj, float):
        write(b"\xcb" + struct.pack(">d", obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        write(_head(_STR, len(data), "str of bytes") + data)
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        n = obj.nbytes if isinstance(obj, memoryview) else len(obj)
        if n > MAX_LEN:
            raise ValueError(f"an array of {n:,} bytes is over msgpack's "
                             f"bin32 limit of 4 GiB ({MAX_LEN:,} bytes)")
        write(_head(_BIN, n, "bin"))
        write(obj)
    elif isinstance(obj, dict):
        write(_head(_MAP, len(obj), "map of entries"))
        for k, v in obj.items():
            pack(k, write, default)
            pack(v, write, default)
    elif isinstance(obj, (list, tuple)):
        write(_head(_ARRAY, len(obj), "array of items"))
        for v in obj:
            pack(v, write, default)
    elif default is not None:
        pack(default(obj), write, default)
    else:
        raise TypeError(f"can not serialize {type(obj).__name__!r} object")


def packb(obj, default: Optional[Callable] = None) -> bytes:
    """``obj``'s msgpack bytes as one bytes object."""
    parts = []
    pack(obj, parts.append, default)
    return b"".join(parts)


def unpackb(buf):
    """The object that the msgpack bytes in ``buf`` (any buffer) encode;
    bins come back as ``memoryview`` slices of ``buf``."""
    mv = memoryview(buf).cast("B")
    obj, pos = _read(mv, 0)
    if pos != len(mv):
        raise ValueError(f"extra data: {len(mv) - pos} bytes after the "
                         "object")
    return obj


def _unpack_from(fmt: str, mv: memoryview, pos: int):
    return struct.unpack_from(fmt, mv, pos)[0], pos + struct.calcsize(fmt)


_SIZED = {  # code -> (kind, length format)
    0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
    0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
    0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
    0xde: ("map", ">H"), 0xdf: ("map", ">I"),
}
_NUMBERS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
            0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}


def _read(mv: memoryview, pos: int):
    if pos >= len(mv):
        raise ValueError("truncated msgpack data")
    code = mv[pos]
    pos += 1
    if code < 0x80:
        return code, pos
    if code >= 0xe0:
        return code - 0x100, pos
    if code == 0xc0:
        return None, pos
    if code in (0xc2, 0xc3):
        return code == 0xc3, pos
    if code in _NUMBERS:
        return _unpack_from(_NUMBERS[code], mv, pos)
    if code <= 0x8f:
        kind, n = "map", code & 0x0f
    elif code <= 0x9f:
        kind, n = "array", code & 0x0f
    elif code <= 0xbf:
        kind, n = "str", code & 0x1f
    elif code in _SIZED:
        kind, fmt = _SIZED[code]
        n, pos = _unpack_from(fmt, mv, pos)
    else:
        raise ValueError(f"msgpack type 0x{code:02x} is not in the subset "
                         "that checkpoints use")
    if kind in ("bin", "str"):
        if pos + n > len(mv):
            raise ValueError("truncated msgpack data")
        data = mv[pos:pos + n]
        return (data if kind == "bin" else str(data, "utf-8")), pos + n
    if kind == "array":
        items = []
        for _ in range(n):
            v, pos = _read(mv, pos)
            items.append(v)
        return items, pos
    out = {}
    for _ in range(n):
        k, pos = _read(mv, pos)
        v, pos = _read(mv, pos)
        out[k] = v
    return out, pos
