"""A decoder for the msgpack that ``flax.serialization.to_bytes`` writes,
so the port reads the JAX package's ``checkpoint.msgpack`` without the
``msgpack`` package (which the card's machine may lack).

flax writes a state dict: maps with string keys, ``None``, Python scalars
and two extension types of its own (``flax/serialization.py:
_MsgpackExtType``): ext 1, an ndarray, and ext 3, a numpy scalar. Each
payload is itself msgpack, the triple ``(shape, dtype name, C-order
bytes)`` (``_ndarray_to_bytes``). :func:`loads` decodes every msgpack type
and those two extensions, and refuses what no checkpoint of this repo
holds: ext 2 (a complex number), any other extension, flax's chunked form
of an array over ``2**30`` bytes, and a dtype outside ``DTYPES`` (flax
keeps parameters and optimizer moments in float32 whatever the compute
dtype).
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

EXT_NDARRAY = 1
EXT_COMPLEX = 2
EXT_NPSCALAR = 3
CHUNKED_MARKER = "__msgpack_chunked_array__"
DTYPES = ("float32", "float64", "int32", "int64", "uint32", "bool")

# fixed-width scalars: first byte -> struct format
_SCALARS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I",
            0xcf: ">Q", 0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
# str, bin, array, map and ext with a length field: first byte ->
# (kind, length format)
_SIZED = {0xd9: ("str", ">B"), 0xda: ("str", ">H"), 0xdb: ("str", ">I"),
          0xc4: ("bin", ">B"), 0xc5: ("bin", ">H"), 0xc6: ("bin", ">I"),
          0xdc: ("array", ">H"), 0xdd: ("array", ">I"),
          0xde: ("map", ">H"), 0xdf: ("map", ">I"),
          0xc7: ("ext", ">B"), 0xc8: ("ext", ">H"), 0xc9: ("ext", ">I")}
# fixext 1, 2, 4, 8, 16
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    def __init__(self, blob):
        self.buf = memoryview(blob)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"msgpack: truncated at byte {self.pos} "
                             f"(wants {n} of {len(self.buf) - self.pos})")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _ndarray(payload: memoryview) -> np.ndarray:
    """Ext 1's payload: msgpack ``(shape, dtype name, C-order bytes)``."""
    triple = _value(_Reader(payload))
    if not (isinstance(triple, list) and len(triple) == 3):
        raise ValueError(f"msgpack: an ndarray payload is {triple!r}")
    shape, name, data = triple
    if name not in DTYPES:
        raise ValueError(f"msgpack: an array of dtype {name!r}; the port "
                         f"reads {', '.join(DTYPES)}")
    return np.frombuffer(data, dtype=np.dtype(name)).reshape(shape).copy()


def _ext(code: int, payload: memoryview):
    if code == EXT_NDARRAY:
        return _ndarray(payload)
    if code == EXT_NPSCALAR:
        return _ndarray(payload)[()]
    if code == EXT_COMPLEX:
        raise ValueError("msgpack: a complex number (flax ext 2); no "
                         "checkpoint of this repo holds one")
    raise ValueError(f"msgpack: extension type {code}, which flax does not "
                     "write")


def _value(r: _Reader) -> Any:
    b = r.take(1)[0]
    if b <= 0x7f:
        return b
    if b >= 0xe0:
        return b - 0x100
    if 0x80 <= b <= 0x8f:
        return _map(r, b & 0x0f)
    if 0x90 <= b <= 0x9f:
        return [_value(r) for _ in range(b & 0x0f)]
    if 0xa0 <= b <= 0xbf:
        return str(r.take(b & 0x1f), "utf-8")
    if b == 0xc0:
        return None
    if b in (0xc2, 0xc3):
        return b == 0xc3
    if b in _SCALARS:
        return r.unpack(_SCALARS[b])
    if b in _FIXEXT:
        code = r.unpack(">b")
        return _ext(code, r.take(_FIXEXT[b]))
    if b in _SIZED:
        kind, fmt = _SIZED[b]
        n = r.unpack(fmt)
        if kind == "str":
            return str(r.take(n), "utf-8")
        if kind == "bin":
            return r.take(n).tobytes()
        if kind == "array":
            return [_value(r) for _ in range(n)]
        if kind == "map":
            return _map(r, n)
        code = r.unpack(">b")
        return _ext(code, r.take(n))
    raise ValueError(f"msgpack: byte 0x{b:02x} at {r.pos - 1} starts no "
                     "value")


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        key = _value(r)
        out[key] = _value(r)
    if CHUNKED_MARKER in out:
        raise ValueError("msgpack: a chunked array (flax splits arrays over "
                         "2**30 bytes); no checkpoint of this repo holds one")
    return out


def loads(blob) -> Any:
    """Decode ``flax.serialization.to_bytes`` output: maps become dicts,
    arrays lists, ``bin`` values ``bytes``, ext 1 numpy arrays (writable,
    owning their memory) and ext 3 numpy scalars, as
    ``flax.serialization.msgpack_restore`` returns them.

    :raises ValueError: for bytes outside that subset (see the module
        docstring) or trailing bytes.
    """
    r = _Reader(blob)
    out = _value(r)
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} bytes after the "
                         "value")
    return out
