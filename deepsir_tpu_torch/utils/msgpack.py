"""A msgpack decoder, enough for flax's `msgpack_restore` checkpoints.

The machine with the card has no `msgpack` package, so the port reads flax
checkpoints (deepsir_tpu/utils/checkpoint.py) with this pure-Python decoder.
It covers nil, bool, every int and float width, str, bin, array and map, and
msgpack ext type 1, flax's ndarray: its payload is itself msgpack
`[shape, dtype name, raw bytes]` and decodes to a numpy array in the byte
order flax wrote (native). Any other ext type raises, naming its code.

Headers are big-endian, as msgpack defines them. Array payloads are sliced
out of the buffer, never looped over, and a decoded array owns its memory.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np

NDARRAY_EXT = 1                      # flax serialization._MsgpackExtType.ndarray

# fixed-width headers: type byte -> (struct format, byte count)
_SCALARS = {
    0xca: (">f", 4), 0xcb: (">d", 8),
    0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
    0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8),
}
# length-prefixed types: type byte -> (kind, length format, length bytes)
_SIZED = {
    0xc4: ("bin", ">B", 1), 0xc5: ("bin", ">H", 2), 0xc6: ("bin", ">I", 4),
    0xc7: ("ext", ">B", 1), 0xc8: ("ext", ">H", 2), 0xc9: ("ext", ">I", 4),
    0xd9: ("str", ">B", 1), 0xda: ("str", ">H", 2), 0xdb: ("str", ">I", 4),
    0xdc: ("array", ">H", 2), 0xdd: ("array", ">I", 4),
    0xde: ("map", ">H", 2), 0xdf: ("map", ">I", 4),
}
# fixext: type byte -> payload bytes
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


def _ext(code: int, payload: memoryview) -> np.ndarray:
    """Flax's ndarray ext payload -> a numpy array that owns its memory."""
    if code != NDARRAY_EXT:
        raise ValueError(f"msgpack ext type {code} is not supported (only type "
                         f"{NDARRAY_EXT}, flax's ndarray)")
    shape, dtype_name, raw = unpackb(payload)
    arr = np.frombuffer(raw, dtype=np.dtype(dtype_name))
    return arr.reshape(tuple(shape)).copy()


def unpackb(data) -> Any:
    """Decode one msgpack object that fills `data` (bytes or a memoryview).

    Maps become dicts, arrays lists, str str and bin bytes; ext type 1
    becomes a numpy array.
    """
    view = memoryview(data).cast("B")
    obj, end = _decode(view, 0)
    if end != len(view):
        raise ValueError(f"msgpack: {len(view) - end} bytes after the object")
    return obj


def _take(view: memoryview, pos: int, n: int) -> memoryview:
    if pos + n > len(view):
        raise ValueError(f"msgpack: truncated at byte {pos} (needs {n} more)")
    return view[pos:pos + n]


def _decode(view: memoryview, pos: int) -> Tuple[Any, int]:
    """(object starting at `pos`, position after it)."""
    t = _take(view, pos, 1)[0]
    pos += 1
    if t <= 0x7f:                                    # positive fixint
        return t, pos
    if t >= 0xe0:                                    # negative fixint
        return t - 0x100, pos
    if 0x80 <= t <= 0x8f:
        return _container("map", t & 0x0f, view, pos)
    if 0x90 <= t <= 0x9f:
        return _container("array", t & 0x0f, view, pos)
    if 0xa0 <= t <= 0xbf:
        n = t & 0x1f
        return str(_take(view, pos, n), "utf-8"), pos + n
    if t == 0xc0:
        return None, pos
    if t in (0xc2, 0xc3):
        return t == 0xc3, pos
    if t in _SCALARS:
        fmt, n = _SCALARS[t]
        return struct.unpack(fmt, _take(view, pos, n))[0], pos + n
    if t in _FIXEXT:
        n = _FIXEXT[t]
        code = struct.unpack(">b", _take(view, pos, 1))[0]
        return _ext(code, _take(view, pos + 1, n)), pos + 1 + n
    if t in _SIZED:
        kind, fmt, w = _SIZED[t]
        n = struct.unpack(fmt, _take(view, pos, w))[0]
        pos += w
        if kind == "bin":
            return bytes(_take(view, pos, n)), pos + n
        if kind == "str":
            return str(_take(view, pos, n), "utf-8"), pos + n
        if kind == "ext":
            code = struct.unpack(">b", _take(view, pos, 1))[0]
            return _ext(code, _take(view, pos + 1, n)), pos + 1 + n
        return _container(kind, n, view, pos)
    raise ValueError(f"msgpack: type byte 0x{t:02x} at byte {pos - 1} is not valid")


def _container(kind: str, n: int, view: memoryview, pos: int) -> Tuple[Any, int]:
    if kind == "array":
        items = []
        for _ in range(n):
            item, pos = _decode(view, pos)
            items.append(item)
        return items, pos
    out: Dict[Any, Any] = {}
    for _ in range(n):
        key, pos = _decode(view, pos)
        out[key], pos = _decode(view, pos)
    return out, pos
