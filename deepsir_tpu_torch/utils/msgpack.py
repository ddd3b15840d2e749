"""A msgpack decoder and encoder, enough for flax's checkpoints.

The machine with the card has no `msgpack` package, so the port reads and
writes flax checkpoints (deepsir_tpu/utils/checkpoint.py) with this
pure-Python code. `packb` writes what flax's `msgpack_serialize` writes for
a tree of dicts and numpy arrays, byte for byte: each value in msgpack's
smallest form, an array as ext type 1.
It covers nil, bool, every int and float width, str, bin, array and map, and
msgpack ext type 1, flax's ndarray: its payload is itself msgpack
`[shape, dtype name, raw bytes]` and decodes to a numpy array in the byte
order flax wrote (native). Any other ext type raises, naming its code.

Headers are big-endian, as msgpack defines them. Array payloads are sliced
out of the buffer, never looped over, and a decoded array owns its memory.
"""
from __future__ import annotations

import struct
from typing import Any, Dict, Mapping, Tuple

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


def _header(out: bytearray, n: int, fix: int, fix_max: int, wide) -> None:
    """A length header: `fix | n` up to fix_max, else the first of `wide`
    ((type byte, format, limit), ...) whose limit holds n."""
    if n <= fix_max:
        out.append(fix | n)
        return
    for byte, fmt, limit in wide:
        if n <= limit:
            out.append(byte)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: length {n} is too large")


_U8, _U16, _U32 = 0xff, 0xffff, 0xffffffff
_STR = ((0xd9, ">B", _U8), (0xda, ">H", _U16), (0xdb, ">I", _U32))
_ARRAY = ((0xdc, ">H", _U16), (0xdd, ">I", _U32))
_MAP = ((0xde, ">H", _U16), (0xdf, ">I", _U32))
_BIN = ((0xc4, ">B", _U8), (0xc5, ">H", _U16), (0xc6, ">I", _U32))
_EXT = ((0xc7, ">B", _U8), (0xc8, ">H", _U16), (0xc9, ">I", _U32))
_FIXEXT_BYTE = {n: t for t, n in _FIXEXT.items()}


def _encode_int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7f or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
        return
    kinds = ((0xcc, ">B", 0, _U8), (0xcd, ">H", 0, _U16), (0xce, ">I", 0, _U32),
             (0xcf, ">Q", 0, 2 ** 64 - 1)) if v >= 0 else \
        ((0xd0, ">b", -2 ** 7, 0), (0xd1, ">h", -2 ** 15, 0), (0xd2, ">i", -2 ** 31, 0),
         (0xd3, ">q", -2 ** 63, 0))
    for byte, fmt, lo, hi in kinds:
        if lo <= v <= hi:
            out.append(byte)
            out += struct.pack(fmt, v)
            return
    raise ValueError(f"msgpack: integer {v} does not fit 64 bits")


def _encode(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xc0)
    elif isinstance(obj, bool):
        out.append(0xc3 if obj else 0xc2)
    elif isinstance(obj, int):
        _encode_int(out, obj)
    elif isinstance(obj, float):
        out.append(0xcb)
        out += struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _header(out, len(raw), 0xa0, 31, _STR)
        out += raw
    elif isinstance(obj, (bytes, bytearray)):
        _header(out, len(obj), 0, -1, _BIN)
        out += obj
    elif isinstance(obj, (np.ndarray, np.generic)):
        arr = np.asarray(obj)
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise ValueError(f"msgpack: arrays of dtype {arr.dtype} are not supported")
        payload = packb([list(arr.shape), arr.dtype.name, arr.tobytes("C")])
        n = len(payload)
        if n in _FIXEXT_BYTE:
            out.append(_FIXEXT_BYTE[n])
        else:
            _header(out, n, 0, -1, _EXT)
        out += struct.pack(">b", NDARRAY_EXT)
        out += payload
    elif isinstance(obj, Mapping):
        _header(out, len(obj), 0x80, 15, _MAP)
        for key, value in obj.items():
            _encode(key, out)
            _encode(value, out)
    elif isinstance(obj, (list, tuple)):
        _header(out, len(obj), 0x90, 15, _ARRAY)
        for item in obj:
            _encode(item, out)
    else:
        raise TypeError(f"msgpack: cannot encode {type(obj).__name__}")


def packb(obj: Any) -> bytes:
    """Encode `obj`: None, bool, int, float, str, bytes, lists and tuples (as
    arrays), mappings (in their order), and numpy arrays (0-d and numpy
    scalars too) as flax's ndarray ext type 1 `[shape, dtype name, C-order
    bytes]`. Other types raise TypeError."""
    out = bytearray()
    _encode(obj, out)
    return bytes(out)
