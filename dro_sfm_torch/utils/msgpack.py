"""The msgpack subset that flax writes, read and written without flax or msgpack.

The JAX package stores checkpoints and converted weights with
``flax.serialization.msgpack_serialize``: plain msgpack (nil, bool, ints,
floats, str, bin, array, map) plus flax's extension types

* ext 1, an ndarray: the msgpack of ``(shape, dtype name, C-order bytes)``;
* ext 3, a numpy scalar, encoded as a 0-d ndarray;
* ext 2, a Python complex (refused here: no tree of this project holds one);

and, for leaves over ``MAX_CHUNK_SIZE`` bytes, a map with
``__msgpack_chunked_array__``, ``shape`` and ``chunks`` (each a
``{"0": ..., "1": ...}`` map). Tuples reach the file as ``{"0": ...}`` maps
(flax's ``to_state_dict``) and come back as such.

`unpackb` returns dicts, lists, Python scalars and numpy arrays; a
``bfloat16`` leaf (numpy has no such dtype) is read as uint16 and returned
as a ``torch.bfloat16`` tensor. `packb` writes the same bytes as
``flax.serialization.msgpack_serialize`` for a tree of dicts, lists, Python
scalars, numpy arrays and numpy scalars.
"""
from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30          # flax.serialization.MAX_CHUNK_SIZE
CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class MsgpackError(ValueError):
    """The bytes are not msgpack of the subset that flax writes."""


# -- reading -----------------------------------------------------------------

def unpackb(data: bytes) -> Any:
    """Decode one msgpack object that fills ``data``."""
    buf = memoryview(data)
    obj, pos = _read(buf, 0)
    if pos != len(buf):
        raise MsgpackError(f"{len(buf) - pos} bytes after the msgpack object")
    return obj


def _take(buf: memoryview, pos: int, n: int) -> Tuple[memoryview, int]:
    end = pos + n
    if end > len(buf):
        raise MsgpackError(f"truncated msgpack: {n} bytes wanted at {pos}, "
                           f"{len(buf) - pos} left")
    return buf[pos:end], end


def _unpack(fmt: str, buf: memoryview, pos: int):
    raw, pos = _take(buf, pos, struct.calcsize(fmt))
    return struct.unpack(fmt, raw)[0], pos


def _read(buf: memoryview, pos: int) -> Tuple[Any, int]:
    if pos >= len(buf):
        raise MsgpackError(f"truncated msgpack: an object wanted at {pos}")
    b = buf[pos]
    pos += 1
    if b <= 0x7F:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0x80 <= b <= 0x8F:
        return _read_map(buf, pos, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return _read_array(buf, pos, b & 0x0F)
    if 0xA0 <= b <= 0xBF:
        return _read_str(buf, pos, b & 0x1F)
    if b == 0xC0:
        return None, pos
    if b in (0xC2, 0xC3):
        return b == 0xC3, pos
    if b in (0xC4, 0xC5, 0xC6):
        n, pos = _unpack((">B", ">H", ">I")[b - 0xC4], buf, pos)
        raw, pos = _take(buf, pos, n)
        return bytes(raw), pos
    if b in (0xC7, 0xC8, 0xC9):
        n, pos = _unpack((">B", ">H", ">I")[b - 0xC7], buf, pos)
        return _read_ext(buf, pos, n)
    if b in (0xCA, 0xCB):
        return _unpack(">f" if b == 0xCA else ">d", buf, pos)
    if 0xCC <= b <= 0xD3:
        return _unpack((">B", ">H", ">I", ">Q", ">b", ">h", ">i", ">q")[b - 0xCC], buf, pos)
    if 0xD4 <= b <= 0xD8:
        return _read_ext(buf, pos, 1 << (b - 0xD4))
    if b in (0xD9, 0xDA, 0xDB):
        n, pos = _unpack((">B", ">H", ">I")[b - 0xD9], buf, pos)
        return _read_str(buf, pos, n)
    if b in (0xDC, 0xDD):
        n, pos = _unpack(">H" if b == 0xDC else ">I", buf, pos)
        return _read_array(buf, pos, n)
    if b in (0xDE, 0xDF):
        n, pos = _unpack(">H" if b == 0xDE else ">I", buf, pos)
        return _read_map(buf, pos, n)
    raise MsgpackError(f"byte 0x{b:02x} at {pos - 1} starts no msgpack object")


def _read_str(buf, pos, n):
    raw, pos = _take(buf, pos, n)
    return bytes(raw).decode("utf-8"), pos


def _read_array(buf, pos, n):
    out = []
    for _ in range(n):
        item, pos = _read(buf, pos)
        out.append(item)
    return out, pos


def _read_map(buf, pos, n):
    out = {}
    for _ in range(n):
        key, pos = _read(buf, pos)
        out[key], pos = _read(buf, pos)
    if CHUNKED in out:
        return _unchunk(out), pos
    return out, pos


def _unchunk(d):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if any(isinstance(c, torch.Tensor) for c in chunks):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _read_ext(buf, pos, n):
    code, pos = _unpack(">b", buf, pos)
    raw, pos = _take(buf, pos, n)
    if code == _EXT_NDARRAY:
        return _ndarray(raw), pos
    if code == _EXT_NPSCALAR:
        arr = _ndarray(raw)
        return (arr.reshape(()) if isinstance(arr, torch.Tensor) else arr[()]), pos
    if code == _EXT_COMPLEX:
        raise MsgpackError("a complex leaf (flax ext type 2): no tree of this "
                           "project holds one, and the port does not read it")
    raise MsgpackError(f"unknown msgpack ext type {code}")


def _ndarray(raw: memoryview):
    """flax ext 1: ``(shape, dtype name, C-order bytes)``."""
    parts = unpackb(raw)
    if not (isinstance(parts, list) and len(parts) == 3):
        raise MsgpackError("an ndarray extension that is not (shape, dtype, bytes)")
    shape, name, data = parts
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        arr = np.frombuffer(data, dtype="<u2").reshape(shape).copy()
        return torch.from_numpy(arr).view(torch.bfloat16)
    dtype = np.dtype(name)
    if dtype.hasobject or dtype.fields is not None:
        raise MsgpackError(f"ndarray of dtype {name}: not a plain numeric type")
    return np.frombuffer(data, dtype=dtype).reshape(shape).copy()


# -- writing -----------------------------------------------------------------

def packb(tree: Any) -> bytes:
    """``flax.serialization.msgpack_serialize(tree)``'s bytes. As there, every
    map's keys are sorted (flax copies the tree with ``jax.tree_util``, which
    sorts them), then array leaves of maps (and a bare array) over
    `MAX_CHUNK_SIZE` bytes are chunked."""
    out = bytearray()
    _write(out, _chunked(_sorted(tree)))
    return bytes(out)


def _sorted(x):
    if type(x) is dict:
        return {k: _sorted(x[k]) for k in sorted(x)}
    if type(x) is list:
        return [_sorted(v) for v in x]
    return x


def _chunked(x):
    if type(x) is dict:
        return {k: _chunked(v) for k, v in x.items()}
    if isinstance(x, np.ndarray) and x.nbytes > MAX_CHUNK_SIZE:
        size = max(1, int(MAX_CHUNK_SIZE / x.dtype.itemsize))
        flat = x.reshape(-1)
        return {CHUNKED: True,
                "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
                "chunks": {str(j): flat[i:i + size]
                           for j, i in enumerate(range(0, flat.size, size))}}
    return x


def _header(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    if n <= fix_max and fix is not None:
        out.append(fix | n)
    elif n <= 0xFF and codes[0] is not None:
        out += struct.pack(">BB", codes[0], n)
    elif n <= 0xFFFF:
        out += struct.pack(">BH", codes[1], n)
    elif n <= 0xFFFFFFFF:
        out += struct.pack(">BI", codes[2], n)
    else:
        raise MsgpackError(f"{n} elements or bytes exceed msgpack's 32-bit lengths")


def _write_int(out: bytearray, v: int) -> None:
    if 0 <= v <= 0x7F or -32 <= v < 0:
        out += struct.pack(">b" if v < 0 else ">B", v)
    elif v > 0:
        for code, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2 ** 64 - 1)):
            if v <= top:
                out += struct.pack(">B", code) + struct.pack(fmt, v)
                return
        raise MsgpackError(f"integer {v} exceeds 64 bits")
    else:
        for code, fmt, low in ((0xD0, ">b", -2 ** 7), (0xD1, ">h", -2 ** 15),
                               (0xD2, ">i", -2 ** 31), (0xD3, ">q", -2 ** 63)):
            if v >= low:
                out += struct.pack(">B", code) + struct.pack(fmt, v)
                return
        raise MsgpackError(f"integer {v} exceeds 64 bits")


def _write(out: bytearray, x) -> None:
    # Exact types, as flax packs with ``strict_types=True``.
    t = type(x)
    if x is None:
        out.append(0xC0)
    elif t is bool:
        out.append(0xC3 if x else 0xC2)
    elif t is int:
        _write_int(out, x)
    elif t is float:
        out += struct.pack(">Bd", 0xCB, x)
    elif t is str:
        raw = x.encode("utf-8")
        _header(out, len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += raw
    elif t is bytes:
        _header(out, len(x), None, -1, (0xC4, 0xC5, 0xC6))
        out += x
    elif t is list:
        _header(out, len(x), 0x90, 15, (None, 0xDC, 0xDD))
        for item in x:
            _write(out, item)
    elif t is dict:
        _header(out, len(x), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in x.items():
            _write(out, k)
            _write(out, v)
    elif isinstance(x, np.ndarray):
        _write_ext(out, _EXT_NDARRAY, _ndarray_bytes(x))
    elif isinstance(x, np.generic):
        _write_ext(out, _EXT_NPSCALAR, _ndarray_bytes(np.asarray(x)))
    else:
        raise TypeError(f"cannot msgpack a {t.__name__} (flax's subset: dicts, "
                        "lists, Python scalars, str, bytes, arrays)")


def _ndarray_bytes(x: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: the shape, the dtype's name and the
    C-order bytes, packed as an array of three."""
    if x.dtype.hasobject or x.dtype.fields is not None:
        raise TypeError(f"cannot msgpack an ndarray of dtype {x.dtype}")
    out = bytearray()
    _header(out, 3, 0x90, 15, (None, 0xDC, 0xDD))
    _header(out, len(x.shape), 0x90, 15, (None, 0xDC, 0xDD))
    for d in x.shape:
        _write_int(out, int(d))
    _write(out, x.dtype.name)
    _write(out, np.ascontiguousarray(x).tobytes())
    return bytes(out)


def _write_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _header(out, n, None, -1, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code)
    out += data
