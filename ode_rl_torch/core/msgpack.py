"""The msgpack byte format of ``flax.serialization``, in plain Python.

``flax.serialization.to_bytes`` and ``msgpack_restore`` read and write a
tree of nested maps with string keys whose leaves are arrays, numpy
scalars, ints, floats, strings, bytes and lists. Arrays are msgpack ext
type 1, whose payload is itself the msgpack of ``(shape, dtype name,
C-order bytes)``; numpy scalars are ext type 3 with the same payload.
``dumps`` writes the bytes ``flax.serialization.to_bytes`` writes for
such a tree (map keys in the tree's order, the smallest encoding of each
value, floats as float64), so JAX reads the port's files and the port
reads JAX's: both packages name one ``flownet_params_path``.

Leaves read back as numpy arrays, except ``bfloat16`` arrays, which
numpy has no dtype for: they read back as ``torch.bfloat16`` tensors.
``dumps`` takes numpy arrays and torch tensors (on any device but
``meta``). An ext type other than 1 or 3 raises, and so does an array
above 2**30 bytes, which flax splits into chunks (no FlowNet leaf comes
near it: FlowNet2's largest is 38 MB).
"""

from __future__ import annotations

import struct
from typing import Any, Mapping

import numpy as np
import torch

_EXT_NDARRAY = 1
_EXT_NPSCALAR = 3
_MAX_CHUNK_BYTES = 2 ** 30


# ------------------------------- writing ----------------------------------

def _header(out: bytearray, n: int, fix: int, fix_max: int,
            codes: tuple) -> None:
    """A length header: the fix form below ``fix_max``, else the 8-, 16-
    or 32-bit form of ``codes`` (None where the format has no such
    form)."""
    if n < fix_max and fix is not None:
        out.append(fix | n)
        return
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"),
                                (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack: length {n} is too large")


def _pack_int(out: bytearray, x: int) -> None:
    if 0 <= x < 128:
        out.append(x)
    elif -32 <= x < 0:
        out.append(x & 0xFF)
    elif x >= 0:
        for code, fmt, limit in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                                 (0xCE, ">I", 1 << 32),
                                 (0xCF, ">Q", 1 << 64)):
            if x < limit:
                out.append(code)
                out += struct.pack(fmt, x)
                return
        raise OverflowError(f"msgpack: int {x} is too large")
    else:
        for code, fmt, limit in ((0xD0, ">b", 1 << 7), (0xD1, ">h", 1 << 15),
                                 (0xD2, ">i", 1 << 31),
                                 (0xD3, ">q", 1 << 63)):
            if x >= -limit:
                out.append(code)
                out += struct.pack(fmt, x)
                return
        raise OverflowError(f"msgpack: int {x} is too small")


def _array_payload(x) -> bytes:
    """The ext payload of an array: msgpack of (shape, dtype, bytes)."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().contiguous()
        if x.dtype == torch.bfloat16:
            shape, name = tuple(x.shape), "bfloat16"
            data = x.view(torch.int16).numpy().tobytes()
        else:
            arr = x.numpy()
            shape, name, data = arr.shape, arr.dtype.name, arr.tobytes("C")
    else:
        arr = np.asarray(x)
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise ValueError("msgpack: object and structured dtypes are not "
                             "supported")
        shape, name, data = arr.shape, arr.dtype.name, arr.tobytes("C")
    out = bytearray()
    _pack(out, (tuple(shape), name, data))
    return bytes(out)


def _pack_ext(out: bytearray, code: int, payload: bytes) -> None:
    n = len(payload)
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        out.append(fixed[n])
    else:
        _header(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out.append(code)
    out += payload


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return np.asarray(x).nbytes


def _pack(out: bytearray, x: Any) -> None:
    if x is None:
        out.append(0xC0)
    elif isinstance(x, bool):
        out.append(0xC3 if x else 0xC2)
    elif isinstance(x, int):
        _pack_int(out, x)
    elif isinstance(x, float):
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif isinstance(x, str):
        data = x.encode("utf-8")
        _header(out, len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB))
        out += data
    elif isinstance(x, (bytes, bytearray, memoryview)):
        data = bytes(x)
        _header(out, len(data), None, 0, (0xC4, 0xC5, 0xC6))
        out += data
    elif isinstance(x, Mapping):
        _header(out, len(x), 0x80, 16, (None, 0xDE, 0xDF))
        for k, v in x.items():
            if not isinstance(k, str):
                raise TypeError(f"msgpack: map key {k!r} is not a string")
            _pack(out, k)
            _pack(out, v)
    elif isinstance(x, (list, tuple)):
        _header(out, len(x), 0x90, 16, (None, 0xDC, 0xDD))
        for v in x:
            _pack(out, v)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        if _nbytes(x) > _MAX_CHUNK_BYTES:
            raise ValueError(f"msgpack: an array of {_nbytes(x)} bytes; "
                             "flax writes those above 2**30 in chunks")
        _pack_ext(out, _EXT_NDARRAY, _array_payload(x))
    elif isinstance(x, np.generic):
        _pack_ext(out, _EXT_NPSCALAR, _array_payload(np.asarray(x)))
    else:
        raise TypeError(f"msgpack: cannot pack {type(x).__name__}")


def dumps(tree: Any) -> bytes:
    """The msgpack bytes of ``tree``, as ``flax.serialization.to_bytes``
    writes them."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


# ------------------------------- reading ----------------------------------

class _Reader:
    def __init__(self, data: bytes):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack: truncated data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


_SIZED = {  # code -> (kind, length format)
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}
_NUMBERS = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
            0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _array_from(payload: bytes):
    shape, name, data = _read(_Reader(payload))
    shape = tuple(int(n) for n in shape)
    if isinstance(name, bytes):
        name = name.decode()
    if name == "bfloat16":
        if not data:
            return torch.zeros(shape, dtype=torch.bfloat16)
        return torch.frombuffer(bytearray(data), dtype=torch.bfloat16
                                ).reshape(shape)
    return np.frombuffer(bytes(data), dtype=np.dtype(name)).reshape(
        shape).copy()


def _ext(code: int, payload: bytes):
    if code == _EXT_NDARRAY:
        return _array_from(payload)
    if code == _EXT_NPSCALAR:
        arr = _array_from(payload)
        return arr[()] if isinstance(arr, np.ndarray) else arr.reshape(())
    raise ValueError(f"msgpack: ext type {code} is not one flax writes for "
                     "arrays (1) or numpy scalars (3)")


def _read(r: _Reader) -> Any:
    code = r.take(1)[0]
    if code < 0x80:
        return code
    if code >= 0xE0:
        return code - 0x100
    if code < 0x90:
        kind, n = "map", code & 0x0F
    elif code < 0xA0:
        kind, n = "array", code & 0x0F
    elif code < 0xC0:
        kind, n = "str", code & 0x1F
    elif code == 0xC0:
        return None
    elif code in (0xC2, 0xC3):
        return code == 0xC3
    elif code in _NUMBERS:
        return r.unpack(_NUMBERS[code])
    elif code in _FIXEXT:
        kind, n = "ext", _FIXEXT[code]
    elif code in _SIZED:
        kind, fmt = _SIZED[code]
        n = r.unpack(fmt)
    else:
        raise ValueError(f"msgpack: unknown type byte 0x{code:02x}")
    if kind == "map":
        out = {}
        for _ in range(n):
            key = _read(r)
            out[key] = _read(r)
        return out
    if kind == "array":
        return [_read(r) for _ in range(n)]
    if kind == "str":
        return bytes(r.take(n)).decode("utf-8")
    if kind == "bin":
        return bytes(r.take(n))
    code = r.unpack(">b")
    return _ext(code, bytes(r.take(n)))


def loads(data: bytes) -> Any:
    """The tree in msgpack ``data``, as ``flax.serialization.
    msgpack_restore`` reads it."""
    r = _Reader(data)
    tree = _read(r)
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} bytes after the "
                         "tree")
    return tree
