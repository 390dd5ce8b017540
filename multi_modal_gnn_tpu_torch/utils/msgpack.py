"""A reader of the msgpack that ``flax.serialization.to_bytes`` writes, in
pure Python.

The JAX package saves a checkpoint as ``flax.serialization.to_bytes`` of its
state (``multi_modal_gnn_tpu/training/checkpoint.py``): msgpack maps, arrays,
strings, binary, integers, floats, nil and booleans, and flax's extension
types for numpy arrays (code 1) and numpy scalars (code 3), each an inner
msgpack triple ``(shape, dtype name, C-order bytes)``.  Arrays above 1 GiB
are split into ``__msgpack_chunked_array__`` maps.  The card's machine has
neither ``msgpack`` nor ``flax``, so the port decodes that subset here.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, NamedTuple, Optional

import numpy as np

FLAX_NDARRAY, FLAX_NPSCALAR = 1, 3


class ExtType(NamedTuple):
    """An extension value left undecoded (``msgpack.ExtType``'s fields)."""

    code: int
    data: bytes


_FIXED = {  # marker: (struct format, byte count)
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    def __init__(self, data: bytes, raw: bool, ext_hook: Optional[Callable]):
        self.data = memoryview(data)
        self.pos = 0
        self.raw = raw
        self.ext_hook = ext_hook

    def take(self, n: int) -> bytes:
        end = self.pos + n
        if end > len(self.data):
            raise ValueError("msgpack data ends inside a value")
        out = self.data[self.pos : end].tobytes()
        self.pos = end
        return out

    def uint(self, width: int) -> int:
        return struct.unpack(_LEN[width], self.take(width))[0]

    def string(self, n: int):
        b = self.take(n)
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = struct.unpack(">b", self.take(1))[0]
        data = self.take(n)
        return self.ext_hook(code, data) if self.ext_hook else ExtType(code, data)

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            if not isinstance(key, (str, bytes)):
                raise ValueError(f"msgpack map key of type {type(key).__name__}")
            out[key] = self.value()
        return out

    def value(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if b <= 0x8F:
            return self.map(b & 0x0F)
        if b <= 0x9F:
            return self.array(b & 0x0F)
        if b <= 0xBF:
            return self.string(b & 0x1F)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _FIXED:
            fmt, n = _FIXED[b]
            return struct.unpack(fmt, self.take(n))[0]
        if 0xC4 <= b <= 0xC6:  # bin 8 / 16 / 32
            return self.take(self.uint(1 << (b - 0xC4)))
        if 0xC7 <= b <= 0xC9:  # ext 8 / 16 / 32
            return self.ext(self.uint(1 << (b - 0xC7)))
        if 0xD4 <= b <= 0xD8:  # fixext 1 / 2 / 4 / 8 / 16
            return self.ext(1 << (b - 0xD4))
        if 0xD9 <= b <= 0xDB:  # str 8 / 16 / 32
            return self.string(self.uint(1 << (b - 0xD9)))
        if b in (0xDC, 0xDD):
            return self.array(self.uint(2 if b == 0xDC else 4))
        if b in (0xDE, 0xDF):
            return self.map(self.uint(2 if b == 0xDE else 4))
        raise ValueError(f"msgpack marker 0x{b:02x} is not decoded here")


def unpackb(data: bytes, raw: bool = False, ext_hook: Optional[Callable] = None) -> Any:
    """One msgpack value from ``data``, as ``msgpack.unpackb`` returns it:
    maps as dicts, arrays as lists, str as ``str`` (``bytes`` with
    ``raw=True``), bin as ``bytes``; an extension as ``ext_hook(code,
    data)``, or :class:`ExtType` without a hook."""
    reader = _Reader(data, raw, ext_hook)
    out = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the msgpack value")
    return out


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype_name, buffer = unpackb(data, raw=True)
    try:
        dtype = np.dtype(dtype_name.decode())
    except TypeError as exc:  # bfloat16: numpy has no such dtype
        raise ValueError(f"array dtype {dtype_name!r} is not read by the port") from exc
    return np.frombuffer(buffer, dtype=dtype).reshape(shape).copy()


def _flax_ext(code: int, data: bytes):
    if code == FLAX_NDARRAY:
        return _ndarray(data)
    if code == FLAX_NPSCALAR:
        return _ndarray(data)[()]
    return ExtType(code, data)


def _unchunk(tree):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def flax_restore(data: bytes) -> Any:
    """The state dict that ``flax.serialization.msgpack_restore`` gives for
    ``data``: nested dicts with numpy arrays and scalars as leaves."""
    return _unchunk(unpackb(data, ext_hook=_flax_ext))
