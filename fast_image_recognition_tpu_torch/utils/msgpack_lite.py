"""A small msgpack decoder for what flax's ``msgpack_serialize`` writes: maps,
arrays, str, bin, ints, floats, nil, bool and flax's ext types (1 ndarray
as ``(shape, dtype name, C bytes)``, 2 complex, 3 numpy scalar); chunked
arrays (``__msgpack_chunked_array__``) are joined, as flax restores them."""

from __future__ import annotations

import struct
from typing import Any, Tuple

import numpy as np

_EXT_NDARRAY = 1
_EXT_COMPLEX = 2
_EXT_NPSCALAR = 3


def _bf16_to_f32(buf: bytes) -> np.ndarray:
    """bfloat16 (no numpy dtype) widened exactly to float32."""
    u16 = np.frombuffer(buf, dtype="<u2").astype(np.uint32)
    return (u16 << 16).view(np.float32)


def _ndarray(data: bytes) -> np.ndarray:
    shape, dtype_name, buf = unpackb(data)
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode()
    if dtype_name == "bfloat16":
        arr = _bf16_to_f32(buf)
    else:
        arr = np.frombuffer(buf, dtype=np.dtype(dtype_name))
    return arr.reshape(tuple(shape), order="C")


def _ext(code: int, data: bytes) -> Any:
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    if code == _EXT_COMPLEX:
        re, im = unpackb(data)
        return complex(re, im)
    raise ValueError(f"unsupported msgpack ext type {code}")


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        p = self.pos
        if p + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        self.pos = p + n
        return self.buf[p : p + n]

    def unpack(self, fmt: str) -> Tuple:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))

    def obj(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b == 0xC0:
            return None
        if b == 0xC2:
            return False
        if b == 0xC3:
            return True
        if b in (0xC4, 0xC5, 0xC6):
            (n,) = self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
            return bytes(self.take(n))
        if b in (0xC7, 0xC8, 0xC9):
            (n,) = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            (code,) = self.unpack(">b")
            return _ext(code, bytes(self.take(n)))
        if b == 0xCA:
            return self.unpack(">f")[0]
        if b == 0xCB:
            return self.unpack(">d")[0]
        if 0xCC <= b <= 0xD3:
            fmt = (">B", ">H", ">I", ">Q", ">b", ">h", ">i", ">q")[b - 0xCC]
            return self.unpack(fmt)[0]
        if 0xD4 <= b <= 0xD8:
            n = 1 << (b - 0xD4)
            (code,) = self.unpack(">b")
            return _ext(code, bytes(self.take(n)))
        if b in (0xD9, 0xDA, 0xDB):
            (n,) = self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b])
            return self.str(n)
        if b in (0xDC, 0xDD):
            (n,) = self.unpack(">H" if b == 0xDC else ">I")
            return self.array(n)
        if b in (0xDE, 0xDF):
            (n,) = self.unpack(">H" if b == 0xDE else ">I")
            return self.map(n)
        raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")

    def str(self, n: int) -> str:
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def unpackb(data: bytes) -> Any:
    """Decode one msgpack object; raises on trailing bytes."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes after msgpack object")
    return out


def _unchunk(tree: Any) -> Any:
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    for k, v in tree.items():
        tree[k] = _unchunk(v)
    return tree


def msgpack_restore(data: bytes) -> Any:
    """The port's ``flax.serialization.msgpack_restore``: nested dicts of
    numpy arrays (read-only views of ``data``)."""
    return _unchunk(unpackb(data))
