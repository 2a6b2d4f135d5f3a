"""A small msgpack codec for flax's ``msgpack_serialize`` (ext 1 ndarray, 2
complex, 3 numpy scalar; chunked arrays joined); ``to_bytes`` writes flax's
bytes."""

import struct
from typing import Any, Tuple

import numpy as np
import torch

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
    """``flax.serialization.msgpack_restore``: nested dicts of numpy arrays (read-only views)."""
    return _unchunk(unpackb(data))


MAX_CHUNK_SIZE = 2**30  # flax's: a larger array would be written in chunks


def _head(small: int, codes, n: int) -> bytes:
    """A length header: the fix form below ``small``, else 8/16/32-bit."""
    if n < small:
        return bytes([codes[0] | n])
    for code, fmt, top in zip(codes[1:], (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object of length {n} is too long")


def _int(v: int) -> bytes:
    if -32 <= v <= 0x7F:
        return struct.pack(">b" if v < 0 else ">B", v)
    for code, fmt, lo, hi in ((0xCC, ">B", 0, 1 << 8), (0xCD, ">H", 0, 1 << 16), (0xCE, ">I", 0, 1 << 32),
            (0xCF, ">Q", 0, 1 << 64), (0xD0, ">b", -(1 << 7), 0), (0xD1, ">h", -(1 << 15), 0),
            (0xD2, ">i", -(1 << 31), 0), (0xD3, ">q", -(1 << 63), 0)):
        if lo <= v < hi:
            return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"integer {v} does not fit msgpack")


def _ext_bytes(code: int, data: bytes) -> bytes:
    n = len(data)
    if n in (1, 2, 4, 8, 16):
        return bytes([0xD4 + n.bit_length() - 1, code]) + data
    return _head(0, (0, 0xC7, 0xC8, 0xC9), n) + bytes([code]) + data


def _array_ext(arr) -> bytes:
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        name = "bfloat16" if t.dtype == torch.bfloat16 else None
        arr = t.view(torch.int16).numpy() if name else t.numpy()
        shape, name = tuple(t.shape), name or arr.dtype.name
    else:
        shape, name = arr.shape, arr.dtype.name
    if arr.nbytes > MAX_CHUNK_SIZE:
        raise ValueError(f"an array of {arr.nbytes} bytes exceeds flax's chunk size {MAX_CHUNK_SIZE}; "
                "flax would write it in chunks, which this encoder does not")
    return packb([list(shape), name, np.ascontiguousarray(arr).tobytes()])


def packb(obj: Any) -> bytes:
    """One msgpack object; dicts keep their order, keys as given."""
    if obj is None or obj is True or obj is False:
        return bytes([{None: 0xC0, False: 0xC2, True: 0xC3}[obj]])
    if isinstance(obj, (np.ndarray, torch.Tensor)):
        return _ext_bytes(_EXT_NDARRAY, _array_ext(obj))
    if isinstance(obj, np.generic):
        return _ext_bytes(_EXT_NPSCALAR, _array_ext(np.asarray(obj)))
    if isinstance(obj, int):
        return _int(obj)
    if isinstance(obj, float):
        return b"\xcb" + struct.pack(">d", obj)
    if isinstance(obj, complex):
        return _ext_bytes(_EXT_COMPLEX, packb([obj.real, obj.imag]))
    if isinstance(obj, str):
        b = obj.encode("utf-8")
        return _head(32, (0xA0, 0xD9, 0xDA, 0xDB), len(b)) + b
    if isinstance(obj, bytes):
        return _head(0, (0, 0xC4, 0xC5, 0xC6), len(obj)) + obj
    if isinstance(obj, (list, tuple)):
        return _head(16, (0x90, None, 0xDC, 0xDD), len(obj)) + b"".join(packb(v) for v in obj)
    if isinstance(obj, dict):
        return _head(16, (0x80, None, 0xDE, 0xDF), len(obj)) + b"".join(packb(k) + packb(v) for k, v in obj.items())
    raise TypeError(f"cannot write {type(obj).__name__} as msgpack")


def to_state_dict(tree: Any) -> Any:
    """flax's state dict: str keys, a list or tuple as a map of "0", "1", ..."""
    if isinstance(tree, dict):
        return {str(k): to_state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): to_state_dict(v) for i, v in enumerate(tree)}
    return tree


def to_bytes(tree: Any) -> bytes:
    """``flax.serialization.to_bytes`` of a tree of numpy arrays, tensors and Python scalars."""
    return packb(to_state_dict(tree))
