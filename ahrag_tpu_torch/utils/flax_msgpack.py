"""A reader for flax's msgpack files, without flax and without ``msgpack``.

``flax.serialization.to_bytes`` / ``msgpack_serialize`` write a state dict
as one msgpack object: maps with str keys, lists and Python scalars, with
each array as ext type 1 holding a nested msgpack ``(shape, dtype name,
C-order bytes)``. ``restore(data)`` gives what
``flax.serialization.msgpack_restore`` gives for such a file: the same tree
with numpy arrays at the leaves. Other extension types (numpy scalars,
complex numbers) are refused, and flax's chunked form of an array past
2**30 bytes is not reassembled: no parameter file of this repo holds either.

Used to read the JAX package's knob policy (``checkpoints/knob_policy_v6.msgpack``);
the port's own checkpoints are ``torch.save`` files.
"""
from __future__ import annotations

import struct
from typing import Any, Callable, Dict

import numpy as np

_EXT_NDARRAY = 1


class _Reader:
    def __init__(self, data: bytes, ext: Callable[[int, bytes], Any]) -> None:
        self.data, self.pos, self.ext = memoryview(data), 0, ext

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside an object")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int) -> str:
        return self.take(n).decode("utf-8")

    def array(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def ext_(self, n: int) -> Any:
        code = self.unpack("b")
        return self.ext(code, self.take(n))

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map_(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self.str_(b & 0x1f)
        if b in _FIXED:
            return _FIXED[b](self)
        raise ValueError(f"byte 0x{b:02x} is not a msgpack type")


_FIXED: Dict[int, Callable[[_Reader], Any]] = {
    0xc0: lambda r: None, 0xc2: lambda r: False, 0xc3: lambda r: True,
    0xc4: lambda r: r.take(r.unpack("B")), 0xc5: lambda r: r.take(r.unpack("H")),
    0xc6: lambda r: r.take(r.unpack("I")),
    0xc7: lambda r: r.ext_(r.unpack("B")), 0xc8: lambda r: r.ext_(r.unpack("H")),
    0xc9: lambda r: r.ext_(r.unpack("I")),
    0xca: lambda r: r.unpack("f"), 0xcb: lambda r: r.unpack("d"),
    0xcc: lambda r: r.unpack("B"), 0xcd: lambda r: r.unpack("H"),
    0xce: lambda r: r.unpack("I"), 0xcf: lambda r: r.unpack("Q"),
    0xd0: lambda r: r.unpack("b"), 0xd1: lambda r: r.unpack("h"),
    0xd2: lambda r: r.unpack("i"), 0xd3: lambda r: r.unpack("q"),
    0xd4: lambda r: r.ext_(1), 0xd5: lambda r: r.ext_(2), 0xd6: lambda r: r.ext_(4),
    0xd7: lambda r: r.ext_(8), 0xd8: lambda r: r.ext_(16),
    0xd9: lambda r: r.str_(r.unpack("B")), 0xda: lambda r: r.str_(r.unpack("H")),
    0xdb: lambda r: r.str_(r.unpack("I")),
    0xdc: lambda r: r.array(r.unpack("H")), 0xdd: lambda r: r.array(r.unpack("I")),
    0xde: lambda r: r.map_(r.unpack("H")), 0xdf: lambda r: r.map_(r.unpack("I")),
}


def unpackb(data: bytes, ext: Callable[[int, bytes], Any] = lambda c, d: (c, d)) -> Any:
    """One msgpack object from ``data`` (all of it): maps become dicts,
    arrays lists, str str, bin bytes; ``ext(code, payload)`` decodes
    extension types."""
    r = _Reader(data, ext)
    out = r.read()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the msgpack object")
    return out


def _ndarray(code: int, payload: bytes) -> np.ndarray:
    if code != _EXT_NDARRAY:
        raise ValueError(f"msgpack extension type {code} is not an array")
    shape, dtype_name, buf = unpackb(payload)
    return np.frombuffer(buf, dtype=np.dtype(dtype_name)).reshape(shape).copy()


def restore(data: bytes) -> Any:
    """``flax.serialization.msgpack_restore(data)`` without flax."""
    return unpackb(data, _ndarray)


def is_msgpack_map(head: bytes) -> bool:
    """Whether a file starting with ``head`` holds a msgpack map (what flax
    writes), as opposed to a ``torch.save`` zip archive (``PK``)."""
    return bool(head) and (0x80 <= head[0] <= 0x8f or head[0] in (0xde, 0xdf))

