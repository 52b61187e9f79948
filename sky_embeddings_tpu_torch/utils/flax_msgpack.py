"""The flax msgpack checkpoint format in plain Python (``struct`` alone).

The JAX package writes its checkpoints through flax's ``msgpack_serialize``
(JAX ``utils/checkpoint.py``); the card host has neither flax nor msgpack, so
this module holds the subset of msgpack that flax's payloads use, and
:func:`serialize` / :func:`restore` give what flax 0.12's
``msgpack_serialize`` / ``msgpack_restore`` give:

- dicts (string keys, written in sorted order, as ``jax.tree_util.tree_map``
  rebuilds them), lists, str, bytes, bool, None, Python ints and floats
  (float64) packed as msgpack packs them;
- an array leaf (numpy or torch) is ext type 1 holding an inner msgpack of
  ``(shape, dtype name, C-order bytes)``; a numpy scalar is ext 3 (its 0-d
  array), a Python complex ext 2 (``(real, imag)``);
- an array of more than ``MAX_CHUNK_SIZE`` bytes is written as
  ``{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks":
  {"0": flat slice, ...}}`` and joined back on reading.

Read leaves are views into one buffer of the file: numpy arrays, or torch
tensors for ``bfloat16`` (``torch.frombuffer``: numpy has no bfloat16 here).
A chunked array is the one copy. :func:`read` takes the file into one
``bytearray``, so peak host memory on reading is about the file's size.
"""

from __future__ import annotations

import os
import struct
import warnings
from typing import Any, BinaryIO

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30  # flax's: msgpack leaves stay below 2**31 - 1 bytes
_CHUNKED = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3

_TORCH_NAMES = {torch.float32: "float32", torch.float64: "float64", torch.float16: "float16",
                torch.bfloat16: "bfloat16", torch.int8: "int8", torch.int16: "int16",
                torch.int32: "int32", torch.int64: "int64", torch.uint8: "uint8",
                torch.bool: "bool"}


# ----------------------------------------------------------------------
# writing


def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return bytes((n,))
    if -32 <= n < 0:
        return struct.pack(">b", n)
    if n >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if n < top:
                return bytes((code,)) + struct.pack(fmt, n)
    else:
        for code, fmt, low in ((0xD0, ">b", -(1 << 7)), (0xD1, ">h", -(1 << 15)),
                               (0xD2, ">i", -(1 << 31)), (0xD3, ">q", -(1 << 63))):
            if n >= low:
                return bytes((code,)) + struct.pack(fmt, n)
    raise OverflowError(f"integer {n} does not fit msgpack's 64 bits")


def _sized(n: int, fix: int | None, fix_max: int, codes: tuple) -> bytes:
    """The header of a str / bin / array / map of ``n`` items or bytes."""
    if fix is not None and n <= fix_max:
        return bytes((fix | n,))
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < top:
            return bytes((code,)) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object of {n} items or bytes is too large")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _sized(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + b


def _array_header(n: int) -> bytes:
    return _sized(n, 0x90, 15, (None, 0xDC, 0xDD))


def _bin_header(n: int) -> bytes:
    return _sized(n, None, 0, (0xC4, 0xC5, 0xC6))


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        head = bytes((fixed[n],))
    else:
        head = _sized(n, None, 0, (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code)


def _array_parts(shape, dtype_name: str, data: memoryview) -> list:
    """Ext 1 (or 3) payload pieces: ``(shape, dtype name, bytes)`` packed."""
    head = (_array_header(3) + _array_header(len(shape)) + b"".join(_int(int(d)) for d in shape)
            + _str(dtype_name) + _bin_header(data.nbytes))
    return [head, data]


def _leaf_bytes(x) -> tuple[tuple, str, memoryview]:
    """(shape, flax dtype name, C-order bytes as a view) of an array leaf."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu").contiguous()
        name = _TORCH_NAMES[t.dtype]
        raw = t.reshape(-1).view(torch.uint8) if t.numel() else torch.empty(0, dtype=torch.uint8)
        return tuple(t.shape), name, memoryview(raw.numpy()).cast("B")
    a = np.asarray(x)
    if not a.flags.c_contiguous:
        a = a.copy(order="C")
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serializable")
    return a.shape, a.dtype.name, memoryview(a.reshape(-1).view(np.uint8))


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes


def _chunk(x) -> dict:
    """flax's ``_chunk``: the flat array in slices of at most MAX_CHUNK_SIZE bytes."""
    flat = x.reshape(-1)
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    n = flat.shape[0]
    return {_CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(i): flat[s: s + size] for i, s in enumerate(range(0, n, size))}}


def _is_array(x) -> bool:
    return isinstance(x, (np.ndarray, torch.Tensor))


def _pack(obj, out: list, top: bool = False, sort: bool = True) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif type(obj) is int:
        out.append(_int(obj))
    elif type(obj) is float:
        out.append(b"\xcb" + struct.pack(">d", obj))
    elif type(obj) is str:
        out.append(_str(obj))
    elif type(obj) in (bytes, bytearray):
        out.append(_bin_header(len(obj)) + bytes(obj))
    elif type(obj) is dict:
        if _CHUNKED in obj:
            sort = False  # a chunk record keeps flax's insertion order
        out.append(_sized(len(obj), 0x80, 15, (None, 0xDE, 0xDF)))
        for k in (sorted(obj) if sort else obj):
            v = obj[k]
            if not isinstance(k, str):
                raise TypeError(f"dict keys must be str, got {k!r}")
            out.append(_str(k))
            if _is_array(v) and _nbytes(v) > MAX_CHUNK_SIZE:
                v = _chunk(v)
            _pack(v, out, sort=sort)
    elif type(obj) is list:
        out.append(_array_header(len(obj)))
        for v in obj:
            _pack(v, out, sort=sort)
    elif _is_array(obj):
        if top and _nbytes(obj) > MAX_CHUNK_SIZE:
            _pack(_chunk(obj), out)
            return
        shape, name, data = _leaf_bytes(obj)
        parts = _array_parts(shape, name, data)
        out.append(_ext_header(EXT_NDARRAY, len(parts[0]) + data.nbytes))
        out.extend(parts)
    elif isinstance(obj, np.generic):
        shape, name, data = _leaf_bytes(np.asarray(obj))
        parts = _array_parts(shape, name, data)
        out.append(_ext_header(EXT_NPSCALAR, len(parts[0]) + data.nbytes))
        out.extend(parts)
    elif type(obj) is complex:
        body = b"\x92\xcb" + struct.pack(">d", obj.real) + b"\xcb" + struct.pack(">d", obj.imag)
        out.append(_ext_header(EXT_COMPLEX, len(body)) + body)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__} (flax's msgpack subset)")


def serialize_parts(tree: Any) -> list:
    """:func:`serialize`'s output as a list of byte strings and array views
    (no copy of the arrays)."""
    out: list = []
    _pack(tree, out, top=True)
    return out


def serialize(tree: Any) -> bytes:
    """``tree`` as flax's ``msgpack_serialize`` writes it, byte for byte."""
    return b"".join(serialize_parts(tree))


def write(f: BinaryIO, tree: Any) -> int:
    """Stream :func:`serialize`'s bytes to ``f``; returns the byte count."""
    n = 0
    for part in serialize_parts(tree):
        f.write(part)
        n += len(part) if isinstance(part, bytes) else part.nbytes
    return n


# ----------------------------------------------------------------------
# reading


class _Reader:
    def __init__(self, buf):
        self.buf = buf
        self.mv = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        p = self.pos
        if p + n > len(self.mv):
            raise ValueError("truncated msgpack data")
        self.pos = p + n
        return self.mv[p: p + n]

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self, raw: bool = False):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, raw)
        if 0x90 <= b <= 0x9F:
            return [self.obj(raw) for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F, raw)
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack({0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}[b])
            return self.ext(n)
        if b in (0xD4, 0xD5, 0xD6, 0xD7, 0xD8):
            return self.ext(1 << (b - 0xD4))
        fmts = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in fmts:
            return self.unpack(fmts[b])
        if b in (0xD9, 0xDA, 0xDB):
            return self.string(self.unpack({0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}[b]), raw)
        if b in (0xDC, 0xDD):
            n = self.unpack(">H" if b == 0xDC else ">I")
            return [self.obj(raw) for _ in range(n)]
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"), raw)
        raise ValueError(f"msgpack type byte 0x{b:02x} is not in flax's subset")

    def string(self, n: int, raw: bool):
        data = bytes(self.take(n))
        return data if raw else data.decode("utf-8")

    def map(self, n: int, raw: bool) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj(raw)
            out[k] = self.obj(raw)
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        end = self.pos + n
        if code in (EXT_NDARRAY, EXT_NPSCALAR):
            head = self.take(1)[0]
            if head != 0x93:
                raise ValueError("array ext: want (shape, dtype, bytes)")
            shape = self.obj(raw=True)
            name = self.obj(raw=True).decode()
            b = self.take(1)[0]
            if b not in (0xC4, 0xC5, 0xC6):
                raise ValueError("array ext: want its bytes as msgpack bin")
            nbytes = self.unpack({0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}[b])
            offset = self.pos
            self.take(nbytes)
            arr = self.array(shape, name, offset, nbytes)
            if self.pos != end:
                raise ValueError("array ext of unexpected length")
            return arr[()] if code == EXT_NPSCALAR else arr
        if code == EXT_COMPLEX:
            re, im = self.obj()
            return complex(re, im)
        raise ValueError(f"msgpack ext type {code} is not flax's")

    def array(self, shape: list, name: str, offset: int, nbytes: int):
        if name == "bfloat16":
            with warnings.catch_warnings():  # a read-only buffer: the view is not written
                warnings.simplefilter("ignore", UserWarning)
                t = (torch.frombuffer(self.buf, dtype=torch.bfloat16, count=nbytes // 2,
                                      offset=offset) if nbytes else torch.empty(0, dtype=torch.bfloat16))
            return t.reshape(shape)
        dtype = np.dtype(name)
        return np.frombuffer(self.buf, dtype=dtype, count=nbytes // dtype.itemsize,
                             offset=offset).reshape(shape, order="C")


def _unchunk(d: dict):
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    chunks = [d["chunks"][str(i)] for i in range(len(d["chunks"]))]
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat(chunks).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _unchunk_tree(d):
    """flax's ``_unchunk_array_leaves_in_place``: chunk records in dicts."""
    if isinstance(d, dict):
        if _CHUNKED in d:
            return _unchunk(d)
        for k, v in d.items():
            if isinstance(v, dict):
                d[k] = _unchunk(v) if _CHUNKED in v else _unchunk_tree(v)
    return d


def restore(data) -> Any:
    """flax's ``msgpack_restore`` of ``data`` (bytes, bytearray or a buffer):
    the tree with numpy leaves, torch tensors for bfloat16, viewing ``data``."""
    reader = _Reader(data)
    tree = reader.obj()
    if reader.pos != len(reader.mv):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk_tree(tree)


def read(path: str) -> Any:
    """:func:`restore` of the file at ``path``, its leaves viewing one
    ``bytearray`` of the file."""
    buf = bytearray(os.path.getsize(path))
    with open(path, "rb") as f:
        if f.readinto(buf) != len(buf):
            raise IOError(f"short read of {path}")
    return restore(buf)
