"""Flax's msgpack format (flax.serialization.msgpack_serialize / msgpack_restore), read
and written without flax, msgpack or ml_dtypes.

A file is one msgpack object: maps, arrays, strings, bytes, ints, floats, bools and
nil, with two extension types. Ext 1 is an array: a packed (shape, dtype name, C-order
bytes); ext 3 a numpy scalar in the same encoding. An array of more than 2**30 bytes is
written as a map {"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks":
{"0": flat piece, ...}}.

`loads` returns dicts, lists, Python scalars and torch tensors: every array and numpy
scalar becomes a tensor of its dtype (bfloat16 included; a numpy scalar a 0-dim one).
The tensors share the memory of the buffer given to `loads` (read a file with `load`,
which reads it once into a writable buffer), so a 500 MB checkpoint is not copied
again; only a chunked array is joined into a new one.

`dumps` / `dump` write the same bytes flax does for a tree of dicts (keys sorted, as
flax's copy sorts them), lists, tuples (as flax's to_state_dict turns them into
{"0": ...} maps), str, bytes, int, float, bool, None and tensors or numpy arrays.
"""

from __future__ import annotations

import struct
from typing import Any, BinaryIO, List

import numpy as np
import torch

__all__ = ["load", "loads", "dump", "dumps", "MAX_CHUNK_SIZE"]

MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_NPSCALAR = 1, 3  # flax's ext 2, a Python complex, is not in a checkpoint

_DTYPES = {
    "float16": torch.float16, "bfloat16": torch.bfloat16, "float32": torch.float32, "float64": torch.float64,
    "int8": torch.int8, "int16": torch.int16, "int32": torch.int32, "int64": torch.int64,
    "uint8": torch.uint8, "uint16": torch.uint16, "uint32": torch.uint32, "uint64": torch.uint64,
    "bool": torch.bool,
}
_NAMES = {v: k for k, v in _DTYPES.items()}


# ------------------------------------------------------------------ reading
class _Reader:
    def __init__(self, buf: memoryview):
        self.buf, self.pos = buf, 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError(f"msgpack: truncated input ({n} bytes at offset {self.pos} of {len(self.buf)})")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

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
            return bytes(self.take(self.unpack((">B", ">H", ">I")[b - 0xC4])))
        if b in (0xC7, 0xC8, 0xC9):
            n = self.unpack((">B", ">H", ">I")[b - 0xC7])
            return self.ext(self.unpack(">b"), n)
        if b == 0xCA:
            return self.unpack(">f")
        if b == 0xCB:
            return self.unpack(">d")
        if 0xCC <= b <= 0xD3:
            return self.unpack((">B", ">H", ">I", ">Q", ">b", ">h", ">i", ">q")[b - 0xCC])
        if 0xD4 <= b <= 0xD8:
            return self.ext(self.unpack(">b"), 1 << (b - 0xD4))
        if b in (0xD9, 0xDA, 0xDB):
            return self.str(self.unpack((">B", ">H", ">I")[b - 0xD9]))
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x} at offset {self.pos - 1}")

    def str(self, n: int) -> str:
        return str(self.take(n), "utf-8")

    def array(self, n: int) -> List:
        return [self.obj() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out

    def ext(self, code: int, n: int):
        data = self.take(n)
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            a = _array(data)
            return a if code == _EXT_NDARRAY else a.reshape(())
        raise ValueError(f"msgpack: unknown extension type {code}")


def _array(data: memoryview) -> torch.Tensor:
    """An ext-1 payload (shape, dtype name, bytes) as a tensor over `data`'s memory."""
    r = _Reader(data)
    if r.take(1)[0] != 0x93:
        raise ValueError("msgpack: an array payload is not a 3-element array")
    shape, name = r.obj(), r.obj()
    b = r.take(1)[0]
    if b not in (0xC4, 0xC5, 0xC6):
        raise ValueError("msgpack: an array payload's data is not bytes")
    raw = r.take(r.unpack((">B", ">H", ">I")[b - 0xC4]))
    if name not in _DTYPES:
        raise ValueError(f"msgpack: unsupported array dtype {name!r}")
    dtype = _DTYPES[name]
    count = int(np.prod(shape, dtype=np.int64))
    if len(raw) != count * dtype.itemsize:
        raise ValueError(f"msgpack: {len(raw)} bytes for a {name} array of shape {shape}")
    if count == 0:
        return torch.empty(shape, dtype=dtype)
    if raw.readonly:  # the tensor must not alias memory that cannot be written
        raw = memoryview(bytearray(raw))
    return torch.frombuffer(raw, dtype=dtype, count=count).reshape(shape)


def _unchunk(node):
    if isinstance(node, dict):
        if node.get(_CHUNKED) is True:
            shape = [node["shape"][str(i)] for i in range(len(node["shape"]))]
            chunks = [node["chunks"][str(i)] for i in range(len(node["chunks"]))]
            return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
        return {k: _unchunk(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_unchunk(v) for v in node]
    return node


def loads(buf) -> Any:
    """Decode one msgpack object (bytes, bytearray or memoryview). Tensors alias `buf`
    when it is writable (a bytearray); a read-only buffer's arrays are copied."""
    r = _Reader(memoryview(buf).cast("B"))
    out = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} bytes after the object")
    return _unchunk(out)


def load(path: str) -> Any:
    """Read a flax msgpack file: one read into a bytearray, tensors over its memory."""
    with open(path, "rb") as f:
        size = f.seek(0, 2)
        f.seek(0)
        buf = bytearray(size)
        if f.readinto(buf) != size:
            raise ValueError(f"{path}: short read")
    return loads(buf)


# ------------------------------------------------------------------ writing
def _int(v: int) -> bytes:
    if 0 <= v <= 0x7F:
        return bytes((v,))
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for limit, code, fmt in ((0xFF, 0xCC, ">B"), (0xFFFF, 0xCD, ">H"), (0xFFFFFFFF, 0xCE, ">I"),
                                 (0xFFFFFFFFFFFFFFFF, 0xCF, ">Q")):
            if v <= limit:
                return bytes((code,)) + struct.pack(fmt, v)
    else:
        for limit, code, fmt in ((-0x80, 0xD0, ">b"), (-0x8000, 0xD1, ">h"), (-0x80000000, 0xD2, ">i"),
                                 (-0x8000000000000000, 0xD3, ">q")):
            if v >= limit:
                return bytes((code,)) + struct.pack(fmt, v)
    raise OverflowError(f"msgpack: int {v} out of range")


def _len_head(n: int, fix: int, fix_max: int, codes) -> bytes:
    if fix is not None and n <= fix_max:
        return bytes((fix | n,))
    for limit, code, fmt in zip((0xFF, 0xFFFF, 0xFFFFFFFF), codes, (">B", ">H", ">I")):
        if code is not None and n <= limit:
            return bytes((code,)) + struct.pack(fmt, n)
    raise ValueError(f"msgpack: length {n} too large")


def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    return _len_head(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + b


def _bin_head(n: int) -> bytes:
    return _len_head(n, None, -1, (0xC4, 0xC5, 0xC6))


def _ext_head(code: int, n: int) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    head = bytes((fixed[n],)) if n in fixed else _len_head(n, None, -1, (0xC7, 0xC8, 0xC9))
    return head + struct.pack(">b", code)


def _shape_name_bytes(x):
    """(shape, dtype name, C-order bytes) of a tensor or numpy array (a tensor's
    bfloat16 and unsigned types through a reinterpreting uint8 view, which numpy's
    conversion does not take)."""
    if isinstance(x, np.ndarray):
        a = x if x.flags.c_contiguous else x.copy(order="C")  # (ascontiguousarray makes a 0-d array 1-d)
        return a.shape, a.dtype.name, memoryview(a.reshape(-1).view(np.uint8))
    t = x.detach().cpu().contiguous()
    if t.dtype not in _NAMES:
        raise TypeError(f"msgpack: unsupported array dtype {t.dtype}")
    flat = t.reshape(-1)
    raw = flat.numpy() if t.dtype == torch.bool else flat.view(torch.uint8).numpy()
    return tuple(t.shape), _NAMES[t.dtype], memoryview(raw)


def _array_parts(x, code: int) -> List:
    shape, name, raw = _shape_name_bytes(x)
    head = bytes((0x93,)) + _len_head(len(shape), 0x90, 15, (None, 0xDC, 0xDD))
    head += b"".join(_int(int(d)) for d in shape) + _str(name) + _bin_head(len(raw))
    return [_ext_head(code, len(head) + len(raw)) + head, raw]


def _chunk(x) -> dict:
    """flax's _chunk: the flat array in pieces of MAX_CHUNK_SIZE bytes (rounded down to
    whole elements)."""
    per = max(1, MAX_CHUNK_SIZE // x.itemsize)
    flat = x.reshape(-1)
    return {_CHUNKED: True, "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(i): flat[j : j + per] for i, j in enumerate(range(0, flat.shape[0], per))}}


def _parts(x, out: List) -> None:
    if isinstance(x, dict):
        out.append(_len_head(len(x), 0x80, 15, (None, 0xDE, 0xDF)))
        for k in sorted(x):
            if not isinstance(k, str):
                raise TypeError(f"msgpack: map keys must be str, got {type(k).__name__}")
            out.append(_str(k))
            _parts(x[k], out)
    elif isinstance(x, tuple):
        _parts({str(i): v for i, v in enumerate(x)}, out)
    elif isinstance(x, list):
        out.append(_len_head(len(x), 0x90, 15, (None, 0xDC, 0xDD)))
        for v in x:
            _parts(v, out)
    elif x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif type(x) is int:
        out.append(_int(x))
    elif type(x) is float:
        out.append(b"\xcb" + struct.pack(">d", x))
    elif type(x) is str:
        out.append(_str(x))
    elif type(x) is bytes:
        out.append(_bin_head(len(x)) + x)
    elif isinstance(x, np.generic):
        out.extend(_array_parts(np.asarray(x), _EXT_NPSCALAR))
    elif isinstance(x, (torch.Tensor, np.ndarray)):
        if x.nbytes > MAX_CHUNK_SIZE:  # flax's map, its keys in flax's order (not sorted)
            out.append(_len_head(3, 0x80, 15, ()))
            for k, v in _chunk(x).items():
                out.append(_str(k))
                _parts(v, out)
        else:
            out.extend(_array_parts(x, _EXT_NDARRAY))
    else:
        raise TypeError(f"msgpack: cannot write {type(x).__name__}")


def dumps(tree) -> bytes:
    """flax.serialization.msgpack_serialize's bytes for `tree`."""
    out: List = []
    _parts(tree, out)
    return b"".join(out)


def dump(tree, f: BinaryIO) -> None:
    """Write dumps(tree) to a binary file, piece by piece (an array's bytes are not
    copied into one string first)."""
    out: List = []
    _parts(tree, out)
    for part in out:
        f.write(part)
