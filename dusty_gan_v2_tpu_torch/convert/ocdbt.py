"""tensorstore's OCDBT key-value database, the store under an orbax checkpoint's state/,
read and written without tensorstore.

Layout (tensorstore's "OCDBT on-disk format"; worked out here from the bytes tensorstore
writes). Every manifest and node file is

    magic (uint32 big-endian) | file length (uint64) | format version (varint, 0) |
    compression (varint: 0 none, 1 zstd) | body (one zstd frame when compressed) |
    crc32c of everything before it (uint32)

with the magic 0x0cdb3a2a for a manifest, 0x0cdb20de for a B-tree node and 0x0cdb1234 for
a version tree node; integers are little-endian, varints LEB128. A manifest's body is

    config: uuid (16 bytes) | manifest kind (0: one manifest.ocdbt) | max_inline_value_bytes |
            max_decoded_node_bytes | version_tree_arity_log2 (byte) | compression (0 or 1,
            then a zstd level as int32)
    data file table | inline versions | version tree node references

A data file table is num_files, then columns: the length each path shares with the one
before it (files 1..n-1), each path's remaining length, each path's base-path length, and
the remaining bytes; a path is relative to the database's directory. Versions are columns
(generation, root height, root location: file id, offset, length; the tree's key count,
node bytes and indirect value bytes; commit time as uint64 ns). The newest version is the
last inline one; the version tree nodes behind the references hold older ones only.

A B-tree node's body is its height (byte), its own data file table, num_entries and the
key columns (shared-prefix length with the key before, suffix length, the suffixes). An
interior entry adds the length of its key that its whole subtree shares (the child's keys
are stored without it), then its child's location and statistics. A leaf entry adds its
value's length and kind (0 inline, 1 indirect), then the file ids and offsets of the
indirect values, then the inline values back to back. Every crc32c is checked on reading.

The writer makes a new database: one manifest with one version, one leaf node (appended to
the data file after the values, as tensorstore does) and one data file `d/<32 hex>`
holding every value over max_inline_value_bytes, with orbax's config: values up to 1024
bytes inline, nodes up to 100,000,000 bytes, zstd compression (written as raw-block frames).
"""

from __future__ import annotations

import os
import struct
import time
import uuid
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np

from . import zstd

__all__ = ["crc32c", "Database", "write_database", "ORBAX_CONFIG"]

MANIFEST_MAGIC, BTREE_MAGIC = 0x0CDB3A2A, 0x0CDB20DE
_MISSING = 2**64 - 1  # offset and length of an empty tree's root
# orbax's OCDBT config (what tensorstore writes under an orbax 0.11 checkpoint)
ORBAX_CONFIG = {"max_inline_value_bytes": 1024, "max_decoded_node_bytes": 100_000_000,
                "version_tree_arity_log2": 4, "zstd_level": 0}


def _crc_table() -> np.ndarray:
    c = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        c = np.where(c & 1, (c >> 1) ^ np.uint32(0x82F63B78), c >> 1)
    return c


_CRC_TABLE = _crc_table().tolist()


def crc32c(data) -> int:
    """CRC-32C (Castagnoli) of a buffer."""
    c, t = 0xFFFFFFFF, _CRC_TABLE
    for b in memoryview(data).cast("B").tobytes():
        c = t[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Cursor:
    def __init__(self, buf: bytes, what: str):
        self.buf, self.pos, self.what = buf, 0, what

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError(f"ocdbt: {self.what} truncated ({n} bytes at {self.pos} of {len(self.buf)})")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def byte(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        v = shift = 0
        while True:
            b = self.byte()
            v |= (b & 0x7F) << shift
            if b < 0x80:
                return v
            shift += 7
            if shift > 63:
                raise ValueError(f"ocdbt: {self.what}: varint longer than 64 bits")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def end(self) -> None:
        if self.pos != len(self.buf):
            raise ValueError(f"ocdbt: {self.what}: {len(self.buf) - self.pos} bytes after its end")


def _open_file(buf: bytes, magic: int, what: str) -> _Cursor:
    """Check a manifest's or node's header and crc32c; a cursor over its decoded body."""
    if len(buf) < 18:
        raise ValueError(f"ocdbt: {what} too short ({len(buf)} bytes)")
    got_magic, length = struct.unpack_from(">I", buf)[0], struct.unpack_from("<Q", buf, 4)[0]
    if got_magic != magic:
        raise ValueError(f"ocdbt: {what} has magic 0x{got_magic:08x}, expected 0x{magic:08x}")
    if length != len(buf):
        raise ValueError(f"ocdbt: {what} says {length} bytes, holds {len(buf)}")
    want = struct.unpack_from("<I", buf, len(buf) - 4)[0]
    if crc32c(memoryview(buf)[:-4]) != want:
        raise ValueError(f"ocdbt: {what} fails its crc32c check")
    head = _Cursor(buf[:-4], what)
    head.pos = 12
    version, compression = head.varint(), head.varint()
    if version != 0:
        raise ValueError(f"ocdbt: {what} has format version {version}")
    body = head.buf[head.pos :]
    if compression == 1:
        body = bytes(zstd.decompress(body))
    elif compression != 0:
        raise ValueError(f"ocdbt: {what} has unknown compression {compression}")
    return _Cursor(body, what)


def _data_file_table(r: _Cursor) -> List[str]:
    n = r.varint()
    shared = [0] + r.varints(n - 1) if n else []
    suffix, base = r.varints(n), r.varints(n)
    paths, prev = [], b""
    for i in range(n):
        if shared[i] > len(prev):
            raise ValueError(f"ocdbt: {r.what}: data file path shares more than the one before")
        full = prev[: shared[i]] + r.take(suffix[i])
        if base[i] > len(full):
            raise ValueError(f"ocdbt: {r.what}: base path longer than the path")
        paths.append(full.decode())
        prev = full
    return paths


def _keys(r: _Cursor, n: int, with_subtree_prefix: bool):
    shared = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    subtree = r.varints(n) if with_subtree_prefix else None
    keys, prev = [], b""
    for i in range(n):
        if shared[i] > len(prev):
            raise ValueError(f"ocdbt: {r.what}: key shares more than the key before")
        prev = prev[: shared[i]] + r.take(suffix[i])
        keys.append(prev)
    return keys, subtree


# a value: inline bytes, or (data file path, offset, length)
ValueRef = Union[bytes, Tuple[str, int, int]]


class Database:
    """The newest version of the OCDBT database in `root` (a directory), every key and
    value reference read at construction; values of indirect references are read by get()."""

    def __init__(self, root: Union[str, Path]):
        self.root = Path(root)
        r = _open_file(self._read_file("manifest.ocdbt"), MANIFEST_MAGIC, "manifest.ocdbt")
        r.take(16)  # uuid
        kind = r.varint()
        if kind != 0:
            raise ValueError(f"ocdbt: {self.root}: manifest kind {kind} (numbered manifests) is not supported")
        self.config = {"max_inline_value_bytes": r.varint(), "max_decoded_node_bytes": r.varint(),
                       "version_tree_arity_log2": r.byte()}
        compression = r.varint()
        if compression == 1:
            self.config["zstd_level"] = struct.unpack("<i", r.take(4))[0]
        elif compression != 0:
            raise ValueError(f"ocdbt: {self.root}: unknown compression method {compression} in the config")
        files = _data_file_table(r)
        n = r.varint()
        if n == 0:
            raise ValueError(f"ocdbt: {self.root}: the manifest holds no version")
        generation, height = r.varints(n), list(r.take(n))
        fid, off, length = r.varints(n), r.varints(n), r.varints(n)
        self.stats = {"num_keys": r.varints(n)[-1], "num_tree_bytes": r.varints(n)[-1],
                      "num_indirect_value_bytes": r.varints(n)[-1]}
        r.take(8 * n)  # commit times
        m = r.varint()  # references to version tree nodes (older versions): parsed, not followed
        for _ in range(5):  # generation, file id, offset, length, generations below
            r.varints(m)
        r.take(8 * m + m)  # commit times, heights
        r.end()
        self.generation = generation[-1]
        self.values: Dict[bytes, ValueRef] = {}
        if off[-1] != _MISSING:
            self._visit(self._path(files, fid[-1]), off[-1], length[-1], height[-1], b"")
        if len(self.values) != self.stats["num_keys"]:
            raise ValueError(f"ocdbt: {self.root}: {len(self.values)} keys in the tree, the manifest says "
                             f"{self.stats['num_keys']}")

    def _read_file(self, rel: str, offset: int = 0, length: Optional[int] = None) -> bytes:
        path = self.root / rel
        with open(path, "rb") as f:
            if length is None:
                return f.read()
            data = os.pread(f.fileno(), length, offset)
        if len(data) != length:
            raise ValueError(f"ocdbt: {path}: {length} bytes at {offset} run past its end")
        return data

    def _path(self, files: List[str], i: int) -> str:
        if i >= len(files):
            raise ValueError(f"ocdbt: {self.root}: data file id {i} out of a table of {len(files)}")
        return files[i]

    def _visit(self, rel: str, offset: int, length: int, height: int, prefix: bytes) -> None:
        what = f"node {rel}@{offset}"
        r = _open_file(self._read_file(rel, offset, length), BTREE_MAGIC, what)
        if r.byte() != height:
            raise ValueError(f"ocdbt: {what}: height differs from its reference's ({height})")
        files = _data_file_table(r)
        n = r.varint()
        keys, subtree = _keys(r, n, height > 0)
        if height > 0:
            fid, off, size = r.varints(n), r.varints(n), r.varints(n)
            r.varints(3 * n)  # each child's key count, node bytes and indirect value bytes
            r.end()
            for i in range(n):
                self._visit(self._path(files, fid[i]), off[i], size[i], height - 1, prefix + keys[i][: subtree[i]])
            return
        vlen, kind = r.varints(n), r.varints(n)
        indirect = [i for i in range(n) if kind[i] == 1]
        if any(k not in (0, 1) for k in kind):
            raise ValueError(f"ocdbt: {what}: unknown value kind in {sorted(set(kind))}")
        fid, off = r.varints(len(indirect)), r.varints(len(indirect))
        for j, i in enumerate(indirect):
            self.values[prefix + keys[i]] = (self._path(files, fid[j]), off[j], vlen[i])
        for i in range(n):
            if kind[i] == 0:
                self.values[prefix + keys[i]] = r.take(vlen[i])
        r.end()

    def keys(self) -> List[bytes]:
        return sorted(self.values)

    def __contains__(self, key: bytes) -> bool:
        return key in self.values

    def get(self, key: bytes) -> bytes:
        """The value of `key`; KeyError naming the database if it is missing."""
        ref = self.values.get(key)
        if ref is None:
            raise KeyError(f"ocdbt: {self.root} holds no key {key!r}")
        if isinstance(ref, bytes):
            return ref
        return self._read_file(*ref)


# ------------------------------------------------------------------ writing
def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _varints(vs: Iterable[int]) -> bytes:
    return b"".join(_varint(v) for v in vs)


def _table(paths: List[bytes]) -> bytes:
    """A data file table of paths with empty base paths (paths sorted)."""
    shared = [len(os.path.commonprefix([paths[i - 1], paths[i]])) for i in range(1, len(paths))]
    suffix = [p[s:] for p, s in zip(paths, [0] + shared)]
    return _varint(len(paths)) + _varints(shared) + _varints(len(s) for s in suffix) + _varints(
        0 for _ in paths) + b"".join(suffix)


def _file(magic: int, body: bytes) -> bytes:
    """A manifest or node file: header, body as one raw-block zstd frame, crc32c."""
    frame = zstd.compress_raw(body)
    length = 4 + 8 + 2 + len(frame) + 4
    head = struct.pack(">I", magic) + struct.pack("<Q", length) + b"\x00\x01"
    data = head + frame
    return data + struct.pack("<I", crc32c(data))


def _size(value) -> int:
    return sum(memoryview(p).nbytes for p in value) if isinstance(value, list) else len(value)


def write_database(root: Union[str, Path], entries: Dict[bytes, Union[bytes, List]]) -> Dict[str, int]:
    """Write `entries` (key -> bytes, or a list of buffers written back to back) as a new
    OCDBT database in the directory `root` with orbax's config. Returns the tree's
    statistics. A value over 1024 bytes goes to the data file, the rest inline."""
    cfg = ORBAX_CONFIG
    root = Path(root)
    (root / "d").mkdir(parents=True, exist_ok=False)
    data_rel = f"d/{uuid.uuid4().hex}"
    keys = sorted(entries)
    sizes = [_size(entries[k]) for k in keys]
    kinds = [int(s > cfg["max_inline_value_bytes"]) for s in sizes]
    offsets, inline, pos = [], [], 0
    with open(root / data_rel, "wb") as f:
        for k, s, kind in zip(keys, sizes, kinds):
            v = entries[k]
            if kind:
                offsets.append(pos)
                f.writelines(v if isinstance(v, list) else [v])
                pos += s
            else:
                inline.append(b"".join(bytes(p) for p in v) if isinstance(v, list) else bytes(v))
        shared = [len(os.path.commonprefix([keys[i - 1], keys[i]])) for i in range(1, len(keys))]
        body = b"".join([
            b"\x00", _table([data_rel.encode()] if offsets else []), _varint(len(keys)), _varints(shared),
            _varints(len(k) - s for k, s in zip(keys, [0] + shared)),
            b"".join(k[s:] for k, s in zip(keys, [0] + shared)),
            _varints(sizes), _varints(kinds), _varints(0 for _ in offsets), _varints(offsets), b"".join(inline),
        ])
        if len(body) > cfg["max_decoded_node_bytes"]:
            raise ValueError(f"ocdbt: a leaf of {len(body)} bytes exceeds max_decoded_node_bytes; the writer "
                             "makes one leaf")
        node = _file(BTREE_MAGIC, body)
        f.write(node)
    stats = {"num_keys": len(keys), "num_tree_bytes": len(node), "num_indirect_value_bytes": pos}
    config = b"".join([
        uuid.uuid4().bytes, b"\x00", _varint(cfg["max_inline_value_bytes"]), _varint(cfg["max_decoded_node_bytes"]),
        bytes([cfg["version_tree_arity_log2"]]), b"\x01", struct.pack("<i", cfg["zstd_level"]),
    ])
    version = b"".join([
        _varint(1), _varint(1), b"\x00", _varint(0), _varint(pos), _varint(len(node)),
        _varint(stats["num_keys"]), _varint(stats["num_tree_bytes"]), _varint(stats["num_indirect_value_bytes"]),
        struct.pack("<Q", time.time_ns()), _varint(0),
    ])
    (root / "manifest.ocdbt").write_bytes(_file(MANIFEST_MAGIC, config + _table([data_rel.encode()]) + version))
    return stats
