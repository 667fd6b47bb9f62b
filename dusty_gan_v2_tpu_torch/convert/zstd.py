"""Zstandard frames for orbax checkpoints: the port's own decoder (csrc/zstd_decode.cpp,
built with g++ at first use by utils/hostbuild.py) and a writer of raw-block frames.

    data = decompress(frame_bytes)            # bytearray
    n = decompress_into(frame_bytes, buffer)  # into a writable buffer, its exact size
    pieces = raw_frame(memoryview)            # the frame as a list of buffers

The decoder takes everything RFC 8878 allows without a dictionary: frames with and
without a content size, skippable frames, frames back to back, raw / RLE / compressed
blocks, Huffman and FSE entropy coding, the XXH64 checksum. There is no fallback: a
missing g++, a failed build or a corrupt frame raises. The writer needs no encoder: a
frame of raw blocks (at most 128 KiB each) with its content size in the header, which
every zstd decoder reads; on disk it is the input plus 3 bytes a block and a header.
"""

from __future__ import annotations

import ctypes
import struct
from pathlib import Path
from typing import List, Optional

import numpy as np

from ..utils import hostbuild

__all__ = ["SOURCE", "BUILD_DIR", "library", "content_size", "decompress", "decompress_into", "raw_frame",
           "compress_raw", "BLOCK_MAX", "OutputTooSmall"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "zstd_decode.cpp"
BUILD_DIR = _PKG / "_build"
STEM = "libdusty_zstd"
MAGIC = 0xFD2FB528
BLOCK_MAX = 128 * 1024
_ERRLEN = 512


class OutputTooSmall(ValueError):
    """The decoded frames do not fit the output buffer."""


def _declare(lib: ctypes.CDLL) -> None:
    lib.zstd_content_size.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_uint64),
                                      ctypes.c_char_p, ctypes.c_size_t]
    lib.zstd_content_size.restype = ctypes.c_int
    lib.zstd_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p, ctypes.c_size_t,
                                    ctypes.c_char_p, ctypes.c_size_t]
    lib.zstd_decompress.restype = ctypes.c_int64


def library() -> ctypes.CDLL:
    """The decoder library, built first if needed (once per process)."""
    return hostbuild.load(SOURCE, BUILD_DIR, STEM, _declare)


def _address(buf, writable: bool):
    """(address, length, keep-alive) of a contiguous buffer (bytes, bytearray, memoryview,
    numpy array), without a copy."""
    a = np.frombuffer(memoryview(buf).cast("B"), np.uint8)
    if writable and not a.flags.writeable:
        raise TypeError("zstd: the output buffer is read-only")
    return a.ctypes.data, a.size, a


def content_size(data) -> Optional[int]:
    """The decoded size that the frames' headers declare, or None if a frame declares none."""
    addr, n, _keep = _address(data, False)
    total, err = ctypes.c_uint64(), ctypes.create_string_buffer(_ERRLEN)
    rc = library().zstd_content_size(addr, n, ctypes.byref(total), err, _ERRLEN)
    if rc < 0:
        raise ValueError(err.value.decode())
    return int(total.value) if rc == 1 else None


def decompress_into(data, out) -> int:
    """Decode the frames of `data` into the writable buffer `out`; return the bytes
    written. ValueError on corrupt input, OutputTooSmall if the output would not fit."""
    src, n, _keep_src = _address(data, False)
    dst, cap, _keep_dst = _address(out, True)
    err = ctypes.create_string_buffer(_ERRLEN)
    got = library().zstd_decompress(src, n, dst, cap, err, _ERRLEN)
    if got < 0:
        raise (OutputTooSmall if got == -2 else ValueError)(err.value.decode())
    return int(got)


def decompress(data, size: Optional[int] = None) -> bytearray:
    """The decoded bytes of the frames in `data`. `size` (else the headers' content sizes)
    is the exact output size; where neither gives it, the buffer grows until it fits."""
    want = size if size is not None else content_size(data)
    if want is not None:
        out = bytearray(want)
        got = decompress_into(data, out)
        if got != want:
            raise ValueError(f"zstd: decoded {got} bytes, expected {want}")
        return out
    cap = max(1 << 16, 4 * len(memoryview(data).cast("B")))
    while True:
        out = bytearray(cap)
        try:
            got = decompress_into(data, out)
        except OutputTooSmall:
            cap *= 4
            continue
        del out[got:]
        return out


def raw_frame(data) -> List:
    """A zstd frame of raw blocks holding `data`, as a list of buffers (the data's pieces
    are views, not copies): single-segment, an 8-byte content size, no checksum."""
    mv = memoryview(data).cast("B")
    n = len(mv)
    out: List = [struct.pack("<IBQ", MAGIC, 0xE0, n)]  # FHD: content size in 8 bytes, single segment
    if n == 0:
        out.append(b"\x01\x00\x00")  # one last raw block of 0 bytes
        return out
    for i in range(0, n, BLOCK_MAX):
        size = min(BLOCK_MAX, n - i)
        out.append(((size << 3) | (i + size == n)).to_bytes(3, "little"))
        out.append(mv[i : i + size])
    return out


def compress_raw(data) -> bytes:
    """raw_frame(data) joined into one bytes object."""
    return b"".join(raw_frame(data))
