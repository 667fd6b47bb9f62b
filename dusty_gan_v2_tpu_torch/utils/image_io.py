"""PNG and GIF writers on the standard library (zlib, struct) and numpy, so that the demos
and the training CLI's panels need no imaging or plotting library.

    write_png("grid.png", to_uint8(rgb))         # (H, W, 3) uint8
    save_video(index_frames, "interp", fps=30)    # (H, W) uint8 indices into TURBO_U8

`save_video` writes a GIF89a whose global palette is the colormap's 256 entries and
whose pixels are the LUT indices that `colorize_indices` computes, so each frame is
exactly the colours `colorize` gives (an adaptive palette would be lossy). Its LZW
stream holds only literal codes, with a clear code after every 254 of them: the code
table never grows past 9-bit codes, so every code is 9 bits wide. That is larger than
a compressing encoder's output (9/8 of the raw bytes) and is read by every GIF decoder.
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np

from .colormap import TURBO_U8

__all__ = ["to_uint8", "write_png", "save_video", "gif_lzw_literal"]

_LITERALS_PER_CLEAR = 254  # 258 + 253 table entries < 512: the code width stays 9 bits


def to_uint8(rgb) -> np.ndarray:
    """Floats in [0, 1] -> uint8 by (x * 255) truncated, matplotlib's conversion for
    float images."""
    x = np.asarray(rgb)
    if x.size and (np.nanmin(x) < 0 or np.nanmax(x) > 1):
        raise ValueError("to_uint8 takes floats in [0, 1]")
    return (x * 255).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF)


def write_png(path: str, image) -> str:
    """Write an (H, W, 3) uint8 RGB array as an 8-bit PNG (filter 0 on every row, zlib
    level 6). Returns the path."""
    img = np.ascontiguousarray(image)
    if img.dtype != np.uint8:
        raise TypeError(f"write_png takes uint8, got {img.dtype} (see to_uint8)")
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"write_png takes (H, W, 3), got {img.shape}")
    H, W = img.shape[:2]
    raw = np.concatenate([np.zeros((H, 1), np.uint8), img.reshape(H, -1)], axis=1).tobytes()
    header = struct.pack(">IIBBBBB", W, H, 8, 2, 0, 0, 0)  # 8-bit truecolour
    data = b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header) + _chunk(b"IDAT", zlib.compress(raw, 6)) + _chunk(b"IEND", b"")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(data)
    return path


def gif_lzw_literal(indices: np.ndarray) -> bytes:
    """The LZW image data of 8-bit `indices` (minimum code size 8) as literal 9-bit
    codes: a clear code (256) before every 254 pixels, the end code (257) last, packed
    least significant bit first, in sub-blocks of at most 255 bytes."""
    px = np.asarray(indices, np.uint8).reshape(-1).astype(np.uint16)
    n = px.size
    groups = -(-n // _LITERALS_PER_CLEAR)
    padded = np.full(groups * _LITERALS_PER_CLEAR, 0xFFFF, np.uint16)
    padded[:n] = px
    codes = np.concatenate([np.full((groups, 1), 256, np.uint16), padded.reshape(groups, -1)], axis=1).reshape(-1)
    codes = np.concatenate([codes[codes != 0xFFFF], np.array([257], np.uint16)])
    bits = ((codes[:, None] >> np.arange(9, dtype=np.uint16)) & 1).astype(np.uint8).reshape(-1)
    stream = np.packbits(bits, bitorder="little").tobytes()
    blocks = b"".join(bytes([len(stream[i : i + 255])]) + stream[i : i + 255] for i in range(0, len(stream), 255))
    return bytes([8]) + blocks + b"\x00"


def save_video(frames, filename: str, fps: int = 30) -> str:
    """Write (H, W) uint8 index frames into TURBO_U8 as an animated GIF (looping, 1 / fps
    s a frame, in whole hundredths) at `filename`.gif; returns that path."""
    frames = [np.asarray(f) for f in frames]
    if not frames:
        raise ValueError("save_video needs at least one frame")
    H, W = frames[0].shape
    if any(f.shape != (H, W) or f.dtype != np.uint8 for f in frames):
        raise ValueError("save_video takes (H, W) uint8 index frames of one shape")
    delay = max(1, round(100 / fps))  # GIF delays are in hundredths of a second
    out = [b"GIF89a", struct.pack("<HHBBB", W, H, 0xF7, 0, 0), TURBO_U8.tobytes(),
           b"\x21\xff\x0bNETSCAPE2.0\x03\x01\x00\x00\x00"]  # loop forever
    for f in frames:
        out.append(b"\x21\xf9\x04\x00" + struct.pack("<H", delay) + b"\x00\x00")  # graphic control
        out.append(b"\x2c" + struct.pack("<HHHHB", 0, 0, W, H, 0))  # image descriptor, no local palette
        out.append(gif_lzw_literal(f))
    out.append(b"\x3b")
    path = f"{filename}.gif"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(b"".join(out))
    return path
