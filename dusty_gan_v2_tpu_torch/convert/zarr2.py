"""zarr v2 arrays in a key-value store (orbax's layout inside an OCDBT database), read and
written without zarr or tensorstore.

An array named `name` is the key `name/.zarray` (JSON: shape, chunks, dtype, compressor,
fill_value, order, filters, dimension_separator) and one key per chunk, its grid index
joined by the separator (`name/0.0`; a 0-d array's one chunk is `name/0`). A chunk holds
the full chunk shape in C order, an edge chunk padded past the array's end, compressed
by its compressor (zstd, or none); a missing chunk reads as fill_value (null: zeros).

dtypes: <f4, <f8, <i4, <i8, <u4, |b1 and bfloat16 (tensorstore's name; read as raw bytes
viewed as torch.bfloat16, as convert/flax_msgpack.py reads it). Anything else raises.

The writer emits what orbax 0.11 writes for an array: one chunk of the array's shape,
compressor {"id": "zstd", "level": 1}, fill_value null, and the chunk as a zstd frame
(raw blocks: convert/zstd.py::raw_frame).
"""

from __future__ import annotations

import itertools
import json
import math
from typing import Dict, Tuple

import numpy as np
import torch

from . import zstd

__all__ = ["DTYPES", "parse_zarray", "read_array", "zarray_json", "chunk_key", "encode_array"]

DTYPES = {"<f4": torch.float32, "<f8": torch.float64, "<i4": torch.int32, "<i8": torch.int64,
          "<u4": torch.uint32, "|b1": torch.bool, "bfloat16": torch.bfloat16}
_NAMES = {v: k for k, v in DTYPES.items()}


def parse_zarray(raw: bytes, name: str) -> Dict:
    """The checked .zarray of array `name`."""
    meta = json.loads(raw)
    if meta.get("zarr_format") != 2:
        raise ValueError(f"zarr: {name}: zarr_format {meta.get('zarr_format')!r}, expected 2")
    if meta.get("dtype") not in DTYPES:
        raise ValueError(f"zarr: {name}: unsupported dtype {meta.get('dtype')!r} (supported: {sorted(DTYPES)})")
    if meta.get("order", "C") != "C":
        raise ValueError(f"zarr: {name}: order {meta['order']!r}; only C order is read")
    if meta.get("filters"):
        raise ValueError(f"zarr: {name}: filters {meta['filters']!r} are not supported")
    comp = meta.get("compressor")
    if comp is not None and comp.get("id") != "zstd":
        raise ValueError(f"zarr: {name}: compressor {comp!r}; only zstd or none is read")
    shape, chunks = list(meta["shape"]), list(meta["chunks"])
    if len(shape) != len(chunks) or any(c <= 0 for c in chunks):
        raise ValueError(f"zarr: {name}: chunks {chunks} do not fit shape {shape}")
    return meta


def _fill(meta: Dict):
    v = meta.get("fill_value")
    if v is None:
        return 0
    if isinstance(v, str):
        return {"NaN": math.nan, "Infinity": math.inf, "-Infinity": -math.inf}[v]
    return v


def chunk_key(name: str, index: Tuple[int, ...], sep: str = ".") -> bytes:
    return f"{name}/{sep.join(str(i) for i in index) if index else '0'}".encode()


def read_array(store, name: str) -> torch.Tensor:
    """Array `name` of `store` (an object with `get(key) -> bytes` and `key in store`) as
    a CPU tensor."""
    meta = parse_zarray(store.get(f"{name}/.zarray".encode()), name)
    dtype, shape, chunks = DTYPES[meta["dtype"]], list(meta["shape"]), list(meta["chunks"])
    sep = meta.get("dimension_separator", ".")
    compressed = meta.get("compressor") is not None
    chunk_bytes = math.prod(chunks) * dtype.itemsize
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    one = shape == chunks  # one chunk that is the whole array: decode straight into the result
    out = None if one else torch.full(shape, _fill(meta), dtype=dtype)
    for index in itertools.product(*[range(g) for g in grid]):
        key = chunk_key(name, index, sep)
        if key not in store:
            if one:
                out = torch.full(shape, _fill(meta), dtype=dtype)
            continue
        raw = store.get(key)
        buf = torch.empty(chunk_bytes, dtype=torch.uint8)
        if compressed:
            got = zstd.decompress_into(raw, buf.numpy())
        else:
            got = len(raw)
            if got == chunk_bytes:
                buf.numpy()[:] = np.frombuffer(raw, np.uint8)
        if got != chunk_bytes:
            raise ValueError(f"zarr: {key.decode()}: {got} bytes, a chunk of {chunks} {meta['dtype']} is {chunk_bytes}")
        chunk = buf.view(dtype).reshape(chunks)
        if one:
            out = chunk
            continue
        dst = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(index, chunks, shape))
        out[dst] = chunk[tuple(slice(0, d.stop - d.start) for d in dst)]
    return out


def zarray_json(shape, dtype: torch.dtype) -> bytes:
    """The .zarray orbax writes for a one-chunk array."""
    if dtype not in _NAMES:
        raise ValueError(f"zarr: cannot write dtype {dtype}")
    shape = [int(s) for s in shape]
    meta = {"chunks": [max(1, s) for s in shape], "compressor": {"id": "zstd", "level": 1},
            "dimension_separator": ".", "dtype": _NAMES[dtype], "fill_value": None, "filters": None, "order": "C",
            "shape": shape, "zarr_format": 2}
    return json.dumps(meta, separators=(",", ":"), sort_keys=True).encode()


def encode_array(name: str, t: torch.Tensor) -> Dict[bytes, object]:
    """{key: value} of tensor `t` as array `name`: its .zarray and its one chunk (a list of
    buffers over the tensor's bytes, which must stay alive until written). An array with a
    zero-length dimension has no chunk."""
    t = t.detach().cpu().contiguous()
    out: Dict[bytes, object] = {f"{name}/.zarray".encode(): zarray_json(t.shape, t.dtype)}
    if t.numel():
        out[chunk_key(name, (0,) * t.dim())] = zstd.raw_frame(t.reshape(-1).view(torch.uint8).numpy())
    return out
