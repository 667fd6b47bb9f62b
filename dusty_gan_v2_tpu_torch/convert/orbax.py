"""orbax checkpoint items (the `state/` directory of the JAX CLI's --ckpt_backend orbax),
read and written without orbax, tensorstore or JAX.

An item directory written by orbax 0.11's StandardCheckpointHandler with OCDBT holds

    _METADATA             JSON: "tree_metadata" {"('a', 'b')": {"key_metadata": [{"key": "a",
                          "key_type": 2}, ...], "value_metadata": {"value_type": "jax.Array" |
                          "np.ndarray" | "Dict", "skip_deserialize": ..., "write_shape": ...}}},
                          "use_ocdbt": true, "use_zarr3": false, ...
    _CHECKPOINT_METADATA  JSON: the handler's name and the save's timestamps
    _sharding             JSON: base64(array name) -> the array's sharding as JSON text
    array_metadatas/process_0   JSON: each array's write and chunk shapes
    manifest.ocdbt, d/, ocdbt.process_<i>/   the OCDBT database (convert/ocdbt.py) of zarr v2
                          arrays (convert/zarr2.py), an array named by its keys joined by "."

`read_item` rebuilds the nested dict from tree_metadata: every array a CPU tensor of its
dtype, every empty-Dict leaf an empty dict. For a flax state dict this is exactly what
convert/flax_msgpack.py returns for the same state's msgpack file. `write_item` writes
that layout from such a nested dict, every array as a jax.Array on one device (a one-
device NamedSharding over device id 0, as the JAX package's Trainer places its state),
so that orbax restores it with and without a template.
"""

from __future__ import annotations

import base64
import json
import time
from pathlib import Path
from typing import Any, Dict, List, Tuple, Union

import torch

from . import ocdbt, zarr2

__all__ = ["read_item", "write_item", "HANDLER"]

HANDLER = "orbax.checkpoint._src.handlers.standard_checkpoint_handler.StandardCheckpointHandler"
_ARRAY_TYPES = ("jax.Array", "np.ndarray")
_DICT_KEY = 2  # orbax's KeyType.DICT
_SHARDING = json.dumps({"sharding_type": "NamedSharding", "shape": [1], "axis_names": ["data"],
                        "axis_types": ["AxisType.Auto"], "partition_spec": [], "device_mesh": {"mesh": [{"id": 0}]}})


def read_item(path: Union[str, Path]) -> Dict[str, Any]:
    """The nested dict of the orbax item directory `path`."""
    path = Path(path)
    meta_path = path / "_METADATA"
    if not meta_path.is_file():
        raise ValueError(f"orbax: {path} holds no _METADATA (not an orbax checkpoint item)")
    meta = json.loads(meta_path.read_text())
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError(f"orbax: {path}: only OCDBT with zarr v2 is read (use_ocdbt {meta.get('use_ocdbt')}, "
                         f"use_zarr3 {meta.get('use_zarr3')})")
    db = ocdbt.Database(path)
    tree: Dict[str, Any] = {}
    for name, entry in meta["tree_metadata"].items():
        keys = []
        for km in entry["key_metadata"]:
            if km.get("key_type") != _DICT_KEY:
                raise ValueError(f"orbax: {path}: {name} has a key of type {km.get('key_type')}; only dict keys "
                                 "are read")
            keys.append(str(km["key"]))
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        value = entry["value_metadata"]
        kind = value.get("value_type")
        if kind in _ARRAY_TYPES:
            node[keys[-1]] = zarr2.read_array(db, ".".join(keys))
        elif kind == "Dict" and value.get("skip_deserialize"):
            node[keys[-1]] = {}
        else:
            raise ValueError(f"orbax: {path}: {name} has value type {kind!r}; only arrays and empty dicts are read")
    return tree


def _leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()) -> List[Tuple[Tuple[str, ...], Any]]:
    out = []
    for k, v in tree.items():
        if not isinstance(k, str):
            raise TypeError(f"orbax: keys must be str, got {k!r} at {prefix}")
        if isinstance(v, dict) and v:
            out.extend(_leaves(v, prefix + (k,)))
        elif isinstance(v, dict) or torch.is_tensor(v):
            out.append((prefix + (k,), v))
        else:
            raise TypeError(f"orbax: cannot write a {type(v).__name__} at {prefix + (k,)}")
    return out


def _key_name(keys: Tuple[str, ...]) -> str:
    return str(keys)  # orbax's tree_metadata key: the tuple's repr, e.g. "('params', 'w')"


def write_item(path: Union[str, Path], tree: Dict[str, Any]) -> Dict[str, int]:
    """Write the nested dict `tree` (str keys; CPU tensors, or empty dicts) as an orbax item
    directory `path`, which must not exist. Returns the OCDBT statistics."""
    path = Path(path)
    t0 = time.time_ns()
    leaves = sorted(_leaves(tree), key=lambda kv: _key_name(kv[0]))
    tree_meta, sharding, arrays, entries = {}, {}, [], {}
    for keys, v in leaves:
        key_meta = [{"key": k, "key_type": _DICT_KEY} for k in keys]
        if isinstance(v, dict):
            tree_meta[_key_name(keys)] = {"key_metadata": key_meta,
                                          "value_metadata": {"value_type": "Dict", "skip_deserialize": True}}
            continue
        name, shape = ".".join(keys), [int(s) for s in v.shape]
        tree_meta[_key_name(keys)] = {"key_metadata": key_meta, "value_metadata": {
            "value_type": "jax.Array", "skip_deserialize": False, "write_shape": shape}}
        sharding[base64.b64encode(name.encode()).decode()] = _SHARDING
        arrays.append({"array_metadata": {"param_name": name, "write_shape": shape, "chunk_shape": shape,
                                          "ext_metadata": None}})
        entries.update(zarr2.encode_array(name, v))
    stats = ocdbt.write_database(path, entries)
    (path / "_METADATA").write_text(json.dumps({
        "tree_metadata": tree_meta, "use_ocdbt": True, "use_zarr3": False,
        "store_array_data_equal_to_fill_value": True, "custom_metadata": None}))
    (path / "_sharding").write_text(json.dumps(sharding, separators=(",", ":")))
    (path / "array_metadatas").mkdir()
    (path / "array_metadatas" / "process_0").write_text(json.dumps({"array_metadatas": arrays}))
    (path / "_CHECKPOINT_METADATA").write_text(json.dumps({
        "item_handlers": HANDLER, "metrics": {}, "performance_metrics": {}, "init_timestamp_nsecs": t0,
        "commit_timestamp_nsecs": time.time_ns(), "custom_metadata": {}}))
    return stats
