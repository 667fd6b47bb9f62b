"""JAX model variables and PointNet parameters -> the port's state_dicts.

The port's submodules carry the flax scope names, so the bridge is a flatten of the
nested {"params", "stats", "consts"} trees into dotted paths: params become
parameters, "stats" (w_avg, ema_var) and "consts" (Fourier freqs, phase) become
buffers under the same paths; a discriminator has the "params" collection only
({"params": {"res0": {"conv2": {"conv": {"weight": ...}}}}} -> res0.conv2.conv.weight).
Leaves may be numpy or JAX arrays (anything
np.asarray takes); nothing of JAX is imported here.

The JAX PointNet keeps its parameters in a nested dict shaped like the torch state dict
(pointnet.py::init_pointnet_params), so it flattens the same way; a pointwise-conv
weight may come as (O, I) or (O, I, 1).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch

__all__ = [
    "COLLECTIONS", "flatten_variables", "jax_variables_to_state_dict", "load_jax_variables",
    "pointnet_params_to_state_dict", "load_pointnet_params",
]

COLLECTIONS = ("params", "stats", "consts")


def flatten_variables(variables: Mapping) -> Dict[str, np.ndarray]:
    """{"params": {...}, "stats": {...}, "consts": {...}} -> {"a.b.c": array}."""
    extra = set(variables) - set(COLLECTIONS)
    if extra:
        raise ValueError(f"unexpected variable collections: {sorted(extra)}")
    flat: Dict[str, np.ndarray] = {}
    for col in COLLECTIONS:
        _walk(flat, "", variables.get(col, {}))
    return flat


def _walk(flat: Dict[str, np.ndarray], prefix: str, node: Mapping) -> None:
    for name, value in node.items():
        key = f"{prefix}.{name}" if prefix else str(name)
        if isinstance(value, Mapping):
            _walk(flat, key, value)
        elif key in flat:
            raise ValueError(f"{key} appears in two collections")
        else:
            flat[key] = np.asarray(value)


def jax_variables_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in flatten_variables(variables).items()}


def load_jax_variables(model: torch.nn.Module, variables: Mapping) -> torch.nn.Module:
    """Load a JAX generator's or discriminator's variables into the port model; a
    missing or extra key fails (strict=True)."""
    model.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    return model


def pointnet_params_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """The JAX PointNet pytree -> the state_dict of metrics/pointnet.py::PointNetFeatures."""
    flat: Dict[str, np.ndarray] = {}
    _walk(flat, "", params)
    out = {}
    for key, arr in flat.items():
        if key.endswith("weight") and arr.ndim == 3:  # conv1d (O, I, 1) -> (O, I)
            arr = arr[..., 0]
        out[key] = torch.from_numpy(np.array(arr, dtype=np.float32, copy=True))
    return out


def load_pointnet_params(model: torch.nn.Module, params: Mapping) -> torch.nn.Module:
    """Load a JAX PointNet pytree into the port's PointNetFeatures (strict=True)."""
    model.load_state_dict(pointnet_params_to_state_dict(params), strict=True)
    return model
