"""JAX generator variables -> the port's state_dict.

The port's submodules carry the flax scope names, so the bridge is a flatten of the
nested {"params", "stats", "consts"} trees into dotted paths: params become
parameters, "stats" (w_avg, ema_var) and "consts" (Fourier freqs, phase) become
buffers under the same paths. Leaves may be numpy or JAX arrays (anything
np.asarray takes); nothing of JAX is imported here.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict

import numpy as np
import torch

__all__ = ["COLLECTIONS", "flatten_variables", "jax_variables_to_state_dict", "load_jax_variables"]

COLLECTIONS = ("params", "stats", "consts")


def flatten_variables(variables: Mapping) -> Dict[str, np.ndarray]:
    """{"params": {...}, "stats": {...}, "consts": {...}} -> {"a.b.c": array}."""
    extra = set(variables) - set(COLLECTIONS)
    if extra:
        raise ValueError(f"unexpected variable collections: {sorted(extra)}")
    flat: Dict[str, np.ndarray] = {}

    def walk(prefix: str, node: Mapping) -> None:
        for name, value in node.items():
            key = f"{prefix}.{name}" if prefix else str(name)
            if isinstance(value, Mapping):
                walk(key, value)
            elif key in flat:
                raise ValueError(f"{key} appears in two collections")
            else:
                flat[key] = np.asarray(value)

    for col in COLLECTIONS:
        walk("", variables.get(col, {}))
    return flat


def jax_variables_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in flatten_variables(variables).items()}


def load_jax_variables(model: torch.nn.Module, variables: Mapping) -> torch.nn.Module:
    """Load a JAX generator's variables into the port model; a missing or extra key
    fails (strict=True)."""
    model.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    return model
