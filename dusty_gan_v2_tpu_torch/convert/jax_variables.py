"""JAX model variables and PointNet parameters -> the port's state_dicts.

The port's submodules carry the flax scope names, so the bridge is a flatten of the
nested {"params", "stats", "consts"} trees into dotted paths: params become
parameters, "stats" (w_avg, ema_var) and "consts" (Fourier freqs, phase) become
buffers under the same paths; a discriminator has the "params" collection only
({"params": {"res0": {"conv2": {"conv": {"weight": ...}}}}} -> res0.conv2.conv.weight).
Leaves may be numpy or JAX arrays (anything
np.asarray takes); nothing of JAX is imported here.

`load_jax_train_state` carries a whole JAX `GANTrainState` (training/train_state.py) into
the port's TrainState: the three variable trees, optax's Adam moments (its
(ScaleByAdamState(count, mu, nu), EmptyState()) chain state) under the same paths as
each optimizer's `step`, `exp_avg` and `exp_avg_sq`, the ADA controller and the PL
baseline.

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
    "pointnet_params_to_state_dict", "load_pointnet_params", "load_jax_train_state",
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


def _adam_moments(opt_state):
    """The (count, mu, nu) of an optax adam chain state (its ScaleByAdamState)."""
    for part in opt_state if isinstance(opt_state, (tuple, list)) else (opt_state,):
        if all(hasattr(part, a) for a in ("count", "mu", "nu")):
            return part.count, part.mu, part.nu
    raise ValueError("no ScaleByAdamState (count, mu, nu) in the optimizer state")


def _load_adam(opt: torch.optim.Optimizer, model: torch.nn.Module, opt_state) -> None:
    count, mu, nu = _adam_moments(opt_state)
    mu, nu = flatten_variables({"params": mu}), flatten_variables({"params": nu})
    params = dict(model.named_parameters())
    for name, tree in (("mu", mu), ("nu", nu)):
        if set(tree) != set(params):
            raise ValueError(
                f"Adam {name}: missing {sorted(set(params) - set(tree))[:5]}, extra {sorted(set(tree) - set(params))[:5]}"
            )
    opt_params = [p for group in opt.param_groups for p in group["params"]]
    if {id(p) for p in opt_params} != {id(p) for p in params.values()}:
        raise ValueError("the optimizer does not hold exactly the model's parameters")
    for key, p in params.items():
        opt.state[p] = {
            "step": torch.tensor(float(np.asarray(count)), dtype=torch.float32),
            "exp_avg": torch.from_numpy(np.array(mu[key], dtype=np.float32)).to(p.device),
            "exp_avg_sq": torch.from_numpy(np.array(nu[key], dtype=np.float32)).to(p.device),
        }


def load_jax_train_state(state, jax_state):
    """Load a JAX GANTrainState (leaves as numpy or JAX arrays) into the port's
    TrainState in place and return it. G and G_ema take params / stats / consts, D its
    params, each Adam its moments and step count; a missing or extra key fails."""
    from ..augment.ada import AdaState

    js = jax_state
    load_jax_variables(state.G, {"params": js.params_G, "stats": js.stats_G, "consts": js.consts_G})
    load_jax_variables(state.G_ema, {"params": js.params_G_ema, "stats": js.stats_G_ema, "consts": js.consts_G})
    load_jax_variables(state.D, {"params": js.params_D})
    _load_adam(state.opt_G, state.G, js.opt_G)
    _load_adam(state.opt_D, state.D, js.opt_D)
    dev = state.pl_ema.device
    scalar = lambda v: torch.tensor(float(np.asarray(v)), dtype=torch.float32, device=dev)  # noqa: E731
    state.ada = AdaState(p=scalar(js.ada.p), sign_cum=scalar(js.ada.sign_cum), n_pred_cum=scalar(js.ada.n_pred_cum))
    state.pl_ema = scalar(js.pl_ema)
    state.step = int(np.asarray(js.step))
    return state
