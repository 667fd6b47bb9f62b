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
baseline. It takes the state itself or its flax state dict (what the JAX CLI's
checkpoint file holds: the fields as keys, the chain as {"0": {"count", "mu", "nu"},
"1": {}}). `jax_train_state_dict` is the inverse: the port's TrainState as that state
dict, which convert/flax_msgpack.py writes in the JAX CLI's format.

`load_jax_squeezeseg` carries a flax SqueezeSeg's {"params", "batch_stats"} tree into the
port's SqueezeSegV1 / V2: BatchNorm's running statistics become the buffers under the
same paths (conv1b.bn.running_mean).

The JAX PointNet keeps its parameters in a nested dict shaped like the torch state dict
(pointnet.py::init_pointnet_params), so it flattens the same way; a pointwise-conv
weight may come as (O, I) or (O, I, 1).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict

import numpy as np
import torch

__all__ = [
    "COLLECTIONS", "flatten_variables", "jax_variables_to_state_dict", "load_jax_variables",
    "pointnet_params_to_state_dict", "load_pointnet_params", "load_jax_train_state", "jax_train_state_dict",
    "load_jax_squeezeseg", "unflatten",
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
            flat[key] = value if isinstance(value, torch.Tensor) else np.asarray(value)


def unflatten(flat: Mapping[str, Any]) -> Dict:
    """{"a.b.c": leaf} -> {"a": {"b": {"c": leaf}}}."""
    out: Dict = {}
    for key, value in flat.items():
        node = out
        *path, last = key.split(".")
        for p in path:
            node = node.setdefault(p, {})
        node[last] = value
    return out


def _tensor(v) -> torch.Tensor:
    return v.clone() if isinstance(v, torch.Tensor) else torch.from_numpy(np.array(v, copy=True))


def jax_variables_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    return {k: _tensor(v) for k, v in flatten_variables(variables).items()}


def load_jax_variables(model: torch.nn.Module, variables: Mapping) -> torch.nn.Module:
    """Load a JAX generator's or discriminator's variables into the port model; a
    missing or extra key fails (strict=True)."""
    model.load_state_dict(jax_variables_to_state_dict(variables), strict=True)
    return model


def load_jax_squeezeseg(model: torch.nn.Module, variables: Mapping) -> torch.nn.Module:
    """Load a flax SqueezeSeg's {"params", "batch_stats"} into the port model
    (strict=True); the running statistics go into the BN buffers."""
    extra = set(variables) - {"params", "batch_stats"}
    if extra:
        raise ValueError(f"unexpected variable collections: {sorted(extra)}")
    return load_jax_variables(model, {"params": variables["params"], "stats": variables.get("batch_stats", {})})


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


def _field(obj, name: str):
    """A field of a JAX state or of its flax state dict."""
    return obj[name] if isinstance(obj, Mapping) else getattr(obj, name)


def _adam_moments(opt_state):
    """The (count, mu, nu) of an optax adam chain state (its ScaleByAdamState), or of
    the chain's flax state dict."""
    if isinstance(opt_state, Mapping):
        parts = [opt_state] if "mu" in opt_state else list(opt_state.values())
    else:
        parts = opt_state if isinstance(opt_state, (tuple, list)) else (opt_state,)
    for part in parts:
        if all((a in part) if isinstance(part, Mapping) else hasattr(part, a) for a in ("count", "mu", "nu")):
            return _field(part, "count"), _field(part, "mu"), _field(part, "nu")
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
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": _tensor(mu[key]).to(device=p.device, dtype=torch.float32),
            "exp_avg_sq": _tensor(nu[key]).to(device=p.device, dtype=torch.float32),
        }


def load_jax_train_state(state, jax_state):
    """Load a JAX GANTrainState, or its flax state dict (leaves as numpy or JAX arrays
    or tensors), into the port's TrainState in place and return it. G and G_ema take
    params / stats / consts, D its params, each Adam its moments and step count; a
    missing or extra key fails."""
    from ..augment.ada import AdaState

    f = lambda name: _field(jax_state, name)  # noqa: E731
    consts = f("consts_G")
    load_jax_variables(state.G, {"params": f("params_G"), "stats": f("stats_G"), "consts": consts})
    load_jax_variables(state.G_ema, {"params": f("params_G_ema"), "stats": f("stats_G_ema"), "consts": consts})
    load_jax_variables(state.D, {"params": f("params_D")})
    _load_adam(state.opt_G, state.G, f("opt_G"))
    _load_adam(state.opt_D, state.D, f("opt_D"))
    dev = state.pl_ema.device
    scalar = lambda v: torch.tensor(float(v), dtype=torch.float32, device=dev)  # noqa: E731
    ada = f("ada")
    state.ada = AdaState(**{k: scalar(_field(ada, k)) for k in ("p", "sign_cum", "n_pred_cum")})
    state.pl_ema = scalar(f("pl_ema"))
    state.step = int(f("step"))
    return state


def _g_collections(G: torch.nn.Module) -> Dict[str, Dict]:
    """G's state_dict as the JAX collections: parameters, the stats buffers (w_avg and
    the modulated convs' ema_var) and the consts (the Fourier banks)."""
    params = {k: v.detach() for k, v in G.named_parameters()}
    bufs = {k: v.detach() for k, v in G.named_buffers()}
    stats = {k: v for k, v in bufs.items() if k.endswith(("w_avg", "ema_var"))}
    return {"params": unflatten(params), "stats": unflatten(stats),
            "consts": unflatten({k: v for k, v in bufs.items() if k not in stats})}


def _adam_state_dict(opt: torch.optim.Optimizer, model: torch.nn.Module) -> Dict:
    """An Adam's moments as optax's (ScaleByAdamState, EmptyState) chain in flax's state
    dict form."""
    named = list(model.named_parameters())
    fresh = lambda p: {"step": torch.zeros(()), "exp_avg": torch.zeros_like(p), "exp_avg_sq": torch.zeros_like(p)}  # noqa: E731
    st = {k: opt.state[p] if p in opt.state else fresh(p) for k, p in named}
    steps = {float(v["step"]) for v in st.values()}
    if len(steps) != 1:
        raise ValueError(f"the parameters took different numbers of Adam steps: {sorted(steps)}")
    mu = unflatten({k: v["exp_avg"].detach() for k, v in st.items()})
    nu = unflatten({k: v["exp_avg_sq"].detach() for k, v in st.items()})
    return {"0": {"count": torch.tensor(int(steps.pop()), dtype=torch.int32), "mu": mu, "nu": nu}, "1": {}}


def jax_train_state_dict(state) -> Dict:
    """The port's TrainState as the flax state dict of a JAX GANTrainState (tensors
    as leaves, on their devices): the inverse of load_jax_train_state."""
    g, g_ema = _g_collections(state.G), _g_collections(state.G_ema)
    f32 = lambda v: v.detach().to(torch.float32).reshape(())  # noqa: E731
    return {
        "step": torch.tensor(int(state.step), dtype=torch.int32),
        "params_G": g["params"], "stats_G": g["stats"], "consts_G": g["consts"],
        "params_D": unflatten({k: v.detach() for k, v in state.D.named_parameters()}),
        "params_G_ema": g_ema["params"], "stats_G_ema": g_ema["stats"],
        "opt_G": _adam_state_dict(state.opt_G, state.G), "opt_D": _adam_state_dict(state.opt_D, state.D),
        "ada": {k: f32(getattr(state.ada, k)) for k in ("p", "sign_cum", "n_pred_cum")},
        "pl_ema": f32(state.pl_ema),
    }
