"""Weight conversion into the PyTorch port."""

from .jax_variables import (
    flatten_variables,
    jax_variables_to_state_dict,
    load_jax_squeezeseg,
    load_jax_train_state,
    load_jax_variables,
    load_pointnet_params,
    pointnet_params_to_state_dict,
)

__all__ = [
    "flatten_variables", "jax_variables_to_state_dict", "load_jax_squeezeseg", "load_jax_train_state", "load_jax_variables",
    "load_pointnet_params", "pointnet_params_to_state_dict",
]
