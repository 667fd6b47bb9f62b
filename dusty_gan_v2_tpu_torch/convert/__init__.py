"""Weight conversion into the PyTorch port: JAX variables and train states
(jax_variables.py), flax msgpack files (flax_msgpack.py), orbax checkpoint items
(orbax.py over ocdbt.py, zarr2.py and zstd.py) and the reference implementation's
`.pth` state_dicts (torch_weights.py)."""

from . import flax_msgpack, ocdbt, orbax, zarr2, zstd
from .jax_variables import (
    flatten_variables,
    jax_train_state_dict,
    jax_variables_to_state_dict,
    load_jax_squeezeseg,
    load_jax_train_state,
    load_jax_variables,
    load_pointnet_params,
    pointnet_params_to_state_dict,
    unflatten,
)
from .torch_weights import (
    convert_discriminator_state,
    convert_generator_state,
    convert_squeezeseg_state,
    load_reference_checkpoint,
    load_reference_state,
    reference_state_dict,
)

__all__ = [
    "flax_msgpack", "ocdbt", "orbax", "zarr2", "zstd", "flatten_variables", "jax_train_state_dict", "jax_variables_to_state_dict", "load_jax_squeezeseg",
    "load_jax_train_state", "load_jax_variables", "load_pointnet_params", "pointnet_params_to_state_dict", "unflatten",
    "convert_discriminator_state", "convert_generator_state", "convert_squeezeseg_state", "load_reference_checkpoint",
    "load_reference_state", "reference_state_dict",
]
