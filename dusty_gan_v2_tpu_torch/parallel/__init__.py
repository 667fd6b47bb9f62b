"""Data parallelism and per-sample randomness of the port (counterpart of
dusty_gan_v2_tpu/parallel)."""

from .mesh import (
    all_gather_rows, axis_pmean, axis_psum, barrier, bound, init_distributed, is_chief, local_batch,
    pmean_, pmean_flat_, pmean_grads_, psum_, rank, shutdown, world_size,
)
from .persample import PerSampleStream, ReplayStream, fold_seed, global_ids

__all__ = [
    "PerSampleStream", "ReplayStream", "fold_seed", "global_ids", "init_distributed", "shutdown", "bound", "rank",
    "world_size", "is_chief", "local_batch", "barrier", "axis_psum", "axis_pmean", "all_gather_rows",
    "psum_", "pmean_", "pmean_flat_", "pmean_grads_",
]
