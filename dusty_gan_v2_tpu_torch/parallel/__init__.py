"""Per-sample randomness of the port (counterpart of dusty_gan_v2_tpu/parallel)."""

from .persample import PerSampleStream, ReplayStream, fold_seed, global_ids

__all__ = ["PerSampleStream", "ReplayStream", "fold_seed", "global_ids"]
