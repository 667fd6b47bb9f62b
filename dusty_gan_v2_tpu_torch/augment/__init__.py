"""Augmentation of the port (counterpart of dusty_gan_v2_tpu/augment)."""

from .ada import AdaptiveAugment, AdaState
from .diff_augment import DiffAugment

__all__ = ["AdaptiveAugment", "AdaState", "DiffAugment"]
