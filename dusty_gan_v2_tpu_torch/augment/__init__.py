"""Augmentation of the port (counterpart of dusty_gan_v2_tpu/augment)."""

from .ada import AdaptiveAugment, AdaState

__all__ = ["AdaptiveAugment", "AdaState"]
