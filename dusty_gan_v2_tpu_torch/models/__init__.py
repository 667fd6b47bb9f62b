"""Models of the PyTorch port (counterparts of dusty_gan_v2_tpu/models)."""

from .builder import build_discriminator, build_generator
from .dusty_v1 import apply_raydrop
from .dusty_v2 import Discriminator, Generator, build_pe_cache
from .heads import resolve_act
from .loss import GAN_OBJECTIVES, gan_loss_d, gan_loss_g

__all__ = [
    "build_discriminator", "build_generator", "apply_raydrop", "Discriminator", "Generator", "build_pe_cache",
    "resolve_act", "GAN_OBJECTIVES", "gan_loss_d", "gan_loss_g",
]
