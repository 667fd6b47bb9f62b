"""The reference's models: the DUSty v2 generator and discriminator, the DUSty v1
generator and the vanilla discriminator, and the nsgan loss."""

from .factory import build_discriminator, build_generator
from .dusty_v2 import build_pe_cache
from .loss import gan_loss_d, gan_loss_g

__all__ = ["build_generator", "build_discriminator", "build_pe_cache", "gan_loss_d", "gan_loss_g"]
