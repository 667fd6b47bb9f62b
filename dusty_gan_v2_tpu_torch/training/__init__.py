"""Training-step pieces of the port (counterpart of dusty_gan_v2_tpu/training)."""

from .trainer import d_phase_loss, g_phase_loss, r1_penalty

__all__ = ["g_phase_loss", "d_phase_loss", "r1_penalty"]
