"""The training step of the port (counterpart of dusty_gan_v2_tpu/training)."""

from .accumulation import microbatch_value_and_grad
from .checkpoint import load_checkpoint, save_checkpoint
from .train_state import TrainState
from .trainer import (
    Schedule, Trainer, d_phase_loss, fetch_reals, g_phase_loss, make_blur_kernel, r1_penalty, warmup_fn,
)

__all__ = [
    "TrainState", "Schedule", "Trainer", "fetch_reals", "warmup_fn", "make_blur_kernel",
    "g_phase_loss", "d_phase_loss", "r1_penalty", "save_checkpoint", "load_checkpoint", "microbatch_value_and_grad",
]
