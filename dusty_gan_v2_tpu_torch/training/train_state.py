"""The training state of the port (counterpart of dusty_gan_v2_tpu/training/train_state.py).

The JAX package carries one pytree through a jitted step; here the state is the live
modules and optimizers, which `Trainer.step` updates in place: G and its EMA copy
(parameters and buffers), D, one Adam for each network, the ADA controller, the
path-length baseline and the iteration count (training/checkpoint.py saves and loads it).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..augment.ada import AdaState

__all__ = ["TrainState"]


@dataclasses.dataclass
class TrainState:
    G: nn.Module
    G_ema: nn.Module
    D: nn.Module
    opt_G: torch.optim.Adam
    opt_D: torch.optim.Adam
    ada: AdaState
    pl_ema: torch.Tensor  # 0-dim float32, the path-length baseline
    step: int = 0  # iterations completed
