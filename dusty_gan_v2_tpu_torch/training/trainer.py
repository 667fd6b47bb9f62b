"""The discriminator-side loss phases of the training step.

Counterparts of the closures inside dusty_gan_v2_tpu/training/trainer.py::_build_step
(g_loss_fn's adversarial term, d_loss_fn, r1_loss_fn), as plain functions of a
discriminator module and image batches, without the warmup, ADA, optimizers and EMA
around them. Every call takes the discriminator's unfused route (blur_fuse=False), as
every training call of the JAX step does: on the card that is the route of the fused
chain kernels.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..models.loss import gan_loss_d, gan_loss_g

__all__ = ["g_phase_loss", "d_phase_loss", "r1_penalty"]


def g_phase_loss(
    D: nn.Module, x_fake: torch.Tensor, metric: str = "nsgan", x_real: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """The generator's adversarial loss on D's logits. Gradients flow to `x_fake` (and
    on to the generator that made it); `x_real`, which only the relativistic objectives
    read, is detached."""
    y_fake = D(x_fake, blur_fuse=False)
    y_real = None if x_real is None else D(x_real.detach(), blur_fuse=False)
    return gan_loss_g(y_real, y_fake, metric)


def d_phase_loss(D: nn.Module, x_real: torch.Tensor, x_fake: torch.Tensor, metric: str = "nsgan") -> torch.Tensor:
    """The discriminator's adversarial loss. Reals and fakes go through D separately:
    the minibatch-stddev statistic must not mix them. Both inputs are detached."""
    y_real = D(x_real.detach(), blur_fuse=False)
    y_fake = D(x_fake.detach(), blur_fuse=False)
    return gan_loss_d(y_real, y_fake, metric)


def r1_penalty(D: nn.Module, x_real: torch.Tensor) -> torch.Tensor:
    """mean_b sum_chw (d sum(D(x)) / dx)^2 on real images, built with create_graph so
    that its gradient with respect to D's parameters is a double backward through D."""
    x = x_real.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(D(x, blur_fuse=False).sum(), x, create_graph=True)
    return g.square().sum(dim=(1, 2, 3)).mean()
