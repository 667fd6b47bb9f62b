"""The non-saturating GAN objective (nsgan), the one both benchmarked configurations set
(counterpart of dusty_gan_v2_tpu/models/loss.py). Pure functions of (B, 1) logits."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["gan_loss_g", "gan_loss_d"]


def gan_loss_d(pred_real: torch.Tensor, pred_fake: torch.Tensor) -> torch.Tensor:
    return F.softplus(-pred_real).mean() + F.softplus(pred_fake).mean()


def gan_loss_g(pred_fake: torch.Tensor) -> torch.Tensor:
    return F.softplus(-pred_fake).mean()
