"""GAN objectives: nsgan / wgan / lsgan / hinge and their relativistic variants
(counterpart of dusty_gan_v2_tpu/models/loss.py). Pure functions of (B, 1) logits."""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["gan_loss_g", "gan_loss_d", "GAN_OBJECTIVES"]

GAN_OBJECTIVES = ("nsgan", "wgan", "lsgan", "hinge", "ragan", "rahinge", "ralsgan")


def _avg_diff(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return a - b.mean(dim=0, keepdim=True)


def gan_loss_d(pred_real: torch.Tensor, pred_fake: torch.Tensor, metric: str = "nsgan", smoothing: float = 1.0):
    if metric == "nsgan":
        return F.softplus(-pred_real).mean() + F.softplus(pred_fake).mean()
    if metric == "wgan":
        return -pred_real.mean() + pred_fake.mean()
    if metric == "lsgan":
        return ((pred_real - smoothing) ** 2).mean() + (pred_fake**2).mean()
    if metric == "hinge":
        return F.relu(1.0 - pred_real).mean() + F.relu(1.0 + pred_fake).mean()
    if metric == "ragan":
        return (
            F.softplus(-_avg_diff(pred_real, pred_fake)).mean() + F.softplus(_avg_diff(pred_fake, pred_real)).mean()
        )
    if metric == "rahinge":
        return (
            F.relu(1.0 - _avg_diff(pred_real, pred_fake)).mean() + F.relu(1.0 + _avg_diff(pred_fake, pred_real)).mean()
        )
    if metric == "ralsgan":
        return (
            ((_avg_diff(pred_real, pred_fake) - 1.0) ** 2).mean() + ((_avg_diff(pred_fake, pred_real) + 1.0) ** 2).mean()
        )
    raise NotImplementedError(metric)


def gan_loss_g(pred_real, pred_fake: torch.Tensor, metric: str = "nsgan"):
    """`pred_real` is read by the relativistic objectives only (None otherwise)."""
    if metric == "nsgan":
        return F.softplus(-pred_fake).mean()
    if metric in ("wgan", "hinge"):
        return -pred_fake.mean()
    if metric == "lsgan":
        return ((pred_fake - 1.0) ** 2).mean()
    if metric == "ragan":
        return (
            F.softplus(_avg_diff(pred_real, pred_fake)).mean() + F.softplus(-_avg_diff(pred_fake, pred_real)).mean()
        )
    if metric == "rahinge":
        return (
            F.relu(1.0 + _avg_diff(pred_real, pred_fake)).mean() + F.relu(1.0 - _avg_diff(pred_fake, pred_real)).mean()
        )
    if metric == "ralsgan":
        return (
            ((_avg_diff(pred_real, pred_fake) + 1.0) ** 2).mean() + ((_avg_diff(pred_fake, pred_real) - 1.0) ** 2).mean()
        )
    raise NotImplementedError(metric)
