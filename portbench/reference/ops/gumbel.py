"""Gumbel-sigmoid (binary relaxed Bernoulli) with a straight-through estimator.

Counterpart of dusty_gan_v2_tpu/ops/gumbel.py: the differentiable LiDAR ray-drop
sampler. Randomness is explicit: pass `logistic_noise`, or draw it with
`sample_logistic` from a torch.Generator.
"""

from __future__ import annotations

import torch

__all__ = ["gumbel_sigmoid", "sample_logistic"]


def sample_logistic(
    generator: torch.Generator, shape, device=None, dtype=torch.float32, eps: float = 1e-7
) -> torch.Tensor:
    """Logistic(0,1) noise: log(u) - log(1-u), u ~ U(eps, 1-eps).

    The generator must live on `device` (a CUDA generator for CUDA noise)."""
    u = torch.empty(shape, device=device, dtype=dtype).uniform_(eps, 1.0 - eps, generator=generator)
    return torch.log(u) - torch.log1p(-u)


def gumbel_sigmoid(
    logits: torch.Tensor,
    logistic_noise: torch.Tensor,
    temperature: float = 1.0,
    straight_through: bool = True,
) -> torch.Tensor:
    """sigmoid((logits + L) / temperature); with straight_through the forward value is
    the hard threshold at 0.5 and the gradient is the soft one."""
    soft = torch.sigmoid((logits + logistic_noise) / temperature)
    if straight_through:
        hard = (soft > 0.5).to(logits.dtype)
        return soft + (hard - soft).detach()
    return soft
