"""Pixel normalization (counterpart of dusty_gan_v2_tpu/ops/normalize.py::pixel_norm)."""

from __future__ import annotations

import torch

__all__ = ["pixel_norm"]


def pixel_norm(x: torch.Tensor, dim: int = 1, alpha: float = 1e-8) -> torch.Tensor:
    """x / sqrt(mean(x^2) + alpha) over `dim` (the channel dim)."""
    return x / torch.sqrt(torch.mean(torch.square(x), dim=dim, keepdim=True) + alpha)
