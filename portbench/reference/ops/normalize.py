"""Pixel normalization and minibatch standard deviation (counterpart of
dusty_gan_v2_tpu/ops/normalize.py)."""

from __future__ import annotations

import torch

__all__ = ["pixel_norm", "minibatch_stddev"]


def pixel_norm(x: torch.Tensor, dim: int = 1, alpha: float = 1e-8) -> torch.Tensor:
    """x / sqrt(mean(x^2) + alpha) over `dim` (the channel dim)."""
    return x / torch.sqrt(torch.mean(torch.square(x), dim=dim, keepdim=True) + alpha)


def _stddev_feature(x: torch.Tensor, group: int, features: int, alpha: float) -> torch.Tensor:
    """Per-sample (B, F, 1, 1) stddev feature. The batch is reshaped to
    (group, B // group, ...), so the members of a group lie B // group apart."""
    B, C, H, W = x.shape
    g = min(B, group)
    y = x.reshape(g, B // g, features, C // features, H, W)
    y = torch.sqrt(y.var(dim=0, unbiased=False) + alpha)
    y = y.mean(dim=(2, 3, 4))  # (B // g, F)
    return y.repeat(g, 1).reshape(B, features, 1, 1)


def minibatch_stddev(x: torch.Tensor, group: int = 4, features: int = 1, alpha: float = 1e-8) -> torch.Tensor:
    """Append the per-group stddev statistic as `features` extra channels (NCHW)."""
    B, C, H, W = x.shape
    y = _stddev_feature(x, group, features, alpha)
    return torch.cat([x, y.to(x.dtype).expand(B, features, H, W)], dim=1)
