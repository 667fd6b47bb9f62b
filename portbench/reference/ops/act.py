"""Bias + leaky ReLU + scale, y = leaky_relu(x + bias[c], 0.2) * sqrt(2), in plain torch
operations (autograd differentiates it to any order)."""

from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["fused_leaky_relu", "FusedLeakyReLU"]

SQRT2 = math.sqrt(2.0)


def fused_leaky_relu(
    x: torch.Tensor, bias: torch.Tensor, negative_slope: float = 0.2, scale: float = SQRT2
) -> torch.Tensor:
    """leaky_relu(x + bias) * scale, bias over axis 1; the math in float32 (float64 for
    float64 input), one rounding to x's dtype."""
    acc = torch.promote_types(x.dtype, torch.float32)
    bias = bias.to(x.dtype).reshape((1, -1) + (1,) * (x.ndim - 2))
    y = x.to(acc) + bias.to(acc)
    y = torch.where(y >= 0, y, y * negative_slope) * scale
    return y.to(x.dtype)


class FusedLeakyReLU(nn.Module):
    """Learned per-channel bias + leaky ReLU + sqrt(2) scale."""

    def __init__(self, ch: int, negative_slope: float = 0.2, scale: float = SQRT2):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(ch))
        self.negative_slope = negative_slope
        self.scale = scale

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_leaky_relu(x, self.bias, self.negative_slope, self.scale)
