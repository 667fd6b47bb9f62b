"""Equalized learning-rate dense layer (counterpart of dusty_gan_v2_tpu/ops/linear.py).

The weight is stored (out, in), drawn N(0, 1/lr_mul), and scaled at run time by
1/sqrt(in); the output by gain * lr_mul.
"""

from __future__ import annotations

import math

import torch
from torch import nn

__all__ = ["EqualLRDense"]


class EqualLRDense(nn.Module):
    """y = (x @ (W * scale).T + b) * gain * lr_mul."""

    def __init__(
        self, in_features: int, features: int, use_bias: bool = True,
        gain: float = 1.0, lr_mul: float = 1.0,
    ):
        super().__init__()
        self.in_features, self.features = in_features, features
        self.gain, self.lr_mul = gain, lr_mul
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0 / self.lr_mul, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = 1.0 / math.sqrt(self.in_features)
        y = torch.matmul(x, (self.weight * scale).to(x.dtype).t())
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y * (self.gain * self.lr_mul)
