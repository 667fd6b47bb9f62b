"""The discriminator's activation -> blur chain as the unfused pair of plain operations."""

from __future__ import annotations

import torch

from .act import SQRT2, fused_leaky_relu
from .resample import ResamplePlan, resample

__all__ = ["fused_act_resample", "fused_resample"]


def fused_resample(x: torch.Tensor, plan: ResamplePlan) -> torch.Tensor:
    return resample(x, plan)


def fused_act_resample(
    x: torch.Tensor, bias: torch.Tensor, plan: ResamplePlan, negative_slope: float = 0.2, scale: float = SQRT2
) -> torch.Tensor:
    return resample(fused_leaky_relu(x, bias, negative_slope, scale), plan)
