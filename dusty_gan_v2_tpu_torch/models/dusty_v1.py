"""Ray-drop measurement model (counterpart of dusty_gan_v2_tpu/models/dusty_v1.py::apply_raydrop)."""

from __future__ import annotations

from typing import Dict

import torch

from ..ops import gumbel_sigmoid

__all__ = ["apply_raydrop"]


def apply_raydrop(
    o: Dict[str, torch.Tensor],
    logistic_noise: torch.Tensor,
    raydrop_const: float = -1.0,
    gumbel_temperature: float = 1.0,
) -> Dict[str, torch.Tensor]:
    """Sample a hard-but-differentiable drop mask from `raydrop_logit` and composite:
    image = lerp(image, raydrop_const, 1 - mask)."""
    mask = gumbel_sigmoid(
        o["raydrop_logit"], logistic_noise, temperature=gumbel_temperature, straight_through=True
    )
    o = dict(o)
    o["raydrop_mask"] = mask
    o["image_orig"] = o["image"]
    o["image"] = o["image"] * mask + raydrop_const * (1.0 - mask)
    return o
