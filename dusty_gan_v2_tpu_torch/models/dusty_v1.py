"""DUSty v1: the vanilla synthesis and the differentiable ray-drop measurement model
(counterpart of dusty_gan_v2_tpu/models/dusty_v1.py: apply_raydrop, Generator)."""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..ops import gumbel_sigmoid, sample_logistic
from . import vanilla

__all__ = ["apply_raydrop", "Generator"]


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


class Generator(vanilla.Generator):
    """The vanilla generator + the ray-drop measurement: returns image, raydrop_logit, w
    (B, 1, in_ch), raydrop_mask and image_orig."""

    has_raydrop = True  # draws logistic noise of raydrop_logit's shape

    def __init__(self, synthesis_kwargs: dict, measurement_kwargs: dict):
        super().__init__(synthesis_kwargs)
        self.measurement_kwargs = dict(measurement_kwargs)

    def forward(
        self,
        z: torch.Tensor,
        angle: Optional[torch.Tensor] = None,
        truncation_psi: float = 1.0,
        gumbel_noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        pe_cache=None,
        train: bool = False,
        aug_shift: Optional[torch.Tensor] = None,
        input_w: bool = False,
        style_mixing: bool = False,
        mixing=None,
    ) -> Dict[str, torch.Tensor]:
        """z (B, D) -> dict of image, raydrop_logit, w, raydrop_mask, image_orig. `angle`
        is not read. Without `gumbel_noise` the logistic noise is drawn from `generator`,
        after style mixing's draws where `style_mixing` is on and `mixing` is not given."""
        o = super().forward(z, truncation_psi=truncation_psi, generator=generator, pe_cache=pe_cache, train=train,
                            aug_shift=aug_shift, input_w=input_w, style_mixing=style_mixing, mixing=mixing)
        if gumbel_noise is None:
            if generator is None:
                raise ValueError("pass gumbel_noise or a torch.Generator to draw it")
            logit = o["raydrop_logit"]
            gumbel_noise = sample_logistic(generator, logit.shape, logit.device, logit.dtype)
        return apply_raydrop(
            o,
            gumbel_noise,
            raydrop_const=float(self.measurement_kwargs.get("raydrop_const", -1)),
            gumbel_temperature=float(self.measurement_kwargs.get("gumbel_temperature", 1.0)),
        )
