"""GAN-inversion toolkit: multiscale masked losses, the geodesic w+ regularizer, the
hypersphere projection, noise renormalization and the learning-rate schedule.

Counterpart of dusty_gan_v2_tpu/inversion/__init__.py; every function is plain torch on
tensors and differentiable where the JAX one is. The two-stage loop that uses them is
cli/demo_inversion.py.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.pad import pad2d

__all__ = [
    "masked_loss",
    "multiscale_masked_loss",
    "geocross_loss",
    "spherical_project",
    "normalize_noise",
    "stylegan2_lr_schedule",
]

_BLUR3 = (np.outer([1, 2, 1], [1, 2, 1]) / 16.0).astype(np.float32)


def masked_loss(img_ref, img_gen, mask, distance: str = "l1", relative: bool = True) -> torch.Tensor:
    """Per-sample masked L1 or L2 over the masked pixels, optionally relative to the
    reference (the masked error over img_ref + 1e-11)."""
    if distance == "l1":
        loss = (img_ref - img_gen).abs()
    elif distance == "l2":
        loss = (img_ref - img_gen) ** 2
    else:
        raise NotImplementedError(distance)
    if relative:
        loss = (loss * mask) / (img_ref + 1e-11)
    loss = (loss * mask).sum(dim=(1, 2, 3))
    return loss / (mask.sum(dim=(1, 2, 3)) + 1e-8)


def _blurpool(x: torch.Tensor) -> torch.Tensor:
    """Depthwise [1 2 1]^2 / 16 blur at stride 2 over ring (circular W, replicate H) padding 1."""
    C = x.shape[1]
    k = torch.as_tensor(_BLUR3, dtype=x.dtype, device=x.device).expand(C, 1, 3, 3)
    return F.conv2d(pad2d(x, 1, ring=True, mode="replicate"), k, stride=2, groups=C)


def _update_mask(mask: torch.Tensor):
    """(9 / count of valid pixels under each 3x3 stride-2 window (1 where none), the
    downsampled mask (1 where any))."""
    ones = torch.ones((1, 1, 3, 3), dtype=mask.dtype, device=mask.device)
    count = F.conv2d(pad2d(mask, 1, ring=True, mode="replicate"), ones, stride=2)
    norm = 9.0 / torch.where(count == 0, torch.ones_like(count), count)
    return norm, (count > 0).to(mask.dtype)


def multiscale_masked_loss(gen, ref, mask, level: Optional[int] = None, distance: str = "l1",
                           relative: bool = True) -> torch.Tensor:
    """Masked loss summed over a blur-pool pyramid of `level` scales (log2 H when None),
    each scale's images renormalized by the share of valid pixels under the blur."""
    level = int(np.log2(gen.shape[2])) if level is None else level
    loss = 0.0
    for _ in range(max(1, level)):
        loss = loss + masked_loss(ref, gen, mask, distance, relative)
        norm, new_mask = _update_mask(mask)
        gen = _blurpool(gen * mask) * norm
        ref = _blurpool(ref * mask) * norm
        mask = new_mask
    return loss


def geocross_loss(latents: torch.Tensor) -> torch.Tensor:
    """PULSE's geodesic cross term over w+ codes (B, N, D): the mean cubed angle between
    every pair of styles, over 8."""
    B, N, D = latents.shape
    X = latents.reshape(B, 1, N, D)
    Y = latents.reshape(B, N, 1, D)
    A = torch.sqrt(((X - Y) ** 2).sum(dim=-1) + 1e-9)
    Bm = torch.sqrt(((X + Y) ** 2).sum(dim=-1) + 1e-9)
    Dm = 2.0 * torch.atan2(A, Bm)
    return (Dm**2 * Dm).mean(dim=(1, 2)) / 8.0


def spherical_project(param: torch.Tensor) -> torch.Tensor:
    """x / rms(x) over the last dim: back onto the hypersphere after an Adam step."""
    return param / torch.sqrt((param**2).mean(dim=-1, keepdim=True) + 1e-9)


def normalize_noise(noises):
    """Zero mean, unit (population) std for each tensor of a list, tuple or dict."""
    norm = lambda n: (n - n.mean()) / (n.std(correction=0) + 1e-12)  # noqa: E731
    if isinstance(noises, dict):
        return {k: norm(v) for k, v in noises.items()}
    if isinstance(noises, (list, tuple)):
        return type(noises)(norm(v) for v in noises)
    return norm(noises)


def stylegan2_lr_schedule(num_steps: int, rampup_ratio: float = 0.05,
                          rampdown_ratio: float = 0.25) -> Callable[[int], float]:
    """Learning-rate multiplier at an iteration: linear ramp-up over the first
    `rampup_ratio`, cosine ramp-down over the last `rampdown_ratio` of the steps."""

    def fn(iteration):
        t = iteration / num_steps
        gamma = min(1.0, (1.0 - t) / rampdown_ratio)
        gamma = 0.5 - 0.5 * math.cos(gamma * math.pi)
        return gamma * min(1.0, t / rampup_ratio)

    return fn
