"""Spatial noise injection (StyleGAN2).

Counterpart of dusty_gan_v2_tpu/ops/noise.py::NoiseInjection: x + weight * noise, with
a weight (1, ch, 1, 1) that starts at zero (ch = 1 in the generator's blocks, as in the
JAX blocks: one scalar a layer) and one noise map per sample, shared by the channels.
The map is an explicit argument: a fixed (1, 1, H, W) map is broadcast over the batch
(the JAX module's `fixed_noise`); per-sample maps (B, 1, H, W) come from `draw`, which
takes this rank's rows of a draw for the global batch from a parallel.PerSampleStream
(the JAX module's ps_normal keyed by global id), so that the maps do not depend on the
number of processes.
"""

from __future__ import annotations

import torch
from torch import nn

__all__ = ["NoiseInjection"]


class NoiseInjection(nn.Module):
    def __init__(self, resolution, ch: int = 1):
        super().__init__()
        self.resolution = tuple(int(r) for r in resolution)
        self.weight = nn.Parameter(torch.zeros(1, ch, 1, 1))

    def reset_parameters(self, generator: torch.Generator = None) -> None:
        with torch.no_grad():
            self.weight.zero_()

    def draw(self, stream) -> torch.Tensor:
        """Standard normal maps (n, 1, H, W) for the stream's n samples (float32)."""
        return stream.normal((1, *self.resolution))

    def forward(self, x: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        """x (B, C, H, W) + weight * noise, noise (1 or B, 1, H, W), in x's dtype."""
        B, _, H, W = x.shape
        if noise.ndim != 4 or noise.shape[1:] != (1, H, W) or noise.shape[0] not in (1, B):
            raise ValueError(f"noise {tuple(noise.shape)} does not fit x {tuple(x.shape)}")
        return x + self.weight.to(x.dtype) * noise.to(x.dtype).expand(B, 1, H, W)
