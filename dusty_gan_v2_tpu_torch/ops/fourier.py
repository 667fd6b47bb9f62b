"""Fourier-feature positional encoding of the laser-angle grid, "random" basis, eval path.

Counterpart of dusty_gan_v2_tpu/ops/fourier.py: a frozen frequency bank projects the
(elevation, azimuth) angle map and the result is [sin, cos]-encoded. The W frequencies
come from a +-2^k lattice so the encoding stays periodic over the azimuth; the H
frequencies are uniform in band. `freqs` and `phase` are buffers (the JAX collection
"consts"); a fresh model draws them from a torch.Generator, so parity with a JAX model
needs them carried across (convert/jax_variables.py).
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["FourierFeature", "fourier_out_ch"]


def fourier_out_ch(num_freqs: int, basis_scale: str) -> int:
    if basis_scale != "random":
        raise NotImplementedError(f"Fourier basis {basis_scale!r} is not ported yet")
    return (num_freqs // 2) * 2


class FourierFeature(nn.Module):
    def __init__(
        self,
        resolution: Tuple[int, int],
        basis_scale: str = "random",
        num_freqs: int = 512,
        L_offset: Tuple[int, int] = (3, -1),
    ):
        super().__init__()
        self.out_ch = fourier_out_ch(num_freqs, basis_scale)
        self.L_h = int(np.ceil(np.log2(resolution[0]))) + L_offset[0]
        self.L_w = int(np.ceil(np.log2(resolution[1]))) + L_offset[1]
        n = num_freqs // 2
        self.register_buffer("freqs", torch.zeros(n, 2))
        self.register_buffer("phase", torch.zeros(n))

    def reset_parameters(self, generator: torch.Generator) -> None:
        n = self.freqs.shape[0]
        band_h = 2.0 ** (self.L_h - 1)
        lattice = torch.tensor(
            [-(2.0**k) for k in range(self.L_w)] + [0.0] + [2.0**k for k in range(self.L_w)]
        )
        with torch.no_grad():
            self.freqs[:, 0].uniform_(-band_h, band_h, generator=generator)
            pick = torch.randint(len(lattice), (n,), generator=generator)
            self.freqs[:, 1].copy_(lattice[pick])
            self.phase.uniform_(0.0, 2 * math.pi, generator=generator)

    def forward(self, angle: torch.Tensor) -> torch.Tensor:
        """angle (B, 2, H, W) -> (B, out_ch, H, W), in angle's dtype."""
        f = self.freqs.to(angle.dtype)
        coords = torch.einsum("fc,bchw->bfhw", f, angle)
        coords = coords + self.phase.to(angle.dtype)[None, :, None, None]
        return torch.cat([torch.sin(coords), torch.cos(coords)], dim=1)
