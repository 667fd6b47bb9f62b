"""Fourier-feature positional encoding of the laser-angle grid.

Counterpart of dusty_gan_v2_tpu/ops/fourier.py: a frozen frequency bank projects the
(elevation, azimuth) angle map and the result is [sin, cos]-encoded. Three banks
(`basis_scale`): "random" draws the H frequencies uniform in band and the W ones from a
+-2^k lattice, so the encoding stays periodic over the azimuth; "random_2" draws the W
ones from the integers in band; "logscale" is fixed: the powers of two along H, along W
and along both diagonals, with phase 0 (its width follows the resolution, see
`fourier_out_ch`). `freqs` and `phase` are buffers (the JAX collection "consts"); a
fresh model draws the random banks from a torch.Generator, so parity with a JAX model
needs them carried across (convert/jax_variables.py).

The train-time azimuth shift (`azim_shift`) enters through the identity
sin(c + f_w d) = sin c cos(f_w d) + cos c sin(f_w d): with `as_rotation` the encoding
stays the unshifted batch-1 volume and the per-sample (sin, cos) of f_w d are returned
for the consuming modconv to rotate its weight columns (ops/modconv.py).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

__all__ = ["FourierFeature", "fourier_out_ch"]


def _levels(resolution, L_offset) -> Tuple[int, int]:
    return (int(np.ceil(np.log2(resolution[0]))) + L_offset[0], int(np.ceil(np.log2(resolution[1]))) + L_offset[1])


def fourier_out_ch(num_freqs: int, basis_scale: str, resolution=None, L_offset=(3, -1)) -> int:
    """Channels of the encoding: num_freqs rounded down to even for the random banks;
    (L_h + L_w + 2 min(L_h, L_w)) * 2 for "logscale", which needs the resolution."""
    if basis_scale in ("random", "random_2"):
        return (num_freqs // 2) * 2
    if basis_scale == "logscale":
        L_h, L_w = _levels(resolution, L_offset)
        return (L_h + L_w + 2 * min(L_h, L_w)) * 2
    raise ValueError(basis_scale)


class FourierFeature(nn.Module):
    def __init__(
        self,
        resolution: Tuple[int, int],
        basis_scale: str = "random",
        num_freqs: int = 512,
        L_offset: Tuple[int, int] = (3, -1),
    ):
        super().__init__()
        self.basis_scale = basis_scale
        self.out_ch = fourier_out_ch(num_freqs, basis_scale, resolution, L_offset)
        self.L_h, self.L_w = _levels(resolution, L_offset)
        n = self.out_ch // 2
        self.register_buffer("freqs", torch.zeros(n, 2))
        self.register_buffer("phase", torch.zeros(n))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """A random bank drawn from `generator`; the logscale bank, which draws nothing."""
        n = self.freqs.shape[0]
        with torch.no_grad():
            if self.basis_scale == "logscale":
                self.freqs.copy_(torch.from_numpy(self.logscale_bank(self.L_h, self.L_w)))
                self.phase.zero_()
                return
            band_h, band_w = 2.0 ** (self.L_h - 1), 2.0 ** (self.L_w - 1)
            if self.basis_scale == "random":
                lattice = [-(2.0**k) for k in range(self.L_w)] + [0.0] + [2.0**k for k in range(self.L_w)]
            else:  # random_2: the integers of the band, 0 three times (-0, 0, 0), as the JAX lattice
                ar = np.arange(band_w, dtype=np.float32)
                lattice = np.concatenate([-ar, [0.0], ar]).tolist()
            lattice = torch.tensor(lattice)
            self.freqs[:, 0].uniform_(-band_h, band_h, generator=generator)
            pick = torch.randint(len(lattice), (n,), generator=generator)
            self.freqs[:, 1].copy_(lattice[pick])
            self.phase.uniform_(0.0, 2 * math.pi, generator=generator)

    @staticmethod
    def logscale_bank(L_h: int, L_w: int) -> np.ndarray:
        """(L_h + L_w + 2 L_min, 2) float32: (2^k, 0) for k < L_h, (0, 2^k) for k < L_w,
        then (-2^k, 2^k) and (2^k, 2^k) for k < L_min."""
        L_min = min(L_h, L_w)
        fh = 2.0 ** np.arange(L_h, dtype=np.float32)
        fw = 2.0 ** np.arange(L_w, dtype=np.float32)
        freqs_h = np.concatenate([fh, np.zeros(L_w, np.float32), -fh[:L_min], fh[:L_min]])
        freqs_w = np.concatenate([np.zeros(L_h, np.float32), fw, fw[:L_min], fw[:L_min]])
        return np.stack([freqs_h, freqs_w], axis=-1).astype(np.float32)

    def forward(
        self,
        angle: Optional[torch.Tensor],
        azim_shift: Optional[torch.Tensor] = None,
        as_rotation: bool = False,
        precomputed: Optional[torch.Tensor] = None,
    ):
        """angle (B, 2, H, W) -> (B, out_ch, H, W), in angle's dtype.

        `precomputed`, an encoding this module returned before for the same angle grid,
        replaces the einsum and sin/cos (angle may then be None). `azim_shift` (B,)
        shifts the azimuth per sample: the encoding comes back per sample, or, with
        `as_rotation`, as (unshifted encoding, (sin_delta, cos_delta) each (B, F))."""
        f = self.freqs.to(angle.dtype if angle is not None else precomputed.dtype)
        if precomputed is not None:
            n = precomputed.shape[1] // 2
            s, c = precomputed[:, :n], precomputed[:, n:]
        else:
            coords = torch.einsum("fc,bchw->bfhw", f, angle)
            coords = coords + self.phase.to(angle.dtype)[None, :, None, None]
            s, c = torch.sin(coords), torch.cos(coords)
        if azim_shift is None:
            return torch.cat([s, c], dim=1)
        delta = f[:, 1][None] * azim_shift[:, None]  # (B, F)
        if as_rotation:
            return torch.cat([s, c], dim=1), (torch.sin(delta), torch.cos(delta))
        sd, cd = torch.sin(delta)[:, :, None, None], torch.cos(delta)[:, :, None, None]
        return torch.cat([s * cd + c * sd, c * cd - s * sd], dim=1)
