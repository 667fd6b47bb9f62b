"""Vanilla (DCGAN-like) baseline generator and discriminator with ring padding.

Counterpart of dusty_gan_v2_tpu/models/vanilla.py (Projection, Upsample, Head,
SynthesisNetwork, Generator, Downsample, Discriminator): equal-LR transposed
convolutions over circular-W / reflect-H padding with fused leaky-ReLU activations
(the K1 kernel on the card), a multi-head output, and a BlurVH + strided-convolution
discriminator. Submodules carry the flax scope names (synthesis_network.projection.conv,
synthesis_network.up1.act, synthesis_network.head.image, down1.conv, final), so a JAX
variable tree loads by flattening its paths (convert/jax_variables.py).

The generator's mapping is the identity and it has one style; it has no measurement
model, no Fourier features and no train-mode azimuth shift, so it draws nothing.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch
from torch import nn

from ..ops import EqualLRConv2d, EqualLRConvTranspose2d, FusedLeakyReLU, blur_vh, pad2d
from .base import GeneratorMixin, reset_children
from .heads import resolve_act

__all__ = ["Projection", "Upsample", "Head", "SynthesisNetwork", "Generator", "Downsample", "Discriminator"]


class Projection(nn.Module):
    """(B, 1, C) style -> (B, out_ch, H0, W0): a full-kernel transposed convolution of the
    1 x 1 input, then a fused bias-act."""

    def __init__(self, in_ch: int, out_ch: int, kernel: Tuple[int, int]):
        super().__init__()
        self.conv = EqualLRConvTranspose2d(in_ch, out_ch, tuple(kernel), use_bias=False)
        self.act = FusedLeakyReLU(out_ch)

    def forward(self, w: torch.Tensor) -> torch.Tensor:
        return self.act(self.conv(w.reshape(w.shape[0], -1, 1, 1)))


class Upsample(nn.Module):
    """2x up: the 4x4 stride-2 padding-3 transposed convolution of the input padded by 1
    (circular W and reflect H when `ring`, reflect both otherwise), then a fused bias-act."""

    def __init__(self, in_ch: int, out_ch: int, ring: bool = True):
        super().__init__()
        self.ring = ring
        self.conv = EqualLRConvTranspose2d(in_ch, out_ch, (4, 4), (2, 2), (3, 3), use_bias=False, ring_fast=ring)
        self.act = FusedLeakyReLU(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.ring:
            x = pad2d(x, 1, ring=False, mode="reflect")
        return self.act(self.conv(x))


class Head(nn.ModuleDict):
    """One 2x-up transposed convolution (with bias) per output with ch > 0, each followed
    by its named activation."""

    def __init__(self, in_ch: int, out_ch: Sequence[dict], ring: bool = True):
        super().__init__({
            o["name"]: EqualLRConvTranspose2d(in_ch, o["ch"], (4, 4), (2, 2), (3, 3), use_bias=True, ring_fast=ring)
            for o in out_ch
            if o["ch"] > 0
        })
        self.ring = ring
        self.acts = {o["name"]: resolve_act(o.get("act")) for o in out_ch if o["ch"] > 0}

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        h = x if self.ring else pad2d(x, 1, ring=False, mode="reflect")
        return {name: self.acts[name](conv(h)) for name, conv in self.items()}


class SynthesisNetwork(nn.Module):
    """Projection + 3 Upsamples + Head: 1 x 1 -> (H/16, W/16) -> ... -> (H, W)."""

    num_styles = 1
    aug_coords = False  # no train-mode azimuth shift

    def __init__(
        self,
        in_ch: int,
        out_ch: Sequence[dict],
        ch_base: int = 64,
        ch_max: int = 512,
        resolution: Tuple[int, int] = (64, 256),
        ring: bool = True,
    ):
        super().__init__()
        self.resolution = tuple(resolution)
        ch = lambda i: min(ch_base << i, ch_max)  # noqa: E731
        self.projection = Projection(in_ch, ch(3), (self.resolution[0] >> 4, self.resolution[1] >> 4))
        self.up1 = Upsample(ch(3), ch(2), ring)
        self.up2 = Upsample(ch(2), ch(1), ring)
        self.up3 = Upsample(ch(1), ch(0), ring)
        self.head = Head(ch(0), tuple(out_ch), ring)

    def forward(self, w: torch.Tensor) -> Dict[str, torch.Tensor]:
        return self.head(self.up3(self.up2(self.up1(self.projection(w)))))


class Generator(nn.Module, GeneratorMixin):
    """Identity mapping + vanilla synthesis, no measurement model: returns the heads'
    outputs and the styles w (B, 1, in_ch)."""

    has_raydrop = False  # draws no logistic noise

    def __init__(self, synthesis_kwargs: dict):
        super().__init__()
        self.style_dim = synthesis_kwargs["in_ch"]
        self.synthesis_network = SynthesisNetwork(**synthesis_kwargs)
        self.register_buffer("w_avg", torch.zeros(1, self.style_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every weight anew from `generator` (module order); w_avg is zero."""
        reset_children(self, generator)
        with torch.no_grad():
            self.w_avg.zero_()

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
        """z (B, D) -> dict of the heads' outputs and w. The generators' common keywords
        are taken: `angle` and `gumbel_noise` are not read; there is no Fourier PE and
        no azimuth shift to take. `generator` is read only for style mixing's draws
        (`style_mixing` on, `mixing` not given; with one style, every style is z's)."""
        if pe_cache is not None or aug_shift is not None:
            raise ValueError("this generator has no Fourier PE and no azimuth shift: pass neither")
        syn = self.synthesis_network
        mixing = self._mixing(style_mixing, mixing, z, syn.num_styles, generator)
        w = self._style(lambda z: z, z, syn.num_styles, truncation_psi, train, input_w, mixing)  # identity mapping
        o = syn(w)
        o["w"] = w
        return o


class Downsample(nn.Module):
    """2x down: a 4x4 stride-2 convolution of the input padded by 1 (circular W and
    reflect H when `ring`, reflect both otherwise), then a fused bias-act.

    The JAX module takes its pad-free route for a ring at even H and W and pads
    otherwise; the port's ring route (ops/pad.py::conv_ring_fast) pads at any size, so
    a ring always takes it."""

    def __init__(self, in_ch: int, out_ch: int, ring: bool = True):
        super().__init__()
        self.ring = ring
        self.conv = EqualLRConv2d(in_ch, out_ch, (4, 4), (2, 2), use_bias=False, ring_fast=ring,
                                  ring_fast_mode="reflect")
        self.act = FusedLeakyReLU(out_ch)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.ring:
            x = pad2d(x, 1, ring=False, mode="reflect")
        return self.act(self.conv(x))


class Discriminator(nn.Module):
    """BlurVH + 4 strided Downsamples + a full-kernel convolution to one logit:
    (B, in_ch, H, W) -> (B, 1, 1, 1)."""

    def __init__(
        self,
        in_ch: int,
        ch_base: int = 64,
        ch_max: int = 512,
        resolution: Tuple[int, int] = (64, 256),
        ring: bool = True,
    ):
        super().__init__()
        self.ring = ring
        self.resolution = tuple(resolution)
        ch = lambda i: min(ch_base << i, ch_max)  # noqa: E731
        self.down1 = Downsample(in_ch * 2, ch(0), ring)
        self.down2 = Downsample(ch(0), ch(1), ring)
        self.down3 = Downsample(ch(1), ch(2), ring)
        self.down4 = Downsample(ch(2), ch(3), ring)
        self.final = EqualLRConv2d(ch(3), 1, (self.resolution[0] >> 4, self.resolution[1] >> 4), use_bias=True)

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every weight anew from `generator` (module order); biases are zero."""
        reset_children(self, generator)

    def forward(self, x: torch.Tensor, blur_fuse: bool = True) -> torch.Tensor:
        """`blur_fuse` is taken for the trainer's sake and not read: this D has no blur
        before a strided convolution to fold (its BlurVH is a plain resample)."""
        h = blur_vh(x, window=(1, 2, 1), ring=self.ring)
        h = self.down4(self.down3(self.down2(self.down1(h))))
        return self.final(h)
