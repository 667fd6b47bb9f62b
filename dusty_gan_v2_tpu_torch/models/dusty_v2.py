"""DUSty v2 generator, eval path: mapping network, five synthesis blocks over a
multiscale laser-angle pyramid, multi-head skip accumulation and the ray-drop model.

Counterpart of dusty_gan_v2_tpu/models/dusty_v2.py (MappingNetwork, Head,
SynthesisBlock, downsample_angle, SynthesisNetwork, Generator, build_pe_cache).
Submodules carry the flax scope names (mapping_network.fc0,
synthesis_network.b3.conv1.mod, ...head.image, ...bias_act1), so a JAX variable tree
maps onto the state_dict by flattening its paths (convert/jax_variables.py).

Not ported yet: training (w_avg update, aug_coords shift, style mixing), noise
injection, and the discriminator.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..ops import (
    EqualLRDense,
    FourierFeature,
    FusedLeakyReLU,
    ModConv2d,
    fourier_out_ch,
    make_resample,
    pixel_norm,
    resample,
    sample_logistic,
)
from .base import GeneratorMixin
from .dusty_v1 import apply_raydrop
from .heads import resolve_act

__all__ = [
    "MappingNetwork", "Head", "SynthesisBlock", "SynthesisNetwork", "Generator",
    "downsample_angle", "build_pe_cache",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class MappingNetwork(nn.Module):
    """PixelNorm + depth x (equal-LR Linear(lr_mul=0.01, gain=sqrt2) + LeakyReLU 0.2).

    The leaky ReLU here has no bias and no scale: it is not a fused bias-act site."""

    def __init__(self, in_ch: int, out_ch: int, depth: int = 2):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            ch = in_ch if i == 0 else out_ch
            self.add_module(f"fc{i}", EqualLRDense(ch, out_ch, gain=math.sqrt(2.0), lr_mul=0.01))

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        h = pixel_norm(z, dim=1)
        for i in range(self.depth):
            h = getattr(self, f"fc{i}")(h)
            h = torch.where(h >= 0, h, 0.2 * h)
        return h


class Head(nn.ModuleDict):
    """Multi-head 1x1 ModConv (demod=False, ema=True), one per output with ch > 0.

    The heads share their input, so their per-sample weights are stacked and applied
    as one product."""

    def __init__(self, in_ch: int, mod_ch: int, out_ch: Sequence[dict]):
        super().__init__(
            {
                o["name"]: ModConv2d(in_ch, o["ch"], mod_ch, demod=False, ema=True)
                for o in out_ch
                if o["ch"] > 0
            }
        )

    def forward(self, x: torch.Tensor, style: torch.Tensor) -> Dict[str, torch.Tensor]:
        wbs, bs = zip(*(conv.weights(style, x.dtype) for conv in self.values()))
        B, C, H, W = x.shape
        wcat = torch.cat(wbs, dim=1).to(x.dtype)
        y = torch.matmul(wcat, x.reshape(B, C, H * W)).reshape(B, -1, H, W)
        y = y + torch.cat(bs).to(x.dtype).reshape(1, -1, 1, 1)
        return dict(zip(self.keys(), y.split([conv.out_ch for conv in self.values()], dim=1)))


class SynthesisBlock(nn.Module):
    """One scale: resample-up -> Fourier PE -> 1-2 modulated 1x1 convs with fused
    bias-act -> multi-head skip accumulation."""

    def __init__(
        self,
        in_ch: int,  # 0 for the first block
        mid_ch: int,
        out_ch: Tuple[dict, ...],
        mod_ch: int,
        resolution: Tuple[int, int],
        up: int = 2,
        resample_window: Tuple[float, ...] = (1, 3, 3, 1),
        use_noise: bool = True,
        use_pe: bool = True,
        pe_type: str = "random",
        pe_ch: int = 512,
        pe_scale_offset: Tuple[int, int] = (3, -1),
        ring: bool = True,
        dtype: str = "float32",
    ):
        super().__init__()
        if use_noise:
            raise NotImplementedError("noise injection is not ported yet (use_noise=False)")
        if not use_pe:
            raise NotImplementedError("synthesis blocks without a Fourier PE are not ported yet")
        self.is_first = in_ch == 0
        self.out_ch = tuple(out_ch)
        self.dtype = _DTYPES[dtype]
        self.up_plan = (
            make_resample(up=up, window=tuple(resample_window), ring=ring, direction="hw")
            if up > 1
            else None
        )
        self.pe = FourierFeature(tuple(resolution), pe_type, pe_ch, tuple(pe_scale_offset))
        pe_in = fourier_out_ch(pe_ch, pe_type)
        self.conv1 = ModConv2d(in_ch + pe_in, mid_ch, mod_ch, use_bias=False, ema=True)
        self.bias_act1 = FusedLeakyReLU(mid_ch)
        if not self.is_first:
            self.conv2 = ModConv2d(mid_ch, mid_ch, mod_ch, use_bias=False, ema=True)
            self.bias_act2 = FusedLeakyReLU(mid_ch)
        self.head = Head(mid_ch, mod_ch, self.out_ch)

    def pe_volume(self, angle: torch.Tensor) -> torch.Tensor:
        """This block's PE volume at its compute dtype (build_pe_cache)."""
        return self.pe(angle.to(self.dtype))

    def forward(
        self,
        h: Optional[torch.Tensor],
        skip: Optional[torch.Tensor],
        ws: Sequence[torch.Tensor],
        angle: Optional[torch.Tensor],
        pe_entry: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        ws = iter(ws)
        x_op = None
        if h is not None:
            h = h.to(self.dtype)
            if self.up_plan is not None:
                # the 1x1 contraction commutes with the linear per-channel resample:
                # contract at the low resolution, then upsample
                x_op = lambda y: resample(y, self.up_plan)  # noqa: E731
        h_pe = self.pe_volume(angle) if pe_entry is None else pe_entry.to(self.dtype)
        h = self.conv1(h, next(ws), x_shared=h_pe, x_op=x_op)
        h = self.bias_act1(h)
        if not self.is_first:
            h = self.conv2(h, next(ws))
            h = self.bias_act2(h)
        o = self.head(h, next(ws))
        # skip accumulation in float32, all heads stacked so one resample serves them
        o_stack = torch.cat([o[c["name"]].float() for c in self.out_ch if c["ch"] > 0], dim=1)
        if skip is not None:
            o_stack = o_stack + resample(skip, self.up_plan)
        return h, o_stack


def downsample_angle(angle: torch.Tensor, plan) -> torch.Tensor:
    """Downsample an angle grid through its (sin, cos) embedding, then atan2."""
    C = angle.shape[1]
    periodic = resample(torch.cat([torch.sin(angle), torch.cos(angle)], dim=1), plan)
    return torch.atan2(periodic[:, :C], periodic[:, C:])


class SynthesisNetwork(nn.Module):
    """Five-block skip-accumulating synthesis over a multiscale angle pyramid."""

    def __init__(
        self,
        in_ch: int,
        out_ch: Tuple[dict, ...],
        ch_base: int = 64,
        ch_max: int = 512,
        resolution: Tuple[int, int] = (64, 256),
        ring: bool = True,
        layers: Tuple[int, ...] = (2, 2, 2, 2),
        num_fp16_layers: int = -1,
        use_noise: bool = True,
        pe_type: str = "random",
        pe_scale_offset: Tuple[int, int] = (3, -1),
        aug_coords: bool = True,  # train-time only; the eval path does not read it
        output_scale: float = 0.25,
        compute_dtype: str = "float32",
    ):
        super().__init__()
        self.out_ch = tuple(dict(o) for o in out_ch)
        self.resolution = tuple(resolution)
        self.ring = ring
        self.layers = tuple(layers)
        self.num_fp16_layers = num_fp16_layers
        self.output_scale = output_scale
        self.compute_dtype = compute_dtype
        self.scales = (1,) + self.layers
        self.num_styles = len(self.scales) * 2
        ch = lambda i: min(ch_base << (len(self.layers) - i), ch_max)  # noqa: E731
        dtypes = self.block_dtypes()
        res_i = np.array(self.resolution) // int(np.prod(self.layers))
        for i, s in enumerate(self.scales):
            res_i = res_i * s
            block = SynthesisBlock(
                in_ch=ch(i - 1) if i != 0 else 0,
                mid_ch=ch(i),
                out_ch=self.out_ch,
                mod_ch=in_ch,
                resolution=(int(res_i[0]), int(res_i[1])),
                up=s,
                use_noise=use_noise,
                use_pe=s > 1 or i == 0,
                pe_type=pe_type,
                pe_scale_offset=tuple(pe_scale_offset),
                ring=ring,
                dtype=dtypes[i],
            )
            self.add_module(f"b{i}", block)

    def blocks(self):
        return [getattr(self, f"b{i}") for i in range(len(self.scales))]

    def block_dtypes(self):
        """Per-block compute dtype: bfloat16 for the last `num_fp16_layers` blocks (all
        when -1) under compute_dtype="bfloat16", float32 otherwise."""
        n = len(self.scales)
        return [
            "bfloat16"
            if self.compute_dtype == "bfloat16"
            and (self.num_fp16_layers == -1 or n - 1 - i < self.num_fp16_layers)
            else "float32"
            for i in range(n)
        ]

    def angle_pyramid(self, angle: torch.Tensor):
        down_plan = make_resample(down=2, window=(1, 3, 3, 1), ring=self.ring)
        pyramid = [angle]
        for s in self.scales[:0:-1]:
            if s > 1:
                angle = downsample_angle(angle, down_plan)
            pyramid.insert(0, angle)
        return pyramid

    def pe_cache(self, angle: torch.Tensor):
        """Per-block PE volumes for a fixed angle grid (feed back as `pe_cache`)."""
        return tuple(b.pe_volume(a) for b, a in zip(self.blocks(), self.angle_pyramid(angle)))

    def forward(self, ws: torch.Tensor, angle: torch.Tensor, pe_cache=None) -> Dict[str, torch.Tensor]:
        if ws.shape[1] != self.num_styles:
            raise ValueError(f"{ws.shape[1]} styles != {self.num_styles}")
        if pe_cache is None:
            pyramid, pe_cache = self.angle_pyramid(angle), (None,) * len(self.scales)
        else:
            pyramid = (None,) * len(self.scales)
        h, skip, wi = None, None, 0
        for i, block in enumerate(self.blocks()):
            h, skip = block(h, skip, (ws[:, wi], ws[:, wi + 1], ws[:, wi + 2]), pyramid[i], pe_cache[i])
            wi += 1 if i == 0 else 2
        out, c0 = {}, 0
        for o in self.out_ch:
            if o["ch"] == 0:
                continue
            out[o["name"]] = resolve_act(o.get("act"))(skip[:, c0 : c0 + o["ch"]] * self.output_scale)
            c0 += o["ch"]
        return out


class Generator(nn.Module, GeneratorMixin):
    """Mapping + synthesis + ray-drop measurement."""

    def __init__(
        self,
        mapping_kwargs: dict,
        synthesis_kwargs: dict,
        measurement_kwargs: dict,
        compute_dtype: str = "float32",
    ):
        super().__init__()
        self.style_dim = mapping_kwargs["in_ch"]
        self.measurement_kwargs = dict(measurement_kwargs)
        syn_kwargs = dict(synthesis_kwargs)
        syn_kwargs.setdefault("compute_dtype", compute_dtype)
        self.mapping_network = MappingNetwork(**mapping_kwargs)
        self.synthesis_network = SynthesisNetwork(**syn_kwargs)
        self.register_buffer("w_avg", torch.zeros(1, self.style_dim))

    def reset_parameters(self, generator: torch.Generator) -> None:
        """Draw every weight and buffer anew from `generator` (module order)."""
        for m in self.modules():
            if m is not self and hasattr(m, "reset_parameters"):
                m.reset_parameters(generator)
        with torch.no_grad():
            self.w_avg.zero_()

    def forward(
        self,
        z: torch.Tensor,
        angle: Optional[torch.Tensor],
        truncation_psi: float = 1.0,
        gumbel_noise: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        pe_cache=None,
    ) -> Dict[str, torch.Tensor]:
        """z (B, D), angle (1, 2, H, W) -> dict of image, raydrop_logit, w,
        raydrop_mask, image_orig. Without `gumbel_noise` the logistic noise is drawn
        from `generator`."""
        w = self._style(z, self.synthesis_network.num_styles, truncation_psi)
        o = self.synthesis_network(w, angle, pe_cache=pe_cache)
        o["w"] = w
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


def build_pe_cache(G: Generator, angle: torch.Tensor):
    """Per-block Fourier-PE volumes for a fixed sensor grid: G(z, None, pe_cache=...)
    then skips the angle pyramid and the sin/cos volumes on every call."""
    with torch.no_grad():
        return G.synthesis_network.pe_cache(angle)
