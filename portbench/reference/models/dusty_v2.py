"""DUSty v2 generator: mapping network, five synthesis blocks over a multiscale
laser-angle pyramid, multi-head skip accumulation and the ray-drop model, in eval and
train mode; and the DUSty v2 discriminator: BlurVH pre-blur, 1x1 stem, residual blocks down to a
height of 4, minibatch-stddev epilogue.

Counterpart of dusty_gan_v2_tpu/models/dusty_v2.py (MappingNetwork, Head,
SynthesisBlock, downsample_angle, SynthesisNetwork, Generator, build_pe_cache,
ResidualBlock, Discriminator). Submodules carry the flax scope names
(mapping_network.fc0, synthesis_network.b3.conv1.mod, ...head.image, ...bias_act1,
res0.conv2.conv), so a JAX variable tree maps onto the state_dict by flattening its
paths (convert/jax_variables.py).

Train mode (`train=True`) updates the w_avg and ema_var buffers in place and, with
`aug_coords`, shifts the azimuth per sample inside the Fourier encodings and shifts the
skip back in image space. A block at scale 1 other than the first has no Fourier PE (its
conv1 takes h alone), as in JAX. Only what the benchmarked configurations set is here:
the random Fourier basis; no noise injection, style mixing, truncation or remat.
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
    RingConv2d,
    blur_vh,
    circular_translate_w,
    fourier_out_ch,
    fused_act_resample,
    fused_resample,
    make_resample,
    minibatch_stddev,
    pixel_norm,
    resample,
    resample_sumsq,
)
from ..precision import q
from .base import GeneratorMixin
from .dusty_v1 import apply_raydrop
from .heads import resolve_act

__all__ = [
    "MappingNetwork", "Head", "SynthesisBlock", "SynthesisNetwork", "Generator",
    "downsample_angle", "build_pe_cache", "ResidualBlock", "Discriminator",
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

    def forward(self, x: torch.Tensor, style: torch.Tensor, train: bool = False) -> Dict[str, torch.Tensor]:
        wbs, bs = zip(*(conv.weights(style, x.dtype, train, x) for conv in self.values()))
        B, C, H, W = x.shape
        wcat = torch.cat(wbs, dim=1).to(x.dtype)
        y = q(torch.matmul(q(wcat), q(x.reshape(B, C, H * W)))).reshape(B, -1, H, W)
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
        use_pe: bool = True,
        pe_type: str = "random",
        pe_ch: int = 512,
        pe_scale_offset: Tuple[int, int] = (3, -1),
        ring: bool = True,
        dtype: str = "float32",
        pe_dtype: str = "float32",
    ):
        super().__init__()
        self.is_first = in_ch == 0
        self.out_ch = tuple(out_ch)
        self.dtype = _DTYPES[dtype]
        self.pe_dtype = _DTYPES[pe_dtype]
        self.up_plan = (
            make_resample(up=up, window=tuple(resample_window), ring=ring, direction="hw")
            if up > 1
            else None
        )
        self.use_pe = use_pe
        pe_in = 0
        if use_pe:
            self.pe = FourierFeature(tuple(resolution), pe_type, pe_ch, tuple(pe_scale_offset))
            pe_in = fourier_out_ch(pe_ch, pe_type, tuple(resolution), tuple(pe_scale_offset))
        self.conv1 = ModConv2d(in_ch + pe_in, mid_ch, mod_ch, use_bias=False, ema=True)
        self.bias_act1 = FusedLeakyReLU(mid_ch)
        if not self.is_first:
            self.conv2 = ModConv2d(mid_ch, mid_ch, mod_ch, use_bias=False, ema=True)
            self.bias_act2 = FusedLeakyReLU(mid_ch)
        self.head = Head(mid_ch, mod_ch, self.out_ch)

    def pe_volume(self, angle: torch.Tensor) -> Optional[torch.Tensor]:
        """This block's PE volume (build_pe_cache), its phase and sinusoids computed at the
        configuration's compute dtype `pe_dtype` and kept in the block's; None without a PE.

        Under the bf16 policy the program computes the phase f . angle in bfloat16, where a
        phase of ~100 rad rounds by ~0.5 rad: its sinusoids are a deterministic function of
        the rounded phase, not rounding noise, and a float32 PE would put the reference's G
        11-27% (relative L2) from the program's on that alone. The reference computes the
        same rounded phase; every other operation stays float32."""
        if not self.use_pe:
            return None
        return self.pe(angle.to(self.pe_dtype)).to(self.dtype)

    def forward(
        self,
        h: Optional[torch.Tensor],
        skip: Optional[torch.Tensor],
        ws: Sequence[torch.Tensor],
        angle: Optional[torch.Tensor],
        pe_entry: Optional[torch.Tensor] = None,
        train: bool = False,
        azim_shift: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        ws = iter(ws)
        x_op = x_stat = None
        if h is not None:
            h = h.to(self.dtype)
            if self.up_plan is not None:
                # the 1x1 contraction commutes with the linear per-channel resample:
                # contract at the low resolution, then upsample. conv1's ema_var
                # statistic is the upsampled input's, taken at the low resolution.
                x_op = lambda y: resample(y, self.up_plan)  # noqa: E731
                if train:
                    with torch.no_grad():
                        x_stat = resample_sumsq(h, self.up_plan)
        h_pe = pe_rot = None
        if self.use_pe:
            pe_angle = angle.to(self.dtype) if pe_entry is None else None
            pre = None if pe_entry is None else pe_entry.to(self.dtype)
            if azim_shift is None:
                h_pe = self.pe(pe_angle, precomputed=pre)
            else:
                h_pe, pe_rot = self.pe(pe_angle, azim_shift=azim_shift, as_rotation=True, precomputed=pre)
        h = self.conv1(h, next(ws), x_shared=h_pe, x_op=x_op, train=train, shared_rotation=pe_rot, x_stat=x_stat)
        h = self.bias_act1(h)
        if not self.is_first:
            h = self.bias_act2(self.conv2(h, next(ws), train=train))
        o = self.head(h, next(ws), train=train)
        # skip accumulation in float32 (float64 stays), all heads stacked so one resample serves them
        acc = torch.promote_types(h.dtype, torch.float32)
        o_stack = torch.cat([o[c["name"]].to(acc) for c in self.out_ch if c["ch"] > 0], dim=1)
        if skip is not None:  # at scale 1 the skip passes unresampled (the JAX block fails there)
            o_stack = o_stack + (skip if self.up_plan is None else resample(skip, self.up_plan))
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
        aug_coords: bool = True,
        aug_coords_blitting: bool = False,
        output_scale: float = 0.25,
        compute_dtype: str = "float32",
        pe_dtype: str = "float32",
    ):
        super().__init__()
        if use_noise or aug_coords_blitting or pe_type != "random":
            raise NotImplementedError("the reference has the random Fourier basis, no noise injection, no blitting")
        self.out_ch = tuple(dict(o) for o in out_ch)
        self.resolution = tuple(resolution)
        self.ring = ring
        self.layers = tuple(layers)
        self.num_fp16_layers = num_fp16_layers
        self.aug_coords = aug_coords
        self.output_scale = output_scale
        self.compute_dtype = compute_dtype
        self.scales = (1,) + self.layers
        self.num_styles = len(self.scales) * 2
        ch = lambda i: min(ch_base << (len(self.layers) - i), ch_max)  # noqa: E731
        dtypes = self.block_dtypes()
        # each block's PE at the dtype the configuration's policy gives that block
        pe_dtypes = [d if pe_dtype == "float32" else ("bfloat16" if (num_fp16_layers == -1 or len(self.scales) - 1 - i
                     < num_fp16_layers) else "float32") for i, d in enumerate(dtypes)]
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
                use_pe=s > 1 or i == 0,
                pe_type=pe_type,
                pe_scale_offset=tuple(pe_scale_offset),
                ring=ring,
                dtype=dtypes[i],
                pe_dtype=pe_dtypes[i],
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
        """Per-block PE volumes for a fixed angle grid (feed back as `pe_cache`); None for
        a block without a PE."""
        return tuple(b.pe_volume(a) for b, a in zip(self.blocks(), self.angle_pyramid(angle)))

    def forward(
        self, ws: torch.Tensor, angle: torch.Tensor, pe_cache=None, train: bool = False,
        aug_shift: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """In train mode with aug_coords, `aug_shift` (B,) in [0, 1) is each sample's
        azimuth shift in turns: the encodings are shifted by it and the skip is shifted
        back by as many pixels."""
        if ws.shape[1] != self.num_styles:
            raise ValueError(f"{ws.shape[1]} styles != {self.num_styles}")
        shift = None
        if train and self.aug_coords:
            if aug_shift is None or tuple(aug_shift.shape) != (ws.shape[0],):
                raise ValueError("train mode with aug_coords needs aug_shift of shape (B,)")
            shift = aug_shift * (2.0 * np.pi)
        if pe_cache is None:
            pyramid, pe_cache = self.angle_pyramid(angle), (None,) * len(self.scales)
        else:
            pyramid = (None,) * len(self.scales)
        h, skip, wi = None, None, 0
        for i, block in enumerate(self.blocks()):
            h, skip = block(h, skip, (ws[:, wi], ws[:, wi + 1], ws[:, wi + 2]), pyramid[i], pe_cache[i], train, shift)
            wi += 1 if i == 0 else 2
        if shift is not None:
            skip = circular_translate_w(skip, shift / (2.0 * np.pi) * self.resolution[1])
        out, c0 = {}, 0
        for o in self.out_ch:
            if o["ch"] == 0:
                continue
            out[o["name"]] = resolve_act(o.get("act"))(skip[:, c0 : c0 + o["ch"]] * self.output_scale)
            c0 += o["ch"]
        return out


class Generator(nn.Module, GeneratorMixin):
    """Mapping + synthesis + ray-drop measurement."""

    has_raydrop = True  # draws logistic noise of raydrop_logit's shape

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

    def forward(
        self,
        z: torch.Tensor,
        angle: Optional[torch.Tensor],
        gumbel_noise: torch.Tensor,
        pe_cache=None,
        train: bool = False,
        aug_shift: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """z (B, D), angle (1, 2, H, W), the logistic ray-drop noise -> dict of image,
        raydrop_logit, w, raydrop_mask, image_orig. Train mode with aug_coords takes
        `aug_shift`, U[0, 1) per sample."""
        syn = self.synthesis_network
        w = self._style(self.mapping_network, z, syn.num_styles, train)
        o = syn(w, angle, pe_cache=pe_cache, train=train, aug_shift=aug_shift)
        o["w"] = w
        return apply_raydrop(
            o,
            gumbel_noise,
            raydrop_const=float(self.measurement_kwargs.get("raydrop_const", -1)),
            gumbel_temperature=float(self.measurement_kwargs.get("gumbel_temperature", 1.0)),
        )


def build_pe_cache(G: nn.Module, angle: torch.Tensor):
    """Per-block Fourier-PE volumes for a fixed sensor grid: G(z, None, pe_cache=...)
    then skips the angle pyramid and the sin/cos volumes on every call. None for a
    generator without Fourier PE (vanilla, dusty_v1)."""
    build = getattr(G.synthesis_network, "pe_cache", None)
    if build is None:
        return None
    with torch.no_grad():
        return build(angle)


class ResidualBlock(nn.Module):
    """conv3x3 -> bias-act -> blur -> conv3x3 stride 2 -> bias-act, plus the skip
    blur -> conv1x1 stride 2; (main + skip) / sqrt(2).

    Two routes for the blurs. `blur_fuse=True` (forward and input gradients) folds each
    blur into the strided convolution after it (ops/blurconv.py), where the site
    composes. Otherwise, and on every training call, the `bias_act1 -> blur` pair is
    one fused chain op and the skip's blur another (ops/fused_chain.py: the chain
    kernels on the card, the unfused pair the JAX block computes on the CPU)."""

    WINDOW = (1, 3, 3, 1)

    def __init__(self, in_ch: int, out_ch: int, ring: bool = True):
        super().__init__()
        self.ring = ring
        self.blur = make_resample(window=self.WINDOW, ring=ring)
        self.conv1 = RingConv2d(in_ch, in_ch, 3, 1, 1, use_bias=False, ring=ring)
        self.bias_act1 = FusedLeakyReLU(in_ch)
        self.conv2 = RingConv2d(in_ch, out_ch, 3, 2, 1, use_bias=False, ring=ring, blur_window=self.WINDOW)
        self.bias_act2 = FusedLeakyReLU(out_ch)
        self.skip = RingConv2d(in_ch, out_ch, 1, 2, 0, use_bias=False, ring=ring, blur_window=self.WINDOW)

    def forward(self, x: torch.Tensor, blur_fuse: bool = False) -> torch.Tensor:
        if blur_fuse:
            raise ValueError("the reference has no composite blur route")
        h = self.conv1(x)
        act = self.bias_act1
        h = self.conv2(fused_act_resample(h, act.bias, self.blur, act.negative_slope, act.scale))
        s = self.skip(fused_resample(x, self.blur))
        return (self.bias_act2(h) + s) / math.sqrt(2.0)


class Discriminator(nn.Module):
    """StyleGAN2-style residual discriminator with the BlurVH pre-blur and a
    minibatch-stddev epilogue; (B, in_ch, H, W) -> (B, 1) logits.

    Per-layer dtype policy: under compute_dtype="bfloat16" the first `num_fp16_layers`
    layers (pre-blur, stem, stem activation, each block; all when -1) run in bfloat16;
    the epilogue from the minibatch stddev on is float32."""

    def __init__(
        self,
        in_ch: int,
        ch_base: int = 32,
        ch_max: int = 512,
        mbdis_group: int = 4,
        mbdis_feat: int = 1,
        resolution: Tuple[int, int] = (64, 512),
        ring: bool = True,
        num_fp16_layers: int = -1,
        pre_blur: bool = True,
        compute_dtype: str = "float32",
    ):
        super().__init__()
        self.in_ch, self.ring, self.pre_blur = in_ch, ring, pre_blur
        self.mbdis_group, self.mbdis_feat = mbdis_group, mbdis_feat
        self.resolution = tuple(resolution)
        self.num_fp16_layers, self.compute_dtype = num_fp16_layers, compute_dtype
        self.n_down = int(np.log2(min(self.resolution) / 4))
        res_out = tuple(r >> self.n_down for r in self.resolution)
        ch = lambda i: min(ch_base << i, ch_max)  # noqa: E731

        self.stem = RingConv2d(in_ch * 2 if pre_blur else in_ch, ch(0), 1, 1, 0, use_bias=False, ring=ring)
        self.stem_act = FusedLeakyReLU(ch(0))
        for j in range(self.n_down):
            self.add_module(f"res{j}", ResidualBlock(ch(j), ch(j + 1), ring))
        # the epilogue's width is ch(n_down): ch(4) at the 64-high resolution
        ch_epi = ch(self.n_down)
        self.epi_conv = RingConv2d(ch_epi + mbdis_feat, ch_epi, 3, 1, 1, use_bias=False, ring=ring)
        self.epi_act1 = FusedLeakyReLU(ch_epi)
        self.fc1 = EqualLRDense(ch_epi * int(np.prod(res_out)), ch_epi, use_bias=False)
        self.epi_act2 = FusedLeakyReLU(ch_epi)
        self.fc2 = EqualLRDense(ch_epi, 1)

    def layer_dtype(self, i: int) -> torch.dtype:
        low = self.compute_dtype == "bfloat16" and (self.num_fp16_layers == -1 or i < self.num_fp16_layers)
        return torch.bfloat16 if low else torch.float32

    def forward(self, x: torch.Tensor, blur_fuse: bool = False) -> torch.Tensor:
        i, h = 0, x
        if self.pre_blur:
            h = blur_vh(h.to(self.layer_dtype(i)), ring=self.ring)
            i += 1
        h = self.stem(h.to(self.layer_dtype(i)))
        h = self.stem_act(h.to(self.layer_dtype(i + 1)))
        i += 2
        for j in range(self.n_down):
            block, x = getattr(self, f"res{j}"), h.to(self.layer_dtype(i))
            h = block(x, blur_fuse)
            i += 1
        h = minibatch_stddev(h.float(), group=self.mbdis_group, features=self.mbdis_feat)
        h = self.epi_act1(self.epi_conv(h))
        h = self.epi_act2(self.fc1(h.reshape(h.shape[0], -1)))
        return self.fc2(h)
