"""Equalized learning-rate layers (counterpart of dusty_gan_v2_tpu/ops/linear.py).

Weights are stored in the torch layout ((out, in) dense, (O, I, kh, kw) conv, (I, O, kh,
kw) transposed conv), drawn
N(0, 1/lr_mul), and scaled at run time by 1/sqrt(fan_in); the output by gain * lr_mul.
The convolutions themselves are F.conv2d and F.conv_transpose2d (cuDNN on the card), as
they are plain XLA convolutions in the JAX package.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .blurconv import blur_conv1x1s2_ring, blur_conv3x3s2_ring, blur_conv_fusable
from .pad import conv_ring_fast, convT4x4s2_ring_fast, pad2d

__all__ = ["EqualLRDense", "EqualLRConv2d", "EqualLRConvTranspose2d", "RingConv2d"]


class EqualLRDense(nn.Module):
    """y = (x @ (W * scale).T + b) * gain * lr_mul."""

    def __init__(
        self, in_features: int, features: int, use_bias: bool = True,
        gain: float = 1.0, lr_mul: float = 1.0,
    ):
        super().__init__()
        self.in_features, self.features = in_features, features
        self.gain, self.lr_mul = gain, lr_mul
        self.weight = nn.Parameter(torch.empty(features, in_features))
        self.bias = nn.Parameter(torch.zeros(features)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0 / self.lr_mul, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        scale = 1.0 / math.sqrt(self.in_features)
        y = torch.matmul(x, (self.weight * scale).to(x.dtype).t())
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y * (self.gain * self.lr_mul)


class EqualLRConv2d(nn.Module):
    """Equal-LR Conv2d, NCHW, fan_in = in_ch * kh * kw; padding is the caller's.

    `ring_fast`: the input comes unpadded and the 3x3 / 4x4 convolution pads it by 1
    (circular W, `ring_fast_mode` H; ops/pad.py::conv_ring_fast). `blur_window`: the
    input comes unpadded and unblurred, and the module computes conv(blur(x)) as one
    composite strided convolution (ops/blurconv.py)."""

    def __init__(
        self, in_ch: int, out_ch: int, kernel_size: Tuple[int, int], stride: Tuple[int, int] = (1, 1),
        use_bias: bool = True, gain: float = 1.0, lr_mul: float = 1.0, ring_fast: bool = False,
        ring_fast_mode: str = "replicate", blur_window: Optional[Tuple[float, ...]] = None,
    ):
        super().__init__()
        self.in_ch, self.out_ch = in_ch, out_ch
        self.kernel_size, self.stride = tuple(kernel_size), tuple(stride)
        self.gain, self.lr_mul = gain, lr_mul
        self.ring_fast, self.ring_fast_mode = ring_fast, ring_fast_mode
        self.blur_window = None if blur_window is None else tuple(blur_window)
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, *self.kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0 / self.lr_mul, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor, blur_fuse: bool = False) -> torch.Tensor:
        """`blur_fuse` takes the composite route; it needs a `blur_window`."""
        kh, kw = self.kernel_size
        w = self.weight * (1.0 / math.sqrt(self.in_ch * kh * kw))
        if blur_fuse:
            if self.blur_window is None:
                raise ValueError("blur_fuse needs a conv built with a blur_window")
            fused = blur_conv3x3s2_ring if kh == 3 else blur_conv1x1s2_ring
            y = fused(x, w, self.blur_window)
        elif self.ring_fast:
            y = conv_ring_fast(x, w.to(x.dtype), self.stride, self.ring_fast_mode)
        else:
            y = F.conv2d(x, w.to(x.dtype), stride=self.stride)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype).reshape(1, -1, 1, 1)
        return y * (self.gain * self.lr_mul)


class EqualLRConvTranspose2d(nn.Module):
    """Equal-LR ConvTranspose2d, NCHW, torch's stride and padding; the weight is
    (in_ch, out_ch, kh, kw), torch's conv_transpose2d layout.

    fan_in = out_ch * kh * kw: the reference takes weight[0].numel() of this layout, and
    the JAX module keeps that. `ring_fast`: the 4x4 stride-2 padding-3 transposed
    convolution of the input padded by 1 (circular W, reflect H;
    ops/pad.py::convT4x4s2_ring_fast), the input coming unpadded."""

    def __init__(
        self, in_ch: int, out_ch: int, kernel_size: Tuple[int, int], stride: Tuple[int, int] = (1, 1),
        padding: Tuple[int, int] = (0, 0), use_bias: bool = True, ring_fast: bool = False,
    ):
        super().__init__()
        self.in_ch, self.out_ch = in_ch, out_ch
        self.kernel_size, self.stride, self.padding = tuple(kernel_size), tuple(stride), tuple(padding)
        if ring_fast and (self.kernel_size, self.stride, self.padding) != ((4, 4), (2, 2), (3, 3)):
            raise ValueError("ring_fast is the 4x4 stride-2 padding-3 transposed convolution")
        self.ring_fast = ring_fast
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, *self.kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(0.0, 1.0, generator=generator)
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kh, kw = self.kernel_size
        w = (self.weight * (1.0 / math.sqrt(self.out_ch * kh * kw))).to(x.dtype)
        if self.ring_fast:
            y = convT4x4s2_ring_fast(x, w)
        else:
            y = F.conv_transpose2d(x, w, stride=self.stride, padding=self.padding)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype).reshape(1, -1, 1, 1)
        return y


class RingConv2d(nn.Module):
    """Pad (circular W when `ring`, `pad_mode` H) + equal-LR Conv2d; the child is named
    `conv`, so a flax path res0/conv2/conv/weight is the key res0.conv2.conv.weight.

    With a `blur_window`, forward(x, blur_fuse=True) folds a preceding FIR blur into the
    convolution: the caller then passes the unblurred input."""

    def __init__(
        self, in_ch: int, out_ch: int, kernel_size: int = 3, stride: int = 1, padding: int = 1,
        use_bias: bool = True, ring: bool = False, pad_mode: str = "replicate", gain: float = 1.0,
        lr_mul: float = 1.0, blur_window: Optional[Tuple[float, ...]] = None,
    ):
        super().__init__()
        self.kernel_size, self.stride, self.padding = kernel_size, stride, padding
        self.ring, self.pad_mode = ring, pad_mode
        # the hot case (dusty_v2 D): 3x3 or 4x4, pad 1, circular W, stride 1 or 2
        self.ring_fast = (
            kernel_size in (3, 4) and padding == 1 and ring and pad_mode in ("replicate", "reflect")
            and stride in (1, 2) and not (kernel_size == 4 and stride == 1)
        )
        self.conv = EqualLRConv2d(
            in_ch, out_ch, (kernel_size, kernel_size), (stride, stride), use_bias=use_bias, gain=gain,
            lr_mul=lr_mul, ring_fast=self.ring_fast, ring_fast_mode=pad_mode, blur_window=blur_window,
        )

    def forward(self, x: torch.Tensor, blur_fuse: bool = False) -> torch.Tensor:
        if blur_fuse:
            if not blur_conv_fusable(x.shape, self.kernel_size, self.stride, self.padding, self.ring, self.pad_mode):
                raise ValueError(f"blur_fuse on a conv site that does not compose: input {tuple(x.shape)}")
            return self.conv(x, blur_fuse=True)
        if not self.ring_fast and self.padding != 0:
            x = pad2d(x, self.padding, ring=self.ring, mode=self.pad_mode)
        return self.conv(x)
