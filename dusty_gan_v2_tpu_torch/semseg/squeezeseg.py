"""SqueezeSeg V1/V2 semantic-segmentation networks for range images.

Counterpart of dusty_gan_v2_tpu/semseg/squeezeseg.py: Fire-module encoder/decoder
U-nets with W-only striding, skip sums, CAM attention (V2) and optional CRF-as-RNN
refinement. Submodule names are the flax ones (conv1b, cam1, fire2.squeeze1x1.conv,
head, crf, ...).

Compute-dtype policy (`dtype`): the input is cast to it, each block casts its float32
weights to the activation's dtype, BatchNorm reduces in float32, and the logits return
to float32 before the CRF and the loss (a float64 model, which only the tests build,
keeps float64 there; the JAX package casts to float32 in any mode). Weights are drawn on
the CPU from a generator seeded with `seed`, in registration order.

In train mode the head's Dropout2d takes `keep`, a (B, 64, 1, 1) bool mask, when given,
else draws from `generator` (common.HeadConv).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from .common import (
    ConvReLU, ConvReLUNorm, DeconvReLU, HeadConv, TorchConv2d, max_pool2d, reset_parameters, setup_in_ch,
    trunc_normal_init, xavier_uniform_init,
)
from .crf_as_rnn import CRFRNN

__all__ = ["SqueezeSegV1", "SqueezeSegV2", "CAM", "FireV1", "FireV2"]


class CAM(nn.Module):
    """Context aggregation module: 7x7 max pool -> 1x1 squeeze -> ReLU -> 1x1 -> sigmoid gate."""

    def __init__(self, ch: int, reduction: int = 16):
        super().__init__()
        self.fc1 = TorchConv2d(ch, ch // reduction, (1, 1), (1, 1), (0, 0), kernel_init=xavier_uniform_init())
        self.fc2 = TorchConv2d(ch // reduction, ch, (1, 1), (1, 1), (0, 0), kernel_init=xavier_uniform_init())

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        a = max_pool2d(x, kernel=7, stride=(1, 1), padding=3)
        a = self.fc2(torch.relu(self.fc1(a)))
        return x * torch.sigmoid(a)


class FireV1(nn.Module):
    def __init__(self, in_ch: int, s1x1: int, e1x1: int, e3x3: int, up: bool = False):
        super().__init__()
        init = trunc_normal_init(0.001)
        self.squeeze1x1 = ConvReLU(in_ch, s1x1, (1, 1), (1, 1), (0, 0), kernel_init=init)
        self.upsample = DeconvReLU(s1x1, s1x1) if up else None
        self.expand1x1 = ConvReLU(s1x1, e1x1, (1, 1), (1, 1), (0, 0), kernel_init=init)
        self.expand3x3 = ConvReLU(s1x1, e3x3, (3, 3), (1, 1), (1, 1), kernel_init=init)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = self.squeeze1x1(x)
        if self.upsample is not None:
            h = self.upsample(h)
        return torch.cat([self.expand1x1(h), self.expand3x3(h)], dim=1)


class FireV2(nn.Module):
    def __init__(self, in_ch: int, s1x1: int, e1x1: int, e3x3: int, bn_momentum: float = 0.001, up: bool = False,
                 init_std: float = 0.001):
        super().__init__()
        init = trunc_normal_init(init_std)
        self.squeeze1x1 = ConvReLUNorm(in_ch, s1x1, (1, 1), (1, 1), (0, 0), bn_momentum, kernel_init=init)
        self.upsample = DeconvReLU(s1x1, s1x1) if up else None
        self.expand1x1 = ConvReLUNorm(s1x1, e1x1, (1, 1), (1, 1), (0, 0), bn_momentum, kernel_init=init)
        self.expand3x3 = ConvReLUNorm(s1x1, e3x3, (3, 3), (1, 1), (1, 1), bn_momentum, kernel_init=init)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        h = self.squeeze1x1(x, train=train)
        if self.upsample is not None:
            h = self.upsample(h)
        return torch.cat([self.expand1x1(h, train=train), self.expand3x3(h, train=train)], dim=1)


class _SqueezeSeg(nn.Module):
    def _init_common(self, inputs, num_classes, use_crf, crf_kwargs, dtype):
        self.inputs = tuple(inputs)
        self.num_classes = int(num_classes)
        self.use_crf = bool(use_crf)
        self.dtype = dtype
        self.in_ch = setup_in_ch(self.inputs)
        self._crf_kwargs = dict(crf_kwargs or {})

    def _finish(self, seed: int):
        self.crf = CRFRNN(self.num_classes, **self._crf_kwargs) if self.use_crf else None
        reset_parameters(self, torch.Generator().manual_seed(int(seed)))

    def _head_and_crf(self, h, xyz, mask, train, keep, generator):
        logit = self.head(h, train=train, keep=keep, generator=generator)
        logit = logit.to(torch.promote_types(logit.dtype, torch.float32))  # CRF and loss in float32 (or float64)
        if self.crf is not None:
            if xyz is None or mask is None:
                raise ValueError("the CRF needs xyz and mask")
            logit = self.crf(logit, xyz, mask)
        return logit


class SqueezeSegV1(_SqueezeSeg):
    def __init__(self, inputs: Sequence[str], num_classes: int, head_dropout_p: float = 0.5, use_crf: bool = False,
                 crf_kwargs: Optional[dict] = None, dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        self._init_common(inputs, num_classes, use_crf, crf_kwargs, dtype)
        in_ch, init = self.in_ch, trunc_normal_init(0.001)
        self.conv1b = ConvReLU(in_ch, 64, (1, 1), (1, 1), (0, 0), kernel_init=init)
        self.conv1a = ConvReLU(in_ch, 64, (3, 3), (1, 2), (1, 1), kernel_init=init)
        self.fire2 = FireV1(64, 16, 64, 64)
        self.fire3 = FireV1(128, 16, 64, 64)
        self.fire4 = FireV1(128, 32, 128, 128)
        self.fire5 = FireV1(256, 32, 128, 128)
        self.fire6 = FireV1(256, 48, 192, 192)
        self.fire7 = FireV1(384, 48, 192, 192)
        self.fire8 = FireV1(384, 64, 256, 256)
        self.fire9 = FireV1(512, 64, 256, 256)
        self.fire10 = FireV1(512, 64, 128, 128, up=True)
        self.fire11 = FireV1(256, 32, 64, 64, up=True)
        self.fire12 = FireV1(128, 16, 32, 32, up=True)
        self.fire13 = FireV1(64, 16, 32, 32, up=True)
        self.head = HeadConv(64, self.num_classes, 3, head_dropout_p, kernel_init=init)
        self._finish(seed)

    def forward(self, img, xyz=None, mask=None, train: bool = False, keep=None, generator=None) -> torch.Tensor:
        img = img.to(self.dtype)
        h_1b = self.conv1b(img)
        h_1a = self.conv1a(img)
        h = self.fire2(max_pool2d(h_1a))
        h_3 = self.fire3(h)
        h = self.fire4(max_pool2d(h_3))
        h_5 = self.fire5(h)
        h = self.fire6(max_pool2d(h_5))
        h = self.fire8(self.fire7(h))
        h_9 = self.fire9(h)
        h = self.fire10(h_9) + h_5
        h = self.fire11(h) + h_3
        h = self.fire12(h) + h_1a
        h = self.fire13(h) + h_1b
        return self._head_and_crf(h, xyz, mask, train, keep, generator)


class SqueezeSegV2(_SqueezeSeg):
    def __init__(self, inputs: Sequence[str], num_classes: int, bn_momentum: float = 0.001,
                 head_dropout_p: float = 0.5, use_crf: bool = False, crf_kwargs: Optional[dict] = None,
                 logit_bias: Optional[Sequence[float]] = None, dtype: torch.dtype = torch.float32, seed: int = 0):
        super().__init__()
        self._init_common(inputs, num_classes, use_crf, crf_kwargs, dtype)
        in_ch, bm, enc = self.in_ch, bn_momentum, trunc_normal_init(0.001)
        self.conv1b = ConvReLUNorm(in_ch, 64, (1, 1), (1, 1), (0, 0), bm, kernel_init=enc)
        self.conv1a = ConvReLUNorm(in_ch, 64, (3, 3), (1, 2), (1, 1), bm, kernel_init=enc)
        self.cam1 = CAM(64)
        self.fire2 = FireV2(64, 16, 64, 64, bm)
        self.cam2 = CAM(128)
        self.fire3 = FireV2(128, 16, 64, 64, bm)
        self.cam3 = CAM(128)
        self.fire4 = FireV2(128, 32, 128, 128, bm)
        self.fire5 = FireV2(256, 32, 128, 128, bm)
        self.fire6 = FireV2(256, 48, 192, 192, bm)
        self.fire7 = FireV2(384, 48, 192, 192, bm)
        self.fire8 = FireV2(384, 64, 256, 256, bm)
        self.fire9 = FireV2(512, 64, 256, 256, bm)
        # the decoder draws from N(0, 0.1) truncated
        self.fire10 = FireV2(512, 64, 128, 128, bm, up=True, init_std=0.1)
        self.fire11 = FireV2(256, 32, 64, 64, bm, up=True, init_std=0.1)
        self.fire12 = FireV2(128, 16, 32, 32, bm, up=True, init_std=0.1)
        self.fire13 = FireV2(64, 16, 32, 32, bm, up=True, init_std=0.1)
        self.head = HeadConv(64, self.num_classes, 3, head_dropout_p, kernel_init=trunc_normal_init(0.1),
                             bias_init_values=logit_bias)
        self._finish(seed)

    def forward(self, img, xyz=None, mask=None, train: bool = False, keep=None, generator=None) -> torch.Tensor:
        img = img.to(self.dtype)
        h_1b = self.conv1b(img, train)
        h_1a = self.cam1(self.conv1a(img, train))
        h = self.cam2(self.fire2(max_pool2d(h_1a), train))
        h_3 = self.cam3(self.fire3(h, train))
        h = self.fire4(max_pool2d(h_3), train)
        h_5 = self.fire5(h, train)
        h = self.fire6(max_pool2d(h_5), train)
        h = self.fire8(self.fire7(h, train), train)
        h_9 = self.fire9(h, train)
        h = self.fire10(h_9, train) + h_5
        h = self.fire11(h, train) + h_3
        h = self.fire12(h, train) + h_1a
        h = self.fire13(h, train) + h_1b
        return self._head_and_crf(h, xyz, mask, train, keep, generator)
