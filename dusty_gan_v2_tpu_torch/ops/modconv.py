"""Modulated 1x1 convolution (StyleGAN2), eval path.

Counterpart of the 1x1 paths of dusty_gan_v2_tpu/ops/modconv.py::ModConv2d: style
modulation, the demodulation pre-normalisation and rsqrt, the eval-time division by
sqrt(ema_var), the split contraction against a batch-1 shared input (`x_shared`), the
low-resolution contraction followed by a linear spatial map (`x_op`), and
`weights()` for callers that fuse several heads into one product. Per-sample products
are torch matmuls, as the JAX package left them to XLA. Not ported yet: k > 1,
transposed, factorized, `shared_rotation` and the train-time EMA update.

Under a bfloat16 compute dtype the per-sample weights are cast to bfloat16 before
each product, so the product runs in bfloat16 with float32 accumulation.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch
from torch import nn

from .linear import EqualLRDense

__all__ = ["ModConv2d"]


class ModConv2d(nn.Module):
    def __init__(
        self, in_ch: int, out_ch: int, mod_ch: int,
        demod: bool = True, use_bias: bool = True, ema: bool = False,
    ):
        super().__init__()
        self.in_ch, self.out_ch = in_ch, out_ch
        self.demod, self.ema = demod, ema
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, 1, 1))
        self.mod = EqualLRDense(mod_ch, in_ch, gain=1.0)
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None
        if ema:
            self.register_buffer("ema_var", torch.ones(()))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.normal_(generator=generator)
            if self.bias is not None:
                self.bias.zero_()
            if self.ema:
                self.ema_var.fill_(1.0)

    def weights(self, style: torch.Tensor, dtype: torch.dtype) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Per-sample (B, O, I) float32 weights and the bias (None without one)."""
        style = self.mod(style)
        w = (self.weight[:, :, 0, 0] * (1.0 / math.sqrt(self.in_ch))).to(dtype)
        if self.demod:
            # inf-norm over (O, I, kh) keeping kw: for 1x1 the global max
            w = w / w.abs().amax()
            style = style / style.abs().amax(dim=1, keepdim=True)
        wb = w[None] * (style[:, None, :] + 1.0)
        if self.demod:
            wb = wb * torch.rsqrt(wb.square().sum(dim=2, keepdim=True) + 1e-8)
        if self.ema:
            wb = wb / (torch.sqrt(self.ema_var).to(dtype) + 1e-8)
        return wb, self.bias

    def forward(
        self,
        x: Optional[torch.Tensor],
        style: torch.Tensor,
        x_shared: Optional[torch.Tensor] = None,
        x_op: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    ) -> torch.Tensor:
        """x (B, Cx, h, w) or None; x_shared (1, Cs, H, W) logically concatenated after
        x's channels (Cx + Cs == in_ch) and never materialized per sample; x_op a
        linear per-channel map from (h, w) to (H, W) applied after contracting x."""
        src = x if x_shared is None else x_shared
        dtype = src.dtype
        wb, bias = self.weights(style, dtype)
        wb = wb.to(dtype)
        B = style.shape[0]
        if x_shared is None:
            h = self._contract(wb, x)
            if x_op is not None:
                h = x_op(h)
        else:
            if x_shared.shape[0] != 1:
                raise ValueError("x_shared must have batch 1")
            _, Cs, H, W = x_shared.shape
            Cx = 0 if x is None else x.shape[1]
            if Cx + Cs != self.in_ch:
                raise ValueError(f"{Cx} + {Cs} channels != in_ch {self.in_ch}")
            w_sh = wb[:, :, Cx:].reshape(B * self.out_ch, Cs)
            h = torch.matmul(w_sh, x_shared.reshape(Cs, H * W)).reshape(B, self.out_ch, H, W)
            if x is not None:
                hx = self._contract(wb[:, :, :Cx], x)
                h = h + (x_op(hx) if x_op is not None else hx)
        if bias is not None:
            h = h + bias.to(dtype).reshape(1, -1, 1, 1)
        return h

    @staticmethod
    def _contract(wb: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """(B, O, I) x (B, I, H, W) -> (B, O, H, W)."""
        B, _, H, W = x.shape
        return torch.matmul(wb, x.reshape(B, x.shape[1], H * W)).reshape(B, -1, H, W)
