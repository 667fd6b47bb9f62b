"""Modulated 1x1 convolution (StyleGAN2).

Counterpart of the 1x1 paths of dusty_gan_v2_tpu/ops/modconv.py::ModConv2d: style
modulation, the demodulation pre-normalisation and rsqrt, the division by
sqrt(ema_var), the split contraction against a batch-1 shared input (`x_shared`), the
low-resolution contraction followed by a linear spatial map (`x_op`), the per-sample
rotation of the shared Fourier columns (`shared_rotation`), and `weights()` for callers
that fuse several heads into one product. Per-sample products are torch matmuls, as the
JAX package left them to XLA. Not ported: k > 1, transposed and factorized modconvs.

In train mode (`train=True`) the ema_var buffer first moves toward the mean square of
the logical conv input, x_op(x) concatenated with x_shared (detached; `x_stat` gives
x_op(x)'s sum of squares when the caller contracts before x_op), and the same forward
then divides by the new sqrt(ema_var). The update is an in-place buffer write outside
autograd.

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
        demod: bool = True, use_bias: bool = True, ema: bool = False, ema_decay: float = 0.9989,
    ):
        super().__init__()
        self.in_ch, self.out_ch = in_ch, out_ch
        self.demod, self.ema, self.ema_decay = demod, ema, ema_decay
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

    @torch.no_grad()
    def update_ema(
        self,
        x: Optional[torch.Tensor],
        batch: int,
        x_shared: Optional[torch.Tensor] = None,
        x_stat: Optional[Tuple[torch.Tensor, int]] = None,
    ) -> None:
        """ema_var += (1 - decay) * (mean square of the logical input - ema_var), the
        input being x (or x_stat's (sum of squares, count) in its place) for each of
        `batch` samples, followed by the batch-shared x_shared's channels."""
        if x_stat is not None:
            sx, nx = x_stat
        elif x is not None:
            sx, nx = x.float().square().sum(), x.numel()
        else:
            sx, nx = None, 0
        if x_shared is None:
            var = sx / nx
        else:
            # a per-sample rotation of [sin, cos] pairs keeps their squares' sum, so
            # the shared part's statistic is the base encoding's
            ss, n_sh, bs = x_shared.float().square().sum(), x_shared.numel(), x_shared.shape[0]
            var = ss / n_sh if sx is None else (sx + batch * ss / bs) / (nx + batch * n_sh / bs)
        self.ema_var.copy_(self.ema_var + (1.0 - self.ema_decay) * (var - self.ema_var))

    def weights(
        self, style: torch.Tensor, dtype: torch.dtype, train: bool = False, x: Optional[torch.Tensor] = None
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Per-sample (B, O, I) float32 weights and the bias (None without one); in train
        mode the ema_var update from the input x comes first."""
        if train and self.ema:
            self.update_ema(x, style.shape[0])
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
        train: bool = False,
        shared_rotation: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
        x_stat: Optional[Tuple[torch.Tensor, int]] = None,
    ) -> torch.Tensor:
        """x (B, Cx, h, w) or None; x_shared (1, Cs, H, W) logically concatenated after
        x's channels (Cx + Cs == in_ch) and never materialized per sample; x_op a
        linear per-channel map from (h, w) to (H, W) applied after contracting x.
        shared_rotation (sin_d, cos_d), each (B, Cs / 2), rotates the shared columns
        per sample as a [sin, cos] Fourier block: W's = Ws cos_d - Wc sin_d,
        W'c = Ws sin_d + Wc cos_d. x_stat is x_op(x)'s (sum of squares, count) for the
        train-mode ema_var update."""
        src = x if x_shared is None else x_shared
        dtype = src.dtype
        B = style.shape[0]
        if train and self.ema:
            self.update_ema(x, B, x_shared, x_stat)
        wb, bias = self.weights(style, dtype)
        wb = wb.to(dtype)
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
            w_sh = wb[:, :, Cx:]
            if shared_rotation is not None:
                n = Cs // 2
                sd, cd = (r[:, None, :].to(dtype) for r in shared_rotation)
                ws_, wc_ = w_sh[:, :, :n], w_sh[:, :, n:]
                w_sh = torch.cat([ws_ * cd - wc_ * sd, ws_ * sd + wc_ * cd], dim=-1)
            h = torch.matmul(w_sh.reshape(B * self.out_ch, Cs), x_shared.reshape(Cs, H * W)).reshape(B, self.out_ch, H, W)
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
