"""Fused bias + leaky-ReLU + scale:  y = leaky_relu(x + bias[c], 0.2) * sqrt(2).

Counterpart of dusty_gan_v2_tpu/ops/act.py. `fused_leaky_relu` is the plain PyTorch
version; `fused_bias_act_cuda` launches the hand-written kernel
(csrc/fused_bias_act.cu, replacing the Pallas `_build_pallas_fn`). `fused_bias_act`
dispatches by the tensor's device: the CPU takes the plain version, a CUDA tensor takes
the kernel or raises. Its backward is plain differentiable torch ops, as the JAX
custom VJP `_flr_bwd` is plain jnp, so a double backward (R1, path length) works.
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch import nn

from .. import kernels

__all__ = ["fused_leaky_relu", "fused_bias_act_cuda", "fused_bias_act", "FusedLeakyReLU"]

SQRT2 = math.sqrt(2.0)


def fused_leaky_relu(
    x: torch.Tensor, bias: torch.Tensor, negative_slope: float = 0.2, scale: float = SQRT2
) -> torch.Tensor:
    """Plain version: leaky_relu(x + bias) * scale, bias over axis 1.

    The math is in float32 with one rounding to x's dtype (the kernel's arithmetic);
    for float32 input that is exactly the JAX formula."""
    bias = bias.to(x.dtype).reshape((1, -1) + (1,) * (x.ndim - 2))
    y = x.float() + bias.float()
    y = torch.where(y >= 0, y, y * negative_slope) * scale
    return y.to(x.dtype)


_C_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong,
    ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
]
_ENTRY = {torch.float32: "fused_bias_act_f32", torch.bfloat16: "fused_bias_act_bf16"}


def fused_bias_act_cuda(
    x: torch.Tensor, bias: torch.Tensor, negative_slope: float = 0.2, scale: float = SQRT2
) -> torch.Tensor:
    """Launch the CUDA kernel on x's current stream; counts its launches."""
    if not x.is_cuda or not bias.is_cuda or x.device != bias.device:
        raise ValueError("fused_bias_act_cuda needs x and bias on the same CUDA device")
    if x.dtype not in _ENTRY:
        raise TypeError(f"fused_bias_act_cuda takes float32 or bfloat16, got {x.dtype}")
    if x.ndim < 2 or bias.shape != (x.shape[1],):
        raise ValueError(f"bias {tuple(bias.shape)} does not match channels of {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("fused_bias_act_cuda needs a contiguous x")
    fn = getattr(kernels.library("fused_bias_act"), _ENTRY[x.dtype])
    fn.argtypes, fn.restype = _C_ARGS, ctypes.c_int
    b = bias.to(x.dtype).contiguous()
    y = torch.empty_like(x)
    C = x.shape[1]
    hw = x.numel() // (x.shape[0] * C) if x.numel() else 1
    err = fn(
        x.data_ptr(), b.data_ptr(), y.data_ptr(), x.numel(), C, hw,
        negative_slope, scale, torch.cuda.current_stream(x.device).cuda_stream,
    )
    kernels.check("fused_bias_act", err)
    fused_bias_act_cuda.launches += 1
    return y


fused_bias_act_cuda.launches = 0


class _FusedBiasAct(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bias, negative_slope, scale):
        if x.device.type == "cuda":
            y = fused_bias_act_cuda(x, bias, negative_slope, scale)
        elif x.device.type == "cpu":
            y = fused_leaky_relu(x, bias, negative_slope, scale)
        else:
            raise ValueError(f"fused_bias_act: unsupported device {x.device}")
        ctx.save_for_backward(y)
        ctx.negative_slope, ctx.scale = negative_slope, scale
        return y

    @staticmethod
    def backward(ctx, g):
        (y,) = ctx.saved_tensors
        # y >= 0 <=> pre-activation >= 0 (scale > 0): the mask comes from the output;
        # the math is in float32 with one rounding, as in the forward
        g32 = g.float()
        dx = torch.where(y >= 0, g32, g32 * ctx.negative_slope) * ctx.scale
        db = dx.sum(dim=(0,) + tuple(range(2, dx.ndim)))
        return dx.to(g.dtype), db, None, None


def fused_bias_act(
    x: torch.Tensor, bias: torch.Tensor, negative_slope: float = 0.2, scale: float = SQRT2
) -> torch.Tensor:
    """Differentiable fused bias-act, dispatched by x's device (CPU: plain, CUDA: kernel)."""
    return _FusedBiasAct.apply(x, bias, negative_slope, scale)


class FusedLeakyReLU(nn.Module):
    """Learned per-channel bias + leaky ReLU + sqrt(2) scale."""

    def __init__(self, ch: int, negative_slope: float = 0.2, scale: float = SQRT2):
        super().__init__()
        self.bias = nn.Parameter(torch.zeros(ch))
        self.negative_slope = negative_slope
        self.scale = scale

    def reset_parameters(self, generator: torch.Generator) -> None:
        nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return fused_bias_act(x, self.bias, self.negative_slope, self.scale)
