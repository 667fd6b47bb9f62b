"""Fused elementwise -> resample chains: bias + leaky-ReLU + both resample passes in one
pass over the activation, and its backward.

Counterpart of dusty_gan_v2_tpu/ops/fused_chain.py. The discriminator's block runs
`bias_act -> blur` on its main path and a bare blur on its skip; unfused, the activation
is written, the W-pass reads it and writes an intermediate, and the H-pass reads that
and writes again. Here one kernel reads a plane once, applies the activation, runs both
dense resample products with the intermediate held on chip, and writes the result.

    fused_act_resample(x, bias, plan)   resample(leaky_relu(x + bias[c]) * scale, plan)
    fused_resample(x, plan)             resample(x, plan)

Each dispatches by x's device: a CPU tensor takes the plain version beside the kernel
(`fused_leaky_relu` and the two matmuls of `resample`, with the same roundings), a CUDA
tensor launches the hand-written kernel of csrc/fused_chain.cu (`fused_chain_fwd_cuda`
replaces the Pallas `_fwd_call`, `fused_chain_bwd_cuda` the Pallas `_bwd_call`) or
raises. The autograd Functions are the same on both devices:

- `fused_resample` is linear: its backward is itself with the transposed operators, so
  it differentiates to any order;
- `fused_act_resample`'s backward is the second kernel (adjoint passes times the
  activation mask from the saved input) plus d(bias) = sum of dx in float32; that
  backward is linear in the incoming gradient, so its own backward (the double backward
  R1 needs) is `fused_resample(mask * gg)`, and zero for x and the bias (the mask is
  piecewise constant).

Roundings, as in the Pallas bodies: bias rounded to x's dtype, activation in float32,
round, W-pass accumulated in float32, round, H-pass accumulated in float32, round;
backward: adjoint H-pass, round, adjoint W-pass in float32 times the mask, round.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from .. import kernels
from .act import fused_leaky_relu
from .resample import ResamplePlan, _resample_matrices

__all__ = [
    "ChainOperators", "chain_operators", "fused_act_resample", "fused_resample",
    "fused_chain_fwd_cuda", "fused_chain_bwd_cuda",
    "fused_act_resample_plain", "fused_resample_plain", "fused_act_resample_bwd_plain",
    "MAX_ROWS", "MAX_COLS",
]

SQRT2 = math.sqrt(2.0)
# shape contract of the kernels: every H, Ho <= MAX_ROWS and every W, Wo <= MAX_COLS
# (all discriminator and generator sites of the 64x512 configuration)
MAX_ROWS, MAX_COLS = 128, 512


class ChainOperators(NamedTuple):
    """The dense operators of one resampling on one device, and their transposes:
    out = hm (Ho, H) @ x (H, W) @ wmT (W, Wo)."""

    hm: torch.Tensor
    wmT: torch.Tensor
    hmT: torch.Tensor
    wm: torch.Tensor

    @property
    def adjoint(self) -> "ChainOperators":
        """The operators of the transposed map, (Ho, Wo) planes -> (H, W) planes."""
        return ChainOperators(self.hmT, self.wm, self.hm, self.wmT)


@functools.lru_cache(maxsize=None)
def chain_operators(plan: ResamplePlan, H: int, W: int, device: torch.device, dtype: torch.dtype) -> ChainOperators:
    Hmat, Wmat = (torch.from_numpy(m).to(device=device, dtype=dtype) for m in _resample_matrices(plan, H, W))
    return ChainOperators(Hmat.contiguous(), Wmat.t().contiguous(), Hmat.t().contiguous(), Wmat.contiguous())


# ------------------------------------------------------------------ plain versions

def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def fused_resample_plain(x: torch.Tensor, wmT: torch.Tensor, hm: torch.Tensor) -> torch.Tensor:
    """hm @ (x @ wmT) per plane, each product rounded to x's dtype."""
    return torch.matmul(hm, torch.matmul(x, wmT))


def fused_act_resample_plain(
    x: torch.Tensor, bias: torch.Tensor, wmT: torch.Tensor, hm: torch.Tensor,
    negative_slope: float = 0.2, scale: float = SQRT2,
) -> torch.Tensor:
    """The unfused pair: fused_leaky_relu, then the two products."""
    return fused_resample_plain(fused_leaky_relu(x, bias, negative_slope, scale), wmT, hm)


def _act_mask(x: torch.Tensor, bias: torch.Tensor, negative_slope: float, scale: float) -> torch.Tensor:
    """d act / d pre-activation in the accumulation dtype: scale where x + bias >= 0,
    else scale * slope; from the input, as the backward kernel takes it."""
    acc = _acc(x.dtype)
    pre = x.to(acc) + bias.to(x.dtype).to(acc).reshape(1, -1, 1, 1)
    return torch.where(pre >= 0, pre.new_tensor(scale), pre.new_tensor(scale * negative_slope))


def fused_act_resample_bwd_plain(
    g: torch.Tensor, x: torch.Tensor, bias: torch.Tensor, wm: torch.Tensor, hmT: torch.Tensor,
    negative_slope: float = 0.2, scale: float = SQRT2,
) -> torch.Tensor:
    """dx of fused_act_resample: ((hmT @ g, rounded) @ wm in float32) * mask, rounded."""
    acc = _acc(x.dtype)
    t = torch.matmul(hmT, g)
    gy = torch.matmul(t.to(acc), wm.to(acc))
    return (gy * _act_mask(x, bias, negative_slope, scale)).to(x.dtype)


# ------------------------------------------------------------------ CUDA wrappers

_ENTRY = {torch.float32: "f32", torch.bfloat16: "bf16"}
_PTR, _INT, _FLT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_FWD_ARGS = [_PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _INT, _INT, _FLT, _FLT, _PTR]
_BWD_ARGS = [_PTR, _PTR, _PTR, _PTR, _PTR, _PTR, _INT, _INT, _INT, _INT, _INT, _INT, _FLT, _FLT, _PTR]


def _check_chain_args(name, x, bias, right, left):
    """x (B, C, rows_in, cols_in) contiguous on a card; `right` (cols_in, cols_out) and
    `left` (rows_out, rows_in) dense, contiguous, same dtype and device; bias (C,)."""
    if x.ndim != 4 or not x.is_cuda:
        raise ValueError(f"{name} needs a (B, C, H, W) tensor on a CUDA device, got {tuple(x.shape)} on {x.device}")
    rows_in, cols_in = x.shape[-2:]
    if x.dtype not in _ENTRY:
        raise TypeError(f"{name} takes float32 or bfloat16, got {x.dtype}")
    for t in (right, left) + (() if bias is None else (bias,)):
        if t.device != x.device:
            raise ValueError(f"{name} needs every tensor on {x.device}, got one on {t.device}")
    for m in (right, left):
        if m.dtype != x.dtype or m.ndim != 2 or not m.is_contiguous():
            raise ValueError(f"{name} needs contiguous 2-D operators of dtype {x.dtype}")
    if right.shape[0] != cols_in or left.shape[1] != rows_in:
        raise ValueError(f"{name}: operators {tuple(left.shape)}, {tuple(right.shape)} do not fit planes {(rows_in, cols_in)}")
    if max(rows_in, left.shape[0]) > MAX_ROWS or max(cols_in, right.shape[1]) > MAX_COLS:
        raise ValueError(
            f"{name} takes planes of at most {MAX_ROWS} x {MAX_COLS} in and out, "
            f"got {(rows_in, cols_in)} -> {(left.shape[0], right.shape[1])}"
        )
    if bias is not None and tuple(bias.shape) != (x.shape[1],):
        raise ValueError(f"bias {tuple(bias.shape)} does not match channels of {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} needs a contiguous input")


def fused_chain_fwd_cuda(
    x: torch.Tensor, bias: Optional[torch.Tensor], wmT: torch.Tensor, hm: torch.Tensor,
    negative_slope: float = 0.2, scale: float = SQRT2,
) -> torch.Tensor:
    """Launch the forward kernel on x's current stream; counts its launches.

    x (B, C, H, W); bias (C,) or None (no activation); wmT (W, Wo) and hm (Ho, H) are
    general dense operators in x's dtype. Returns (B, C, Ho, Wo)."""
    _check_chain_args("fused_chain_fwd_cuda", x, bias, wmT, hm)
    (B, C, H, W), Ho, Wo = x.shape, hm.shape[0], wmT.shape[1]
    out = torch.empty((B, C, Ho, Wo), device=x.device, dtype=x.dtype)
    if out.numel() == 0:
        return out
    b = None if bias is None else bias.to(x.dtype).contiguous()
    fn = getattr(kernels.library("fused_chain"), f"fused_chain_fwd_{_ENTRY[x.dtype]}")
    fn.argtypes, fn.restype = _FWD_ARGS, ctypes.c_int
    err = fn(
        x.data_ptr(), None if b is None else b.data_ptr(), wmT.data_ptr(), hm.data_ptr(), out.data_ptr(),
        B * C, C, H, W, Ho, Wo, int(b is not None), negative_slope, scale,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    kernels.check("fused_chain", err)
    fused_chain_fwd_cuda.launches += 1
    return out


fused_chain_fwd_cuda.launches = 0


def fused_chain_bwd_cuda(
    g: torch.Tensor, x: torch.Tensor, bias: torch.Tensor, wm: torch.Tensor, hmT: torch.Tensor,
    negative_slope: float = 0.2, scale: float = SQRT2,
) -> torch.Tensor:
    """Launch the backward kernel on x's current stream; counts its launches.

    g (B, C, Ho, Wo) is the gradient of fused_act_resample's output, x (B, C, H, W) its
    saved input, bias (C,); wm (Wo, W) and hmT (H, Ho) the transposed operators in x's
    dtype. Returns dx (B, C, H, W); d(bias) is a sum of dx outside."""
    _check_chain_args("fused_chain_bwd_cuda", g, bias, wm, hmT)
    (B, C, Ho, Wo), H, W = g.shape, hmT.shape[0], wm.shape[1]
    if tuple(x.shape) != (B, C, H, W) or x.dtype != g.dtype or x.device != g.device or not x.is_contiguous():
        raise ValueError(f"fused_chain_bwd_cuda: input {tuple(x.shape)} {x.dtype} does not fit gradient {tuple(g.shape)} {g.dtype}")
    dx = torch.empty_like(x)
    if dx.numel() == 0:
        return dx
    b = bias.to(x.dtype).contiguous()
    fn = getattr(kernels.library("fused_chain"), f"fused_chain_bwd_{_ENTRY[x.dtype]}")
    fn.argtypes, fn.restype = _BWD_ARGS, ctypes.c_int
    err = fn(
        g.data_ptr(), x.data_ptr(), b.data_ptr(), wm.data_ptr(), hmT.data_ptr(), dx.data_ptr(),
        B * C, C, H, W, Ho, Wo, scale, scale * negative_slope,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    kernels.check("fused_chain", err)
    fused_chain_bwd_cuda.launches += 1
    return dx


fused_chain_bwd_cuda.launches = 0


# ------------------------------------------------------------------ dispatch + autograd

def _forward(x, bias, ops: ChainOperators, negative_slope, scale):
    """The chain's forward on x's device; bias None means no activation."""
    if x.device.type == "cuda":
        return fused_chain_fwd_cuda(x.contiguous(), bias, ops.wmT, ops.hm, negative_slope, scale)
    if x.device.type != "cpu":
        raise ValueError(f"fused chain: unsupported device {x.device}")
    if bias is None:
        return fused_resample_plain(x, ops.wmT, ops.hm)
    return fused_act_resample_plain(x, bias, ops.wmT, ops.hm, negative_slope, scale)


def _backward(g, x, bias, ops: ChainOperators, negative_slope, scale):
    if x.device.type == "cuda":
        return fused_chain_bwd_cuda(g.contiguous(), x.contiguous(), bias, ops.wm, ops.hmT, negative_slope, scale)
    if x.device.type != "cpu":
        raise ValueError(f"fused chain: unsupported device {x.device}")
    return fused_act_resample_bwd_plain(g, x, bias, ops.wm, ops.hmT, negative_slope, scale)


class _Resample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, ops):
        ctx.ops = ops
        return _forward(x, None, ops, 0.0, 1.0)

    @staticmethod
    def backward(ctx, g):
        return _Resample.apply(g.to(ctx.ops.hm.dtype), ctx.ops.adjoint), None


class _ActResample(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, bias, ops, negative_slope, scale):
        ctx.save_for_backward(x, bias)
        ctx.ops, ctx.negative_slope, ctx.scale = ops, negative_slope, scale
        return _forward(x, bias, ops, negative_slope, scale)

    @staticmethod
    def backward(ctx, g):
        x, bias = ctx.saved_tensors
        dx = _ActResampleBackward.apply(g.to(x.dtype), x, bias, ctx.ops, ctx.negative_slope, ctx.scale)
        db = None
        if ctx.needs_input_grad[1]:
            db = dx.to(_acc(dx.dtype)).sum(dim=(0, 2, 3)).to(bias.dtype)
        return dx, db, None, None, None


class _ActResampleBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, g, x, bias, ops, negative_slope, scale):
        ctx.save_for_backward(x, bias)
        ctx.ops, ctx.negative_slope, ctx.scale = ops, negative_slope, scale
        return _backward(g, x, bias, ops, negative_slope, scale)

    @staticmethod
    def backward(ctx, gg):
        # dx = mask * adjoint(g) is linear in g, and the mask is piecewise constant
        x, bias = ctx.saved_tensors
        masked = (gg.to(_acc(x.dtype)) * _act_mask(x, bias, ctx.negative_slope, ctx.scale)).to(x.dtype)
        return _Resample.apply(masked, ctx.ops), None, None, None, None, None


def fused_resample(x: torch.Tensor, plan: ResamplePlan) -> torch.Tensor:
    """resample(x, plan) with both products in one pass; differentiable to any order."""
    H, W = x.shape[-2:]
    return _Resample.apply(x, chain_operators(plan, H, W, x.device, x.dtype))


def fused_act_resample(
    x: torch.Tensor, bias: torch.Tensor, plan: ResamplePlan, negative_slope: float = 0.2, scale: float = SQRT2
) -> torch.Tensor:
    """resample(leaky_relu(x + bias[c]) * scale, plan) in one pass over x.

    x (B, C, H, W); bias (C,). Differentiable twice (R1's double backward)."""
    H, W = x.shape[-2:]
    ops = chain_operators(plan, H, W, x.device, x.dtype)
    return _ActResample.apply(x, bias, ops, negative_slope, scale)
