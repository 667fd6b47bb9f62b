"""Fused elementwise -> resample chains: bias + leaky-ReLU + both resample passes in one
pass over the activation, and its backward.

Counterpart of dusty_gan_v2_tpu/ops/fused_chain.py. The discriminator's block runs
`bias_act -> blur` on its main path and a bare blur on its skip; unfused, the activation
is written, the W-pass reads it and writes an intermediate, and the H-pass reads that
and writes again. Here one kernel reads a plane once, applies the activation, runs both
resample passes with the intermediate held on chip, and writes the result.

    fused_act_resample(x, bias, plan)   resample(leaky_relu(x + bias[c]) * scale, plan)
    fused_resample(x, plan)             resample(x, plan)

Operator forms (`ChainOperators`, built once per plan, shape, device and dtype by
`chain_operators`): the dense (Ho, H) and (W, Wo) matrices of `resample` and their
transposes, which the plain versions multiply, and for each pass the padded-row ("ELL")
form the kernels read: per output index the input indices of its non-zeros, ascending,
and their values (`Ell`, `ell_rows`). The ring blur, 2x up and 2x down operators have at
most 4 non-zeros per row and column, so the kernels' work is proportional to the
non-zeros and bound by the bytes of the planes; a dense operator is an ELL of its full
width (`operators_from_dense`). `ChainOperators.adjoint` swaps every form at once.

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

Non-finite values: the kernels sum only an output's non-zero terms, so a NaN or Inf in
a plane reaches only the outputs whose band covers it, as in a direct convolution; the
plain versions' dense products (the CPU route) turn the whole plane NaN (0 * NaN).
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
    "ChainOperators", "Ell", "chain_operators", "ell_rows", "operators_from_dense", "fused_act_resample", "fused_resample",
    "fused_chain_fwd_cuda", "fused_chain_bwd_cuda",
    "fused_act_resample_plain", "fused_resample_plain", "fused_act_resample_bwd_plain",
    "MAX_ROWS", "MAX_COLS",
]

SQRT2 = math.sqrt(2.0)
# shape contract of the kernels: every H, Ho <= MAX_ROWS and every W, Wo <= MAX_COLS
# (all discriminator and generator sites of the 64x512 configuration)
MAX_ROWS, MAX_COLS = 128, 512


class Ell(NamedTuple):
    """Padded-row ("ELL") form of an (n_out, n_in) operator: for each output index, the
    input indices of its non-zeros in ascending order (int32) and their values (the
    operator's dtype), both (n_out, nnz), nnz the largest count over the rows. A shorter
    row is padded with value 0 at its last index (0 for an empty row): a padding term
    adds +0 and reads nothing the row does not already read."""

    idx: torch.Tensor
    val: torch.Tensor

    @property
    def nnz(self) -> int:
        return self.idx.shape[1]


def ell_rows(m: torch.Tensor) -> Ell:
    """The ELL form of the rows of m, on m's device."""
    mc = m.detach().cpu()
    n_out, n_in = mc.shape
    nz = mc != 0
    count = nz.sum(dim=1, keepdim=True)
    nnz = max(int(count.max()), 1)
    cols = torch.arange(n_in).expand(n_out, n_in)
    idx = torch.where(nz, cols, cols + n_in).argsort(dim=1)[:, :nnz]  # non-zeros first, ascending
    real = nz.gather(1, idx)
    last = torch.where(count > 0, idx.gather(1, (count - 1).clamp(min=0)), 0)
    idx = torch.where(real, idx, last)
    val = torch.where(real, mc.gather(1, idx), torch.zeros((), dtype=mc.dtype))
    return Ell(idx.to(device=m.device, dtype=torch.int32).contiguous(), val.to(m.device).contiguous())


class ChainOperators(NamedTuple):
    """The operators of one resampling on one device, out = hm (Ho, H) @ x (H, W) @ wmT
    (W, Wo): dense, with their transposes (the plain versions), and in ELL form as each
    pass contracts them (the kernels): `hm_ell` per output row of the H-pass (the rows of
    hm), `wmT_ell` per output column of the W-pass (the columns of wmT), and `hmT_ell`,
    `wm_ell` the same for the adjoint map."""

    hm: torch.Tensor
    wmT: torch.Tensor
    hmT: torch.Tensor
    wm: torch.Tensor
    hm_ell: Ell
    wmT_ell: Ell
    hmT_ell: Ell
    wm_ell: Ell

    @property
    def adjoint(self) -> "ChainOperators":
        """The operators of the transposed map, (Ho, Wo) planes -> (H, W) planes."""
        return ChainOperators(self.hmT, self.wm, self.hm, self.wmT, self.hmT_ell, self.wm_ell, self.hm_ell, self.wmT_ell)


def operators_from_dense(hm: torch.Tensor, wmT: torch.Tensor) -> ChainOperators:
    """Every form of the chain hm (Ho, H) @ x @ wmT (W, Wo), for any dense operators."""
    hm, wmT = hm.contiguous(), wmT.contiguous()
    hmT, wm = hm.t().contiguous(), wmT.t().contiguous()
    return ChainOperators(hm, wmT, hmT, wm, ell_rows(hm), ell_rows(wm), ell_rows(hmT), ell_rows(wmT))


@functools.lru_cache(maxsize=None)
def chain_operators(plan: ResamplePlan, H: int, W: int, device: torch.device, dtype: torch.dtype) -> ChainOperators:
    Hmat, Wmat = (torch.from_numpy(m).to(device=device, dtype=dtype) for m in _resample_matrices(plan, H, W))
    return operators_from_dense(Hmat, Wmat.t())


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
    return torch.where(pre >= 0, pre.new_full((), scale), pre.new_full((), scale * negative_slope))


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
_FWD_ARGS = [_PTR, _PTR, _PTR, _PTR, _INT, _PTR, _PTR, _INT, _PTR] + [_INT] * 7 + [_FLT, _FLT, _PTR]
_BWD_ARGS = [_PTR, _PTR, _PTR, _PTR, _PTR, _INT, _PTR, _PTR, _INT, _PTR] + [_INT] * 6 + [_FLT, _FLT, _PTR]


def _check_aligned(name, *tensors):
    """The kernels read their input planes and the ELL rows in 16-byte vectors: a view
    that starts elsewhere in its storage would fault on the card."""
    for v in tensors:
        if v.data_ptr() % 16:
            raise ValueError(f"{name} needs 16-byte-aligned tensors, got one at storage offset "
                             f"{v.storage_offset()}: pass a copy")


def _check_chain_args(name, x, bias, ops: ChainOperators):
    """x (B, C, H, W) contiguous and 16-byte aligned on a card, in the planes the operators
    take; every form of `ops` on x's device in x's dtype (indices int32), contiguous and
    aligned; bias (C,) or None."""
    if x.ndim != 4 or not x.is_cuda:
        raise ValueError(f"{name} needs a (B, C, H, W) tensor on a CUDA device, got {tuple(x.shape)} on {x.device}")
    if x.dtype not in _ENTRY:
        raise TypeError(f"{name} takes float32 or bfloat16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} needs a contiguous input")
    (Ho, H), (W, Wo) = ops.hm.shape, ops.wmT.shape
    if tuple(x.shape[-2:]) != (H, W):
        raise ValueError(f"{name}: operators {(Ho, H)}, {(W, Wo)} do not fit planes {tuple(x.shape[-2:])}")
    if max(H, Ho) > MAX_ROWS or max(W, Wo) > MAX_COLS:
        raise ValueError(f"{name} takes planes of at most {MAX_ROWS} x {MAX_COLS} in and out, got {(H, W)} -> {(Ho, Wo)}")
    for e, n_out in ((ops.hm_ell, Ho), (ops.wmT_ell, Wo), (ops.hmT_ell, H), (ops.wm_ell, W)):
        if e.idx.dtype != torch.int32 or e.val.dtype != x.dtype or e.idx.shape != e.val.shape or e.idx.shape[0] != n_out:
            raise ValueError(f"{name} needs ELL forms of dtype {x.dtype} with int32 indices that fit the operators")
        if not (e.idx.is_contiguous() and e.val.is_contiguous()):
            raise ValueError(f"{name} needs contiguous ELL forms (the kernel reads their rows as vectors)")
        if e.idx.device != x.device or e.val.device != x.device:
            raise ValueError(f"{name} needs every tensor on {x.device}, got one on {e.idx.device}")
        _check_aligned(name, e.idx, e.val)
    _check_aligned(name, x)
    if bias is not None and (tuple(bias.shape) != (x.shape[1],) or bias.device != x.device):
        raise ValueError(f"bias {tuple(bias.shape)} on {bias.device} does not match {tuple(x.shape)} on {x.device}")


def fused_chain_fwd_cuda(
    x: torch.Tensor, bias: Optional[torch.Tensor], ops: ChainOperators,
    negative_slope: float = 0.2, scale: float = SQRT2,
) -> torch.Tensor:
    """Launch the forward kernel on x's current stream; counts its launches.

    x (B, C, H, W); bias (C,) or None (no activation); the kernel reads the operators'
    ELL forms `ops.wmT_ell` and `ops.hm_ell` (pass `ops.adjoint` for the adjoint map).
    Returns (B, C, Ho, Wo)."""
    _check_chain_args("fused_chain_fwd_cuda", x, bias, ops)
    (B, C, H, W), Ho, Wo = x.shape, ops.hm.shape[0], ops.wmT.shape[1]
    out = torch.empty((B, C, Ho, Wo), device=x.device, dtype=x.dtype)
    if out.numel() == 0:
        return out
    b = None if bias is None else bias.to(x.dtype).contiguous()
    w, h = ops.wmT_ell, ops.hm_ell
    fn = getattr(kernels.library("fused_chain"), f"fused_chain_fwd_{_ENTRY[x.dtype]}")
    fn.argtypes, fn.restype = _FWD_ARGS, ctypes.c_int
    err = fn(
        x.data_ptr(), None if b is None else b.data_ptr(), w.idx.data_ptr(), w.val.data_ptr(), w.nnz,
        h.idx.data_ptr(), h.val.data_ptr(), h.nnz, out.data_ptr(),
        B * C, C, H, W, Ho, Wo, int(b is not None), negative_slope, scale,
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    kernels.check("fused_chain", err)
    fused_chain_fwd_cuda.launches += 1
    return out


fused_chain_fwd_cuda.launches = 0


def fused_chain_bwd_cuda(
    g: torch.Tensor, x: torch.Tensor, bias: torch.Tensor, ops: ChainOperators,
    negative_slope: float = 0.2, scale: float = SQRT2,
) -> torch.Tensor:
    """Launch the backward kernel on x's current stream; counts its launches.

    g (B, C, Ho, Wo) is the gradient of fused_act_resample's output, x (B, C, H, W) its
    saved input, bias (C,), `ops` the forward's operators (the kernel reads the adjoint
    forms `ops.hmT_ell` and `ops.wm_ell`). Returns dx (B, C, H, W); d(bias) is a sum of dx
    outside."""
    if bias is None:
        raise ValueError("fused_chain_bwd_cuda needs the bias")
    _check_chain_args("fused_chain_bwd_cuda", g, bias, ops.adjoint)
    (B, C, Ho, Wo), H, W = g.shape, ops.hm.shape[1], ops.wmT.shape[0]
    if tuple(x.shape) != (B, C, H, W) or x.dtype != g.dtype or x.device != g.device or not x.is_contiguous():
        raise ValueError(f"fused_chain_bwd_cuda: input {tuple(x.shape)} {x.dtype} does not fit gradient {tuple(g.shape)} {g.dtype}")
    dx = torch.empty_like(x)
    if dx.numel() == 0:
        return dx
    b = bias.to(x.dtype).contiguous()
    w, h = ops.wm_ell, ops.hmT_ell
    fn = getattr(kernels.library("fused_chain"), f"fused_chain_bwd_{_ENTRY[x.dtype]}")
    fn.argtypes, fn.restype = _BWD_ARGS, ctypes.c_int
    err = fn(
        g.data_ptr(), x.data_ptr(), b.data_ptr(), w.idx.data_ptr(), w.val.data_ptr(), w.nnz,
        h.idx.data_ptr(), h.val.data_ptr(), h.nnz, dx.data_ptr(),
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
        return fused_chain_fwd_cuda(x.contiguous(), bias, ops, negative_slope, scale)
    if x.device.type != "cpu":
        raise ValueError(f"fused chain: unsupported device {x.device}")
    if bias is None:
        return fused_resample_plain(x, ops.wmT, ops.hm)
    return fused_act_resample_plain(x, bias, ops.wmT, ops.hm, negative_slope, scale)


def _backward(g, x, bias, ops: ChainOperators, negative_slope, scale):
    if x.device.type == "cuda":
        return fused_chain_bwd_cuda(g.contiguous(), x.contiguous(), bias, ops, negative_slope, scale)
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
