"""The precision of the reference's matrix work: "fp32" (the reference), or a control that
rounds the operands and the results of every matrix product, convolution, resampling and
Fourier-feature phase to "bf16" or to "fp8" (float8 e4m3 with one scale a tensor, its
largest magnitude at the format's 448), as a policy that stores them so would.

The rounding applies in both directions: the forward rounds the value, the backward rounds
the gradient that flows through it (and a double backward rounds again), as a step that
computes its gradients in that precision would.
TF32, the control of a float32 configuration with TF32 off, is no rounding here: the
caller turns on torch.backends' TF32 switches.
"""

from __future__ import annotations

import contextlib

import torch

_MODE = {"value": "fp32"}
FP8_MAX = 448.0


def mode() -> str:
    return _MODE["value"]


@contextlib.contextmanager
def use(value: str):
    """Run the reference with its matrix operands in `value` ("fp32", "bf16", "fp8")."""
    if value not in ("fp32", "bf16", "fp8"):
        raise ValueError(f"unknown reference precision {value!r}")
    old = _MODE["value"]
    _MODE["value"] = value
    try:
        yield
    finally:
        _MODE["value"] = old


def _round(x: torch.Tensor) -> torch.Tensor:
    m = _MODE["value"]
    if m == "bf16":
        return x.to(torch.bfloat16).to(x.dtype)
    amax = x.detach().abs().amax().float().clamp(min=1e-30)
    scale = FP8_MAX / amax
    return ((x.float() * scale).to(torch.float8_e4m3fn).float() / scale).to(x.dtype)


class _Rounded(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _round(x)

    @staticmethod
    def backward(ctx, g):
        return _Rounded.apply(g)


def q(x: torch.Tensor) -> torch.Tensor:
    """x with its values rounded to the current precision, and the gradient through it
    (identity in fp32)."""
    if _MODE["value"] == "fp32" or x.device.type == "meta" or not x.is_floating_point():
        return x
    return _Rounded.apply(x)
