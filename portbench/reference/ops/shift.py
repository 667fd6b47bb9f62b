"""Per-sample fractional circular shifts along W.

Counterpart of dusty_gan_v2_tpu/ops/shift.py::fractional_wrap_lerp, the shared kernel
of the generator's azimuth-shift cancellation and ADA's W warp. The JAX package selects
columns with a one-hot matmul because a batched gather's VJP is a scatter-add, a slow
path on a TPU; here it is two `torch.gather`s and the same final lerp, which gives the
same numbers (each selection is a single term).
"""

from __future__ import annotations

import torch

__all__ = ["fractional_wrap_lerp", "circular_translate_w"]


def fractional_wrap_lerp(x: torch.Tensor, idx0: torch.Tensor, frac: torch.Tensor) -> torch.Tensor:
    """out[..., o] = lerp(x[..., idx0[o]], x[..., idx0[o] + 1 mod Ws], frac[o]).

    x (B, C, H, Ws); idx0 (B, Wo) integer in [0, Ws); frac broadcastable to
    (B, 1, 1, Wo), in x's dtype."""
    B, C, H, Ws = x.shape
    i0 = idx0.long()[:, None, None, :].expand(B, C, H, -1)
    g0 = torch.gather(x, -1, i0)
    g1 = torch.gather(x, -1, torch.remainder(i0 + 1, Ws))
    return g0 * (1.0 - frac) + g1 * frac


def circular_translate_w(x: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Shift x (B, C, H, W) circularly along W by delta (B,) pixels:
    out[..., i] = lerp(x[i + floor(d)], x[i + floor(d) + 1]) (models/dusty_v2.py)."""
    W = x.shape[-1]
    i0 = torch.floor(delta)
    frac = (delta - i0)[:, None, None, None].to(x.dtype)
    base = torch.arange(W, device=x.device)[None]
    idx0 = torch.remainder(base + i0.long()[:, None], W)
    return fractional_wrap_lerp(x, idx0, frac)
