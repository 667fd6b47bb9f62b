"""FIR up/down resampling with ring (circular-azimuth) padding.

Counterpart of dusty_gan_v2_tpu/ops/resample.py: margin pad (circular W / replicate H)
-> zero-insertion upsample -> crop -> separable FIR -> strided downsample. The op is
linear and factorizes per axis, so the port takes the JAX package's matrix form: each
axis's pipeline is applied once to an identity basis (in float64, on the CPU) to give
dense (H_out, H) and (W_out, W) operators, and `resample` is two matmuls.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .pad import pad_axis

__all__ = ["ResamplePlan", "make_resample", "resample"]


def _pair(v):
    if isinstance(v, (tuple, list)):
        assert len(v) == 2
        return (int(v[0]), int(v[1]))
    return (int(v), int(v))


class ResamplePlan:
    """Static configuration of one resampling (reference Resample.__init__)."""

    def __init__(
        self,
        up=1,
        down=1,
        window: Sequence[float] = (1, 3, 3, 1),
        ring: bool = True,
        normalize: bool = True,
        direction: str = "hw",
    ):
        assert direction in ("h", "w", "hw")
        self.up = _pair(up)
        self.down = _pair(down)
        self.window = tuple(float(w) for w in window)
        self.n_taps = len(self.window)
        self.ring = ring
        self.pad_mode_w = "circular" if ring else "replicate"
        self.pad_mode_h = "replicate"
        self.direction = direction

        if "h" in direction:
            self.k_h, self.up_h, self.down_h = self.n_taps, self.up[0], self.down[0]
        else:
            self.k_h = self.up_h = self.down_h = 1
        if "w" in direction:
            self.k_w, self.up_w, self.down_w = self.n_taps, self.up[1], self.down[1]
        else:
            self.k_w = self.up_w = self.down_w = 1

        kernel = np.asarray(self.window, np.float64)
        if normalize:
            kernel = kernel / kernel.sum()
        self.kernel = kernel * (self.up_h * self.up_w) ** 0.5

        # padding amounts (reference common.py:89-103)
        if self.up[0] > 1:
            self.ph0 = (self.k_h - self.up_h + 1) // 2 + self.up_h - 1
            self.ph1 = (self.k_h - self.up_h) // 2
        else:
            self.ph0 = (self.k_h - self.down_h + 1) // 2
            self.ph1 = (self.k_h - self.down_h) // 2
        if self.up[1] > 1:
            self.pw0 = (self.k_w - self.up_w + 1) // 2 + self.up_w - 1
            self.pw1 = (self.k_w - self.up_w) // 2
        else:
            self.pw0 = (self.k_w - self.down_w + 1) // 2
            self.pw1 = (self.k_w - self.down_w) // 2

        self.margin = max(self.ph0, self.ph1, self.pw0, self.pw1)
        self.normalize = bool(normalize)

    def _key(self):
        return (self.up, self.down, self.window, self.ring, self.normalize, self.direction)

    def __eq__(self, other):
        return isinstance(other, ResamplePlan) and self._key() == other._key()

    def __hash__(self):
        return hash(self._key())

    def out_shape(self, h: int, w: int) -> Tuple[int, int]:
        oh = (h * self.up_h + self.ph0 + self.ph1 - self.k_h) // self.down_h + 1
        ow = (w * self.up_w + self.pw0 + self.pw1 - self.k_w) // self.down_w + 1
        return oh, ow


@functools.lru_cache(maxsize=None)
def make_resample(
    up=1, down=1, window=(1, 3, 3, 1), ring=True, normalize=True, direction="hw"
) -> ResamplePlan:
    """Cached plan constructor (hashable args only)."""
    return ResamplePlan(up, down, window, ring, normalize, direction)


def _fir_last_axis(x, kernel, up, down, lo, hi):
    """Along the last axis of the margin-padded `x`: insert up-1 zeros between samples
    (none after the last one, as lhs dilation does), pad by (lo, hi) zeros (negative
    values crop), correlate with `kernel` (no flip) and keep every down-th output."""
    n = x.shape[-1]
    if up > 1:
        z = x.new_zeros(*x.shape[:-1], (n - 1) * up + 1)
        z[..., ::up] = x
        x = z
    x = F.pad(x, (lo, hi))
    return x.unfold(-1, kernel.shape[0], down) @ kernel


def _axis_matrix(plan: ResamplePlan, n: int, axis: str) -> np.ndarray:
    """(n_out, n) operator of the plan along one axis ("h" or "w")."""
    m = plan.margin
    if axis == "h":
        k, up, down, p0, p1, mode = plan.k_h, plan.up_h, plan.down_h, plan.ph0, plan.ph1, plan.pad_mode_h
    else:
        k, up, down, p0, p1, mode = plan.k_w, plan.up_w, plan.down_w, plan.pw0, plan.pw1, plan.pad_mode_w
    kernel = torch.from_numpy(plan.kernel if k > 1 else np.ones(1))
    # crop offsets relative to the reference's zero-inserted array: start = m*up - p0,
    # end = (size - m)*up + p1; the dilated array has no trailing zeros, so the high
    # side needs up-1 more
    lo = p0 - m * up
    hi = p1 - m * up + (up - 1)
    basis = pad_axis(torch.eye(n, dtype=torch.float64), -1, m, m, mode)  # row c = e_c
    return _fir_last_axis(basis, kernel, up, down, lo, hi).T.numpy()


@functools.lru_cache(maxsize=None)
def _resample_matrices(plan: ResamplePlan, H: int, W: int) -> Tuple[np.ndarray, np.ndarray]:
    """Dense float32 (H_out, H) and (W_out, W) operators of the plan."""
    return (
        _axis_matrix(plan, H, "h").astype(np.float32),
        _axis_matrix(plan, W, "w").astype(np.float32),
    )


@functools.lru_cache(maxsize=None)
def _matrices_on(plan: ResamplePlan, H: int, W: int, device: torch.device, dtype: torch.dtype):
    Hmat, Wmat = _resample_matrices(plan, H, W)
    to = dict(device=device, dtype=dtype)
    return torch.from_numpy(Hmat).to(**to), torch.from_numpy(Wmat).t().contiguous().to(**to)


def resample(x: torch.Tensor, plan: ResamplePlan) -> torch.Tensor:
    """Apply a resampling plan to an NCHW tensor: a W-pass and an H-pass matmul."""
    H, W = x.shape[-2:]
    Hmat, WmatT = _matrices_on(plan, H, W, x.device, x.dtype)
    return torch.matmul(Hmat, torch.matmul(x, WmatT))
