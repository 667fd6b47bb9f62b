"""FIR up/down resampling with ring (circular-azimuth) padding.

Counterpart of dusty_gan_v2_tpu/ops/resample.py: margin pad (circular W / replicate H)
-> zero-insertion upsample -> crop -> separable FIR -> strided downsample. The op is
linear and factorizes per axis, so the port takes the JAX package's matrix form: each
axis's pipeline is applied once to an identity basis (in float64, on the CPU) to give
dense (H_out, H) and (W_out, W) operators, and `resample` is two matmuls.
`resample_sumsq` evaluates sum(resample(x)^2) at x's own resolution from the operators'
Gram factors (the generator's train-time ema_var statistic), and `upfirdn2d` is a numpy
upfirdn for building other constant operators (ADA's warp chain).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .pad import pad_axis
from ..precision import q

# the FLOP count (work.py): with COUNT["on"], `resample` and `resample_sumsq` compute no
# numbers (the count runs on the meta device) and a resampling adds its filter taps'
# multiply-adds, forward and backward, to COUNT["flops"] instead of its dense matrices'
COUNT = {"on": False, "flops": 0}

__all__ = ["ResamplePlan", "make_resample", "resample", "resample_sumsq", "blur_vh", "upfirdn2d"]


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


def _taps_flops(plan: ResamplePlan, n_planes: int, H: int, W: int) -> int:
    """Multiply-adds x 2 of one resampling by its filter taps: the W pass makes H x Wo
    outputs of ceil(k_w / up_w) taps each, the H pass Ho x Wo of ceil(k_h / up_h)."""
    Ho, Wo = plan.out_shape(H, W)
    tw, th = -(-plan.k_w // plan.up_w), -(-plan.k_h // plan.up_h)
    return 2 * n_planes * (H * Wo * tw + Ho * Wo * th)


class _Counted(torch.autograd.Function):
    """A resampling's shape and its count of taps, for the meta device; its backward is
    the adjoint's, which counts as much (a double backward counts again)."""

    @staticmethod
    def forward(ctx, x, plan, adjoint):
        H, W = x.shape[-2:]
        n = x.numel() // (H * W)
        if adjoint:  # x has the output's shape: the input's is the plan's preimage
            H, W = out = _preimage(plan, H, W)
        else:
            out = plan.out_shape(H, W)
        COUNT["flops"] += _taps_flops(plan, n, H, W)
        ctx.plan, ctx.adjoint = plan, adjoint
        return x.new_empty(x.shape[:-2] + tuple(out))

    @staticmethod
    def backward(ctx, g):
        return _Counted.apply(g, ctx.plan, not ctx.adjoint), None, None


def _preimage(plan: ResamplePlan, Ho: int, Wo: int) -> Tuple[int, int]:
    """The input size (H, W) whose output under `plan` is (Ho, Wo)."""
    H = next(h for h in range(1, 4 * Ho + 8) if plan.out_shape(h, 1)[0] == Ho)
    W = next(w for w in range(1, 4 * Wo + 8) if plan.out_shape(1, w)[1] == Wo)
    return H, W


def resample(x: torch.Tensor, plan: ResamplePlan) -> torch.Tensor:
    """Apply a resampling plan to an NCHW tensor: a W-pass and an H-pass matmul."""
    if COUNT["on"]:
        return _Counted.apply(x, plan, False)
    H, W = x.shape[-2:]
    Hmat, WmatT = _matrices_on(plan, H, W, x.device, x.dtype)
    return q(torch.matmul(Hmat, torch.matmul(q(x), WmatT)))


@functools.lru_cache(maxsize=None)
def _resample_gram(plan: ResamplePlan, H: int, W: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """Gram factors G_H = Hmat^T Hmat (H, H) and G_W = Wmat^T Wmat (W, W) of the plan at
    input size (H, W), accumulated in float64 and stored as float32, and the output
    plane size H_out * W_out. Since resample(x) = Hmat x Wmat^T per plane,
    sum(resample(x)^2) == sum(x * (G_H x G_W^T))."""
    Hm, Wm = (m.astype(np.float64) for m in _resample_matrices(plan, H, W))
    return (Hm.T @ Hm).astype(np.float32), (Wm.T @ Wm).astype(np.float32), Hm.shape[0] * Wm.shape[0]


@functools.lru_cache(maxsize=None)
def _gram_on(plan: ResamplePlan, H: int, W: int, device: torch.device):
    GH, GW, plane = _resample_gram(plan, H, W)
    return torch.from_numpy(GH).to(device), torch.from_numpy(GW).to(device), plane


def resample_sumsq(x: torch.Tensor, plan: ResamplePlan) -> Tuple[torch.Tensor, int]:
    """(sum(resample(x, plan)^2) in float32, number of resampled elements), without
    making the resampled tensor: two Gram products at x's resolution and one dot."""
    B, C, H, W = x.shape
    if COUNT["on"]:
        Ho, Wo = plan.out_shape(H, W)
        return x.float().square().sum(), B * C * Ho * Wo
    GH, GW, plane = _gram_on(plan, H, W, x.device)
    x32 = x.float()
    y = torch.matmul(GH, torch.matmul(x32, GW.t()))
    return (x32 * y).sum(), B * C * plane


def upfirdn2d(x: np.ndarray, kernel, up=(1, 1), down=(1, 1), pad=(0, 0, 0, 0)) -> np.ndarray:
    """Zero-insertion upsample -> pad (x0, x1, y0, y1; negative crops) -> FIR -> stride
    downsample over the last two axes of a numpy array, in float64, as
    dusty_gan_v2_tpu/ops/resample.py::upfirdn2d computes it: the upsampled axis keeps
    up - 1 zeros after its last sample, and the kernel is correlated (not flipped). A
    1-D kernel filters along W. For constant operators, not for training tensors."""
    up, down = _pair(up), _pair(down)
    k = np.asarray(kernel, np.float64)
    if k.ndim == 1:
        k = k.reshape(1, -1)
    px0, px1, py0, py1 = pad
    x = np.asarray(x, np.float64)
    *lead, h, w = x.shape
    z = np.zeros((*lead, h * up[0], w * up[1]))
    z[..., :: up[0], :: up[1]] = x
    z = np.pad(z, [(0, 0)] * len(lead) + [(max(py0, 0), max(py1, 0)), (max(px0, 0), max(px1, 0))])
    z = z[..., max(-py0, 0): z.shape[-2] - max(-py1, 0), max(-px0, 0): z.shape[-1] - max(-px1, 0)]
    kh, kw = k.shape
    oh, ow = z.shape[-2] - kh + 1, z.shape[-1] - kw + 1
    out = np.zeros((*lead, oh, ow))
    for i in range(kh):
        for j in range(kw):
            out += k[i, j] * z[..., i: i + oh, j: j + ow]
    return out[..., :: down[0], :: down[1]]


def blur_vh(x: torch.Tensor, window=(1, 2, 1), ring: bool = True) -> torch.Tensor:
    """NR-GAN vertical / horizontal anti-aliasing: the V-blur and the H-blur of x,
    concatenated along the channels (2x channels)."""
    pv = make_resample(window=tuple(window), ring=ring, direction="h")
    ph = make_resample(window=tuple(window), ring=ring, direction="w")
    return torch.cat([resample(x, pv), resample(x, ph)], dim=1)
