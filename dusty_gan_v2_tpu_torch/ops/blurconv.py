"""Blur folded into the following strided convolution (the dusty_v2 D forward route).

Counterpart of dusty_gan_v2_tpu/ops/blurconv.py. A discriminator block runs
`blur -> conv3x3 s2` on its main path and `blur -> conv1x1 s2` on its skip. Both ops are
linear, so in the interior they compose into one dense strided convolution with kernel
`conv (*) outer(taps, taps)`: 6x6 for the 3x3 conv, 4x4 for the 1x1 skip. The composite
runs with zero padding; the circular-W wrap contributions are added back as per-column
correction einsums, and the few H-boundary output rows whose replicate padding does not
compose into a single convolution are recomputed through the two-stage op on a thin band
of rows and replace the composite's rows. Equal to blur -> conv up to reassociation.

All plain differentiable torch ops: F.conv2d does the work on either device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["blur_conv3x3s2_ring", "blur_conv1x1s2_ring", "blur_conv_fusable"]


@functools.lru_cache(maxsize=None)
def _tap_matrix(window, k: int) -> np.ndarray:
    """T[u, t] = taps[u - t] (0 outside): the banded matrix with
    k_comp = sum_{t+a=u} w[t] * taps[a] = (T @ w) along one axis."""
    taps = np.asarray(window, np.float64)
    taps = taps / taps.sum()
    n = len(window)
    T = np.zeros((k + n - 1, k), np.float32)
    for u in range(k + n - 1):
        for t in range(k):
            if 0 <= u - t < n:
                T[u, t] = taps[u - t]
    return T


def _norm_taps(window, like: torch.Tensor) -> torch.Tensor:
    t = np.asarray(window, np.float64)
    return torch.from_numpy(t / t.sum()).to(device=like.device, dtype=like.dtype)


def blur_conv_fusable(x_shape, kernel_size: int, stride, padding: int, ring: bool, h_mode: str) -> bool:
    """Whether the blur -> conv pair at this site composes into the fused op."""
    H, W = x_shape[-2], x_shape[-1]
    s = stride if isinstance(stride, int) else stride[0]
    return bool(
        ring
        and h_mode == "replicate"
        and s == 2
        and ((kernel_size == 3 and padding == 1) or (kernel_size == 1 and padding == 0))
        and H % 2 == 0
        and W % 2 == 0
        and H >= 6
        and W >= 8
    )


def _check(x, w, k, window):
    H, W = x.shape[-2:]
    if tuple(w.shape[-2:]) != (k, k) or len(window) != 4:
        raise ValueError(f"expected a {k}x{k} kernel and a 4-tap window, got {tuple(w.shape)}, {window}")
    if H % 2 or W % 2 or H < 6 or W < 8:
        raise ValueError(f"the composite needs even H >= 6 and W >= 8, got {(H, W)}")


def _depthwise_1d(x: torch.Tensor, taps: torch.Tensor, axis: int) -> torch.Tensor:
    """VALID depthwise correlation of NCHW x with 1-D taps along H (-2) or W (-1)."""
    C = x.shape[1]
    shape = (1, 1, 1, -1) if axis == -1 else (1, 1, -1, 1)
    return F.conv2d(x, taps.reshape(shape).expand(C, *shape[1:]).contiguous(), groups=C)


def _col_corr(strip: torch.Tensor, ktaps: torch.Tensor, pad_top: int, pad_bottom: int, oH: int) -> torch.Tensor:
    """(B, O, oH): what the columns `strip` (B, I, H, c) add to one output column
    through the kernel columns `ktaps` (O, I, k, c), rows zero-padded."""
    ext = F.pad(strip, (0, 0, pad_top, pad_bottom))
    sl = torch.stack([ext[:, :, u : u + 2 * (oH - 1) + 1 : 2] for u in range(ktaps.shape[2])], dim=2)
    return torch.einsum("oiuc,biunc->bon", ktaps, sl)  # sl (B, I, k, oH, c)


def _add_col(y: torch.Tensor, d: torch.Tensor, col: int) -> torch.Tensor:
    """y (B, O, oH, oW) with d (B, O, oH) added to output column `col`."""
    return y + F.pad(d.unsqueeze(-1), (col, y.shape[-1] - 1 - col))


def blur_conv3x3s2_ring(x: torch.Tensor, w: torch.Tensor, window=(1, 3, 3, 1)) -> torch.Tensor:
    """`conv_ring_fast(resample(x, blur_plan), w, (2, 2))` as one strided 6x6 convolution
    plus boundary corrections.

    x (B, I, H, W); w (O, I, 3, 3) already LR-scaled, any float dtype (the composite
    kernel is built in w's dtype, then cast to x's). Blur: 4-tap normalized FIR,
    circular-W pad (2, 1), replicate-H pad (2, 1); conv: 3x3 stride 2, circular-W /
    replicate-H pad 1. The composite has 36 taps against 9, so it trades passes over the
    activation for convolution work: the forward-only route."""
    _check(x, w, 3, window)
    B, I, H, W = x.shape
    oH, oW = H // 2, W // 2
    T = torch.from_numpy(_tap_matrix(tuple(float(v) for v in window), 3)).to(device=w.device, dtype=w.dtype)
    k6 = torch.einsum("oits,ut,vs->oiuv", w, T, T).to(x.dtype)  # (O, I, 6, 6)

    # interior: output (o, v) reads x~[2o-3+u, 2v-3+c]; zero H/W pads
    y = F.conv2d(F.pad(x, (3, 2, 3, 2)), k6, stride=2)

    # circular-W wrap corrections (zero-H semantics; the H-boundary rows these get
    # wrong are replaced by the band recomputes below):
    #   col 0 reads x~ cols -3..-1 = x[W-3..W-1] against kernel cols 0..2
    #   col 1 reads x~ col  -1     = x[W-1]      against kernel col  0
    #   col oW-1 reads x~ col W    = x[0]        against kernel col  5
    y = _add_col(y, _col_corr(x[..., W - 3 :], k6[..., 0:3], 3, 2, oH), 0)
    y = _add_col(y, _col_corr(x[..., W - 1 :], k6[..., 0:1], 3, 2, oH), 1)
    y = _add_col(y, _col_corr(x[..., 0:1], k6[..., 5:6], 3, 2, oH), oW - 1)

    # H-boundary rows through the two-stage op on thin bands. Output rows 0 and 1 read
    # the conv's replicate pad row b~[-1] = b[0] and blur rows built from x's replicate
    # pad; row oH-1 reads blur row b[H-1] built from x~[H] = x[H-1].
    t4 = _norm_taps(window, x)
    wj = w.to(x.dtype)

    def blur_valid(xb):
        return _depthwise_1d(_depthwise_1d(xb, t4, -1), t4, -2)

    def wrap_w(xb):  # the blur's (2, 1) plus the conv's (1, 1) circular-W margin: cols -3..W+1
        return torch.cat([xb[..., W - 3 :], xb, xb[..., :2]], dim=3)

    xb = wrap_w(x[:, :, 0:5])
    xb = torch.cat([xb[:, :, :1], xb[:, :, :1], xb], dim=2)  # 7 rows
    bb = blur_valid(xb)  # (B, I, 4, W+2): b rows 0..3, cols -1..W
    bb = torch.cat([bb[:, :, :1], bb], dim=2)  # b~[-1] = b[0]
    y_top = F.conv2d(bb, wj, stride=2)  # (B, O, 2, oW)

    xb = wrap_w(x[:, :, H - 5 :])
    xb = torch.cat([xb, xb[:, :, -1:]], dim=2)  # 6 rows (x~[H] = x[H-1])
    y_bot = F.conv2d(blur_valid(xb), wj, stride=2)  # blur rows H-3..H-1 -> (B, O, 1, oW)

    return torch.cat([y_top, y[:, :, 2 : oH - 1], y_bot], dim=2)


def blur_conv1x1s2_ring(x: torch.Tensor, w: torch.Tensor, window=(1, 3, 3, 1)) -> torch.Tensor:
    """`conv1x1_s2(resample(x, blur_plan))` (the block's skip: no conv padding) as one
    strided 4x4 convolution plus boundary corrections.

    x (B, I, H, W); w (O, I, 1, 1) already LR-scaled. Output (o, v) reads
    blur[2o, 2v] = sum_{a,c} taps[a] taps[c] x~[2o-2+a, 2v-2+c]: only output row 0
    touches the replicate-H pad (a pure extension here, there is no second-stage pad, so
    a replicate-extended band recompute is exact) and only output column 0 the W wrap."""
    _check(x, w, 1, window)
    B, I, H, W = x.shape
    oH = H // 2
    t4w = _norm_taps(window, w)
    k4 = torch.einsum("oi,a,c->oiac", w[:, :, 0, 0], t4w, t4w).to(x.dtype)

    y = F.conv2d(F.pad(x, (2, 0, 2, 0)), k4, stride=2)
    # W wrap: out col 0 reads x~ cols -2..-1 = x[W-2..W-1] against kernel cols 0..1
    y = _add_col(y, _col_corr(x[..., W - 2 :], k4[..., 0:2], 2, 0, oH), 0)

    # H top row: replicate-extend 2 rows (exact: single-stage op) + the W wrap band
    xb = x[:, :, 0:2]
    xb = torch.cat([xb[..., W - 2 :], xb], dim=3)
    xb = torch.cat([xb[:, :, :1], xb[:, :, :1], xb], dim=2)  # 4 rows
    y_top = F.conv2d(xb, k4, stride=2)  # (B, O, 1, oW)
    return torch.cat([y_top, y[:, :, 1:]], dim=2)
