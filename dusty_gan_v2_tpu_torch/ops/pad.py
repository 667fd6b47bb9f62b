"""Ring (circular-azimuth) padding, and the ring-padded 3x3 / 4x4 convolution.

Counterpart of dusty_gan_v2_tpu/ops/pad.py (_pad_axis, pad2d, conv_ring_fast,
convT4x4s2_ring_fast, filter2d):
LiDAR range images are periodic along the azimuth (W), so W pads circularly and H by edge
replication or reflection; the SWD metric's Gaussian pyramid pads both axes by
reflection.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["pad_axis", "pad2d", "conv_ring_fast", "conv3x3_ring_fast", "convT4x4s2_ring_fast", "filter2d"]


def pad_axis(x: torch.Tensor, axis: int, lo: int, hi: int, mode: str) -> torch.Tensor:
    """Pad one axis by (lo, hi): "circular" wraps around, "replicate" repeats the edge,
    "reflect" mirrors without repeating the edge, "zeros" pads with 0."""
    if lo == 0 and hi == 0:
        return x
    n = x.shape[axis]
    if mode == "zeros":
        shape = list(x.shape)
        shape[axis] = lo
        low = x.new_zeros(shape)
        shape[axis] = hi
        parts = [low, x, x.new_zeros(shape)]
    elif mode == "circular":
        if lo > n or hi > n:
            raise ValueError(f"circular pad ({lo},{hi}) > size {n}")
        parts = [x.narrow(axis, n - lo, lo), x, x.narrow(axis, 0, hi)]
    elif mode == "replicate":
        first, last = x.narrow(axis, 0, 1), x.narrow(axis, n - 1, 1)
        parts = [first.repeat_interleave(lo, axis), x, last.repeat_interleave(hi, axis)]
    elif mode == "reflect":
        if lo >= n or hi >= n:
            raise ValueError(f"reflect pad ({lo},{hi}) >= size {n}")
        parts = [x.narrow(axis, 1, lo).flip(axis), x, x.narrow(axis, n - hi - 1, hi).flip(axis)]
    else:
        raise ValueError(f"unknown pad mode: {mode}")
    return torch.cat(parts, dim=axis)


def pad2d(x: torch.Tensor, padding, ring: bool = False, mode: str = "replicate") -> torch.Tensor:
    """Pad an NCHW tensor by an int or (left, right, top, bottom): W circularly when
    `ring`, else by `mode`; H by `mode`."""
    if isinstance(padding, int):
        left = right = top = bottom = padding
    else:
        left, right, top, bottom = padding
    x = pad_axis(x, -1, left, right, "circular" if ring else mode)
    return pad_axis(x, -2, top, bottom, mode)


def conv_ring_fast(x: torch.Tensor, w: torch.Tensor, stride=(1, 1), h_mode: str = "replicate") -> torch.Tensor:
    """k x k convolution (k in {3, 4}, stride 1 or 2) over circular-W / `h_mode`-H
    padding 1: a VALID convolution of pad2d(x, 1, ring=True, mode=h_mode).

    The JAX function adds the wrap and edge contributions back as boundary corrections
    to spare a TPU the padded copy (and needs even H, W at stride 2 for it); here the
    padded copy is made and cuDNN convolves it, at any size.
    x (B, I, H, W); w (O, I, k, k), already scaled; returns (B, O, oH, oW)."""
    k, s = int(w.shape[-1]), int(stride[0])
    if stride[1] != stride[0] or s not in (1, 2) or tuple(w.shape[-2:]) != (k, k) or k not in (3, 4):
        raise ValueError(f"conv_ring_fast takes a 3x3 or 4x4 kernel at stride 1 or 2, got {tuple(w.shape)}, {stride}")
    if h_mode not in ("replicate", "reflect"):
        raise ValueError(f"conv_ring_fast pads H by replicate or reflect, got {h_mode!r}")
    return F.conv2d(pad2d(x, 1, ring=True, mode=h_mode), w, stride=(s, s))


def conv3x3_ring_fast(x: torch.Tensor, w: torch.Tensor, stride=(1, 1)) -> torch.Tensor:
    """3x3 circular-W / replicate-H convolution (conv_ring_fast with its default mode)."""
    return conv_ring_fast(x, w, stride, h_mode="replicate")


def convT4x4s2_ring_fast(x: torch.Tensor, w: torch.Tensor, h_mode: str = "reflect") -> torch.Tensor:
    """4 x 4 stride-2 transposed convolution at padding 3 over circular-W / `h_mode`-H
    padding 1: ConvT(pad2d(x, 1, ring=True, mode=h_mode), k=4, s=2, p=3), (H, W) -> (2H, 2W).

    `w` (I, O, 4, 4) is the transposed-convolution weight, already scaled (the JAX
    function takes its flipped transpose, the kernel of the equivalent dilated
    convolution). The JAX function adds the wrap and edge contributions back as boundary
    corrections to spare a TPU the padded copy; here the padded copy is made and cuDNN
    runs one transposed convolution on it."""
    if tuple(w.shape[-2:]) != (4, 4):
        raise ValueError(f"convT4x4s2_ring_fast takes a 4x4 kernel, got {tuple(w.shape)}")
    if h_mode not in ("replicate", "reflect"):
        raise ValueError(f"convT4x4s2_ring_fast pads H by replicate or reflect, got {h_mode!r}")
    return F.conv_transpose2d(pad2d(x, 1, ring=True, mode=h_mode), w, stride=2, padding=3)


def filter2d(x: torch.Tensor, kernel, gain: float = 1.0) -> torch.Tensor:
    """Separable blur with circular-W / replicate-H padding: the 1-D kernel is normalized
    to sum 1 and scaled by sqrt(gain) (so the 2-D gain is `gain`), x is padded by
    (k // 2, (k - 1) // 2) and filtered along W, then along H (no flip)."""
    k = torch.as_tensor(np.asarray(kernel, np.float32), device=x.device)
    if k.ndim != 1:
        raise ValueError(f"filter2d takes a 1-D kernel, got shape {tuple(k.shape)}")
    k = k / k.sum() * (gain ** 0.5)
    f, C = k.shape[0], x.shape[1]
    p0, p1 = f // 2, (f - 1) // 2
    x = pad_axis(x, -1, p0, p1, "circular")
    x = pad_axis(x, -2, p0, p1, "replicate")
    k = k.to(x.dtype)
    x = F.conv2d(x, k.reshape(1, 1, 1, f).expand(C, 1, 1, f), groups=C)
    return F.conv2d(x, k.reshape(1, 1, f, 1).expand(C, 1, f, 1), groups=C)
