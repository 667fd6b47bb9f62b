"""Ring (circular-azimuth) padding of one axis.

Counterpart of dusty_gan_v2_tpu/ops/pad.py::_pad_axis, circular, replicate and reflect
modes: LiDAR range images are periodic along the azimuth (W), so W pads circularly and
H by edge replication; the SWD metric's Gaussian pyramid pads both axes by reflection.
"""

from __future__ import annotations

import torch

__all__ = ["pad_axis"]


def pad_axis(x: torch.Tensor, axis: int, lo: int, hi: int, mode: str) -> torch.Tensor:
    """Pad one axis by (lo, hi): "circular" wraps around, "replicate" repeats the edge,
    "reflect" mirrors without repeating the edge."""
    if lo == 0 and hi == 0:
        return x
    n = x.shape[axis]
    if mode == "circular":
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
