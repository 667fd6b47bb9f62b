"""The sensor's angle grid and the range image -> point cloud conversion."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["bilinear_resize", "resize_angle_lut", "image_to_points"]


def bilinear_resize(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """NCHW bilinear resize, F.interpolate(align_corners=False) semantics."""
    H, W = x.shape[-2:]
    OH, OW = size

    def axis_idx(n_in, n_out):
        src = (torch.arange(n_out, dtype=torch.float32, device=x.device) + 0.5) * (n_in / n_out) - 0.5
        src = torch.clamp(src, min=0.0)
        i0 = torch.clamp(torch.floor(src).long(), max=n_in - 1)
        i1 = torch.clamp(i0 + 1, max=n_in - 1)
        return i0, i1, (src - i0.float()).to(x.dtype)

    y0, y1, wy = axis_idx(H, OH)
    x0, x1, wx = axis_idx(W, OW)
    rows = x[..., y0, :] * (1 - wy)[:, None] + x[..., y1, :] * wy[:, None]
    return rows[..., x0] * (1 - wx) + rows[..., x1] * wx


def resize_angle_lut(angle_hw2: np.ndarray, size: Tuple[int, int], device) -> torch.Tensor:
    """(H0, W0, 2) (elevation, azimuth) LUT -> (1, 2, H, W), periodic in W via sin / cos."""
    angle = torch.as_tensor(np.asarray(angle_hw2, np.float32), device=device).permute(2, 0, 1)[None]
    periodic = torch.cat([torch.sin(angle), torch.cos(angle)], dim=1)
    periodic = torch.cat([periodic] * 3, dim=3)
    periodic = bilinear_resize(periodic, (size[0], size[1] * 3))[..., size[1]: 2 * size[1]]
    return torch.atan2(periodic[:, :2], periodic[:, 2:])


def image_to_points(image: torch.Tensor, angle: torch.Tensor, min_depth: float, max_depth: float,
                    tol: float = 1e-11) -> torch.Tensor:
    """A tanh-scaled inverse-depth image (B, 1, H, W) -> points (B, H*W, 3) in units of
    max_depth, dropped and out-of-range rays at the origin (test_gan's clouds before FPS)."""
    inv = torch.clamp((image + 1.0) / 2.0, 0, 1)
    valid = (inv > tol).to(inv.dtype)
    inv_depth = inv / min_depth
    valid = valid * ((inv_depth >= 1.0 / max_depth) & (inv_depth <= 1.0 / min_depth) & (inv_depth > 0.0)).to(inv.dtype)
    depth = 1.0 / (inv_depth + tol) * valid
    elev, azim = angle[:, 0:1], angle[:, 1:2]
    pm = torch.cat([depth * torch.cos(elev) * torch.cos(azim), depth * torch.cos(elev) * torch.sin(azim),
                    depth * torch.sin(elev)], dim=1)
    B = pm.shape[0]
    return pm.reshape(B, 3, -1).transpose(1, 2) / max_depth
