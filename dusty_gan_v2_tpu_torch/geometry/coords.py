"""CoordBridge: conversions between range-image encodings and 3D point clouds over a
fixed laser-angle grid.

Counterpart of dusty_gan_v2_tpu/geometry/coords.py (bilinear_resize, resize_angle_lut,
CoordBridge) for the depth / inverse-depth family, point maps and sets, surface-normal
maps (from depth, inv_depth_norm and point maps) and the bird's-eye view.

Normalization convention: inv_depth_norm = min_depth / depth in (0, 1], zero == dropped.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..utils import resolve_device
from .normals import estimate_surface_normal
from .render import render_point_clouds

__all__ = ["CoordBridge", "COORD_TYPES", "bilinear_resize", "resize_angle_lut"]

COORD_TYPES = (
    "depth",
    "depth_norm",
    "inv_depth",
    "inv_depth_norm",
    "point_map",
    "point_set",
    "normal_map",
)


def bilinear_resize(x: torch.Tensor, size: Tuple[int, int]) -> torch.Tensor:
    """NCHW bilinear resize with F.interpolate(align_corners=False) semantics:
    half-pixel source coords clamped at 0, edge-clamped high index."""
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


def resize_angle_lut(angle_hw2: np.ndarray, size: Tuple[int, int], device="cuda") -> torch.Tensor:
    """(H0, W0, 2) angle LUT -> (1, 2, H, W), resampled periodically in W via sin/cos."""
    device = resolve_device(device)
    angle = torch.as_tensor(np.asarray(angle_hw2, np.float32), device=device).permute(2, 0, 1)[None]
    periodic = torch.cat([torch.sin(angle), torch.cos(angle)], dim=1)
    periodic = torch.cat([periodic] * 3, dim=3)  # tile W x3 for periodicity
    periodic = bilinear_resize(periodic, (size[0], size[1] * 3))
    periodic = periodic[..., size[1] : 2 * size[1]]
    return torch.atan2(periodic[:, :2], periodic[:, 2:])


class CoordBridge:
    """A plain geometry helper holding the angle grid and the depth range."""

    def __init__(
        self,
        num_ring: int,
        num_points: int,
        min_depth: float,
        max_depth: float,
        angle,
        device="cuda",
    ):
        """angle: the (H0, W0, 2) (elevation, azimuth) LUT, or a (1, 2, H, W) grid."""
        device = resolve_device(device)
        self.min_depth = float(min_depth)
        self.max_depth = float(max_depth)
        if self.max_depth <= self.min_depth:
            raise ValueError(f"max_depth {max_depth} <= min_depth {min_depth}")
        self.H, self.W = num_ring, num_points
        if angle.ndim == 3:  # raw LUT
            self.angle = resize_angle_lut(angle, (self.H, self.W), device)
        else:  # already (1, 2, H, W)
            self.angle = torch.as_tensor(angle, dtype=torch.float32, device=device)

    def get_mask(self, x, coord):
        if coord == "depth":
            return (x >= self.min_depth) & (x <= self.max_depth) & (x > 0.0)
        if coord == "inv_depth":
            return (x >= 1.0 / self.max_depth) & (x <= 1.0 / self.min_depth) & (x > 0.0)
        if coord in ("depth_norm", "inv_depth_norm"):
            return (x > 0.0) & (x <= 1.0)
        raise NotImplementedError(coord)

    def convert(self, x, src, tgt, tol=1e-11):
        """Convert between coordinate types with validity masking."""
        if src not in COORD_TYPES or tgt not in COORD_TYPES:
            raise ValueError(f"unknown coordinate type: {src} or {tgt}")
        if src == tgt:
            return x

        if src == "depth":
            if tgt in ("inv_depth", "inv_depth_norm"):
                valid = self.get_mask(x, src).to(x.dtype)
                inv_depth = 1.0 / (x + tol) * valid
                if tgt == "inv_depth_norm":
                    return self.convert(inv_depth, "inv_depth", tgt)
                return inv_depth
            if tgt == "depth_norm":
                return x / self.max_depth
            if tgt in ("point_map", "point_set", "normal_map"):
                pm = self.depth_to_point_map(x)
                return pm if tgt == "point_map" else self.convert(pm, "point_map", tgt)
        elif src == "depth_norm":
            depth = x * self.max_depth
            if tgt == "depth":
                return depth
            if tgt in ("inv_depth", "inv_depth_norm", "point_map", "point_set"):
                return self.convert(depth, "depth", tgt)
        elif src == "inv_depth":
            if tgt == "inv_depth_norm":
                return x * self.min_depth
            if tgt in ("depth", "depth_norm"):
                valid = self.get_mask(x, src).to(x.dtype)
                depth = 1.0 / (x + tol) * valid
                if tgt == "depth_norm":
                    return self.convert(depth, "depth", tgt)
                return depth
        elif src == "inv_depth_norm":
            if tgt == "inv_depth":
                return x / self.min_depth
            if tgt in ("depth", "depth_norm"):
                return self.convert(x / self.min_depth, "inv_depth", tgt)
            if tgt in ("point_map", "point_set", "normal_map"):
                valid = (x > tol).to(x.dtype)
                inv_depth = x / self.min_depth
                valid = valid * self.get_mask(inv_depth, "inv_depth").to(x.dtype)
                depth = 1.0 / (inv_depth + tol) * valid
                pm = self.convert(depth, "depth", "point_map")
                return pm if tgt == "point_map" else self.convert(pm, "point_map", tgt)
        elif src == "point_map":
            if tgt == "point_set":
                B, C = x.shape[:2]
                return x.reshape(B, C, -1).transpose(1, 2)
            if tgt in ("depth", "depth_norm", "inv_depth", "inv_depth_norm"):
                depth = torch.linalg.vector_norm(x, dim=1, keepdim=True)
                return depth if tgt == "depth" else self.convert(depth, "depth", tgt)
            if tgt == "normal_map":
                normals = -estimate_surface_normal(x / self.max_depth, d=2)
                return torch.nan_to_num(normals, nan=0.0)
        raise NotImplementedError(f"{src} to {tgt}")

    def depth_to_point_map(self, depth):
        """Spherical -> Cartesian over the angle grid."""
        if depth.ndim != 4:
            raise ValueError(f"depth must be (B, 1, H, W), got {tuple(depth.shape)}")
        elev, azim = self.angle[:, 0:1], self.angle[:, 1:2]
        x = depth * torch.cos(elev) * torch.cos(azim)
        y = depth * torch.cos(elev) * torch.sin(azim)
        z = depth * torch.sin(elev)
        return torch.cat([x, y, z], dim=1)

    def make_birds_eye_view(self, inv_depth_norm: torch.Tensor, Rt) -> torch.Tensor:
        """(B, 1, H, W) inv_depth_norm -> (B, 3, W, W) bird's-eye render from the
        extrinsics Rt = (R, t), coloured by surface normals."""
        from ..utils import points_to_normal_2d

        R, t = Rt
        W = inv_depth_norm.shape[-1]
        points = self.convert(inv_depth_norm, "inv_depth_norm", "point_map") / self.max_depth
        normal = points_to_normal_2d(points, mode="closest")
        B = points.shape[0]
        pts = points.reshape(B, 3, -1).transpose(1, 2)
        cols = normal.reshape(B, 3, -1).transpose(1, 2)
        return render_point_clouds(pts, cols, size=W, R=R, t=t)
