"""Point cloud -> image rendering (bird's-eye views for logging): a pinhole projection and
a bilinear scatter-add rasterizer.

Counterpart of dusty_gan_v2_tpu/geometry/render.py (make_Rt, bilinear_rasterizer,
render_point_clouds). The JAX `.at[].add` scatter is `index_add_` here; on the card its
atomic adds sum in no fixed order, so a render agrees with the CPU's to rounding, not
to the bit.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = ["make_Rt", "bilinear_rasterizer", "render_point_clouds"]


def _axis_angle_rotation(axis: int, angle: float) -> np.ndarray:
    c, s = math.cos(angle), math.sin(angle)
    if axis == 0:  # roll, x
        return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], np.float32)
    if axis == 1:  # pitch, y
        return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)  # yaw, z


def make_Rt(roll=0.0, pitch=0.0, yaw=0.0, x=0.0, y=0.0, z=0.0, device="cpu") -> Tuple[torch.Tensor, torch.Tensor]:
    """Extrinsics (R (1, 3, 3), t (1, 3)): yaw after pitch after roll."""
    R = _axis_angle_rotation(2, yaw) @ _axis_angle_rotation(1, pitch) @ _axis_angle_rotation(0, roll)
    t = np.array([[x, y, z]], np.float32)
    return torch.as_tensor(R[None], device=device), torch.as_tensor(t, device=device)


def bilinear_rasterizer(coords: torch.Tensor, values: torch.Tensor, out_shape: Tuple[int, int]) -> torch.Tensor:
    """Scatter-add values (B, N, C) at fractional (h, w) coords (B, N, 2) -> (B, C, H, W):
    4-corner bilinear weights, a corner outside the image contributes nothing, weights
    below 1e-3 are dropped."""
    B, N, C = values.shape
    H, W = out_shape
    h, w = coords[..., 0], coords[..., 1]
    h_t = torch.floor(h)
    h_b = h_t + 1
    w_l = torch.floor(w)
    w_r = w_l + 1
    h_t_safe, h_b_safe = h_t.clamp(0.0, H - 1), h_b.clamp(0.0, H - 1)
    w_l_safe, w_r_safe = w_l.clamp(0.0, W - 1), w_r.clamp(0.0, W - 1)
    wt_h_t = (h_b - h) * (h_t == h_t_safe)
    wt_h_b = (h - h_t) * (h_b == h_b_safe)
    wt_w_l = (w_r - w) * (w_l == w_l_safe)
    wt_w_r = (w - w_l) * (w_r == w_r_safe)

    out = values.new_zeros(B * H * W, C)
    base = (torch.arange(B, device=values.device) * (H * W))[:, None]
    for wt, hh, ww in (
        (wt_h_t * wt_w_l, h_t_safe, w_l_safe),
        (wt_h_t * wt_w_r, h_t_safe, w_r_safe),
        (wt_h_b * wt_w_l, h_b_safe, w_l_safe),
        (wt_h_b * wt_w_r, h_b_safe, w_r_safe),
    ):
        wt = wt * (wt >= 1e-3)
        idx = (ww + W * hh).long() + base  # (B, N)
        out.index_add_(0, idx.reshape(-1), (values * wt[..., None]).reshape(-1, C))
    return out.reshape(B, H, W, C).permute(0, 3, 1, 2)


def render_point_clouds(
    points: torch.Tensor,
    colors: torch.Tensor,
    size: int = 512,
    R: Optional[torch.Tensor] = None,
    t: Optional[torch.Tensor] = None,
    focal_length: float = 1.0,
) -> torch.Tensor:
    """points, colors (B, N, 3) -> (B, 3, size, size): z flipped, then R and t applied,
    pinhole projection, every point's colour weighted by exp(-3 depth) and the image
    normalized by the splatted weights."""
    points = points * torch.tensor([1.0, 1.0, -1.0], dtype=points.dtype, device=points.device)
    if R is not None:
        points = points @ R
    if t is not None:
        points = points + t
    z = points[..., 2:3]
    uv = focal_length * points[..., :2] / (z + 1e-12) + 0.5
    uv = uv * size
    inside = (uv > 0) & (uv < size - 1)
    colors = colors * (inside[..., 0:1] & inside[..., 1:2]).to(colors.dtype)
    uv = size - uv
    depth = torch.linalg.vector_norm(points, dim=-1, keepdim=True)
    weight = torch.exp(-3.0 * depth) * (depth > 1e-8)
    bev = bilinear_rasterizer(uv, weight * colors, (size, size))
    return bev / (bilinear_rasterizer(uv, weight, (size, size)) + 1e-8)
