"""Surface normals of range-image point maps, and Euler rotations.

Counterpart of dusty_gan_v2_tpu/geometry/normals.py: for each pixel, the 8 neighbours
at distance d, each paired with the one two steps further counter-clockwise; "closest"
takes the cross product of the pair with the least total distance (torch.argmin keeps
the first of equal sums, as jnp.argmin does), "mean" the mean of all 8 cross products.
W pads circularly (the azimuth is periodic), H by edge replication.
"""

from __future__ import annotations

import torch

from ..ops.pad import pad_axis

__all__ = ["estimate_surface_normal", "euler_rotation_matrix"]

# 8 adjacent offsets (dh, dw), counter-clockwise from "left"
_OFFSETS = [(-1, 0), (-1, 1), (0, 1), (1, 1), (1, 0), (1, -1), (0, -1), (-1, -1)]


def estimate_surface_normal(points: torch.Tensor, d: int = 2, mode: str = "closest") -> torch.Tensor:
    """points (B, 3, H, W) -> unit normals (B, 3, H, W)."""
    if points.ndim != 4 or points.shape[1] != 3:
        raise ValueError(f"points must be (B, 3, H, W), got {tuple(points.shape)}")
    H, W = points.shape[-2:]
    p = pad_axis(pad_axis(points, -2, d, d, "replicate"), -1, d, d, "circular")
    p = p.permute(0, 2, 3, 1)  # (B, H + 2d, W + 2d, 3)

    def shifted(dh, dw):
        return p[:, d + dh * d : d + dh * d + H, d + dw * d : d + dw * d + W]

    anchors = shifted(0, 0)[:, None]
    v1 = torch.stack([shifted(dh, dw) for dh, dw in _OFFSETS], dim=1) - anchors  # (B, 8, H, W, 3)
    v2 = torch.stack([shifted(*_OFFSETS[(k + 2) % 8]) for k in range(8)], dim=1) - anchors
    if mode == "closest":
        diff = torch.linalg.vector_norm(v1, dim=4) + torch.linalg.vector_norm(v2, dim=4)  # (B, 8, H, W)
        best = torch.argmin(diff, dim=1, keepdim=True)[..., None].expand(-1, -1, -1, -1, 3)
        normals = torch.linalg.cross(v1.gather(1, best)[:, 0], v2.gather(1, best)[:, 0], dim=-1)
    elif mode == "mean":
        normals = torch.linalg.cross(v1, v2, dim=-1).mean(dim=1)
    else:
        raise NotImplementedError(mode)
    normals = normals / (torch.linalg.vector_norm(normals, dim=3, keepdim=True) + 1e-8)
    return normals.permute(0, 3, 1, 2)


def euler_rotation_matrix(theta) -> torch.Tensor:
    """R = Rz(theta[2]) @ Ry(theta[1]) @ Rx(theta[0])."""
    theta = torch.as_tensor(theta)
    c, s = torch.cos(theta), torch.sin(theta)
    one, zero = torch.ones_like(theta[0]), torch.zeros_like(theta[0])
    Rx = torch.stack([one, zero, zero, zero, c[0], -s[0], zero, s[0], c[0]]).reshape(3, 3)
    Ry = torch.stack([c[1], zero, s[1], zero, one, zero, -s[1], zero, c[1]]).reshape(3, 3)
    Rz = torch.stack([c[2], -s[2], zero, s[2], c[2], zero, zero, zero, one]).reshape(3, 3)
    return Rz @ Ry @ Rx
