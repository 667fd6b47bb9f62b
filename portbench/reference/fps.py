"""Furthest-point sampling in plain torch operations."""

from __future__ import annotations

import torch

__all__ = ["furthest_point_sampling", "downsample"]


def furthest_point_sampling(xyz: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, 3) -> (B, k) indices: start at 0, then the point farthest from those picked
    ((dx^2 + dy^2) + dz^2; the first maximum on ties)."""
    B, N, _ = xyz.shape
    x, y, z = xyz.float().unbind(-1)
    rows = torch.arange(B, device=xyz.device)
    min_d = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    last = torch.zeros(B, dtype=torch.long, device=xyz.device)
    picks = [last]
    for _ in range(k - 1):
        px, py, pz = x[rows, last][:, None], y[rows, last][:, None], z[rows, last][:, None]
        d = (x - px).square() + (y - py).square() + (z - pz).square()
        min_d = torch.minimum(min_d, d)
        last = torch.argmax(min_d, dim=-1)
        picks.append(last)
    return torch.stack(picks, dim=1)


def downsample(xyz: torch.Tensor, k: int) -> torch.Tensor:
    """(B, N, 3) -> the (B, k, 3) furthest-point subset."""
    idx = furthest_point_sampling(xyz, k)
    return torch.gather(xyz, 1, idx[..., None].expand(-1, -1, 3))
