"""Jensen-Shannon divergence between occupancy-grid marginals of point-cloud sets
(counterpart of dusty_gan_v2_tpu/metrics/jsd.py).

28^3 unit-cube grid clipped to the unit sphere, nearest-cell voting as a chunked argmin
over the (points, cells) squared-distance matrix on the device, JSD between the two
count distributions on the host.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from ..utils import resolve_device
from .distance import pairwise_sqdist

__all__ = ["compute_jsd", "entropy_of_occupancy_grid", "unit_cube_grid_point_cloud", "jensen_shannon_divergence"]


def unit_cube_grid_point_cloud(resolution: int, clip_sphere: bool):
    spacing = 1.0 / (resolution - 1)
    steps = np.arange(resolution, dtype=np.float32)
    grid = np.stack(np.meshgrid(steps, steps, steps, indexing="ij"), axis=-1)
    grid = grid * spacing - 0.5
    grid = grid.reshape(-1, 3)
    if clip_sphere:
        grid = grid[np.linalg.norm(grid, axis=1) <= 0.5]
    return grid, spacing


@torch.no_grad()
def entropy_of_occupancy_grid(pcs, resolution=28, in_sphere=True, batch_size=16, device="cuda"):
    """pcs: (B, Np, 3) in the unit sphere -> (entropy, per-cell vote counts).

    `batch_size` clouds go through one argmin; its (batch * Np, cells) distance matrix
    is 1.5 GB at 16 clouds of 2048 points against the 11.5k cells of the 28^3 sphere."""
    device = resolve_device(device)
    pcs = torch.as_tensor(pcs, dtype=torch.float32).to(device)
    eps = 1e-3
    if float(pcs.abs().max()) > 0.5 + eps:
        warnings.warn("Point-clouds are not in unit cube.")
    if in_sphere and float(torch.linalg.vector_norm(pcs, dim=2).max()) > 0.5 + eps:
        warnings.warn("Point-clouds are not in unit sphere.")

    grid, _ = unit_cube_grid_point_cloud(resolution, in_sphere)
    Ng = len(grid)
    grid_t = torch.from_numpy(grid).to(device)[None]
    B, Np, _ = pcs.shape
    inds = torch.cat([
        pairwise_sqdist(pcs[i : i + batch_size].reshape(1, -1, 3), grid_t).argmin(dim=2).reshape(-1, Np)
        for i in range(0, B, batch_size)
    ])  # (B, Np)

    counters = torch.bincount(inds.reshape(-1), minlength=Ng)
    # in how many clouds each cell is occupied
    occupied = torch.zeros(B, Ng, dtype=torch.bool, device=device).scatter_(
        1, inds, torch.ones_like(inds, dtype=torch.bool)
    ).sum(0)
    counters = counters.cpu().numpy().astype(np.float64)
    occupied = occupied.cpu().numpy().astype(np.float64)

    p = occupied[occupied > 0] / float(B)
    acc_entropy = float(_entropy_nat(np.concatenate([p, 1 - p])) / Ng)
    return acc_entropy, counters


def _entropy_nat(p, eps=1e-8):
    p = p + eps
    return float(np.sum(-p * np.log(p)))


def _entropy2(p, eps=1e-8):
    p = p + eps
    return float(np.sum(-p * np.log2(p)))


def jensen_shannon_divergence(P, Q):
    assert (P >= 0).all() and (Q >= 0).all()
    P_ = P / P.sum()
    Q_ = Q / Q.sum()
    return _entropy2((P_ + Q_) / 2.0) - (_entropy2(P_) + _entropy2(Q_)) / 2.0


def compute_jsd(pcs_gen, pcs_ref, resolution=28, batch_size=16, device="cuda") -> float:
    _, gen_counts = entropy_of_occupancy_grid(pcs_gen, resolution, True, batch_size, device)
    _, ref_counts = entropy_of_occupancy_grid(pcs_ref, resolution, True, batch_size, device)
    return float(jensen_shannon_divergence(gen_counts, ref_counts))
