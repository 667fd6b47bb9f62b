"""Point-cloud distances: Chamfer, approximate earth mover's distance, density-aware CD
(counterpart of dusty_gan_v2_tpu/metrics/distance.py).

`earth_mover_distance` is the plain PyTorch version of the fused EMD kernel
(csrc/emd.cu, launched by metrics/emd.py::emd_cuda) and its oracle; on a card the
evaluation path takes the kernel, not this function.

Everything here is full float32 whatever torch.backends.cuda.matmul.allow_tf32 says:
the contraction over the three coordinates is written as three broadcast products, and
the supply/demand sums of approxmatch as multiply + sum, so no matmul is involved.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = [
    "pairwise_sqdist",
    "chamfer_distance",
    "approx_match",
    "match_cost",
    "earth_mover_distance",
    "density_aware_chamfer_distance",
    "fscore",
]

# annealing levels of approxmatch: -4^j, j = 7..-1
LEVELS = tuple(-(4.0**j) for j in range(7, -2, -1))


def _sq_norm(p: torch.Tensor) -> torch.Tensor:
    x, y, z = p.unbind(-1)
    return (x * x + y * y) + z * z


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) x (B, M, 3) -> (B, N, M) squared euclidean distances, clamped at 0.

    The |x|^2 + |y|^2 - 2xy form, with every operation in a fixed order and rounded on
    its own: xy = (x0 y0 + x1 y1) + x2 y2, d = (|x|^2 + |y|^2) - 2 xy. approxmatch
    multiplies d by -16384, so csrc/emd.cu repeats exactly this order to get the same
    bits."""
    x, y = x.float(), y.float()
    x0, x1, x2 = (c[:, :, None] for c in x.unbind(-1))
    y0, y1, y2 = (c[:, None, :] for c in y.unbind(-1))
    xy = x0 * y0
    xy.add_(x1 * y1)
    xy.add_(x2 * y2)
    d = _sq_norm(x)[:, :, None] + _sq_norm(y)[:, None, :]
    d.sub_(xy, alpha=2.0)  # 2 * xy is exact, so one rounding, fused or not
    return d.clamp_(min=0.0)


def chamfer_distance(
    x: torch.Tensor, y: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bidirectional nearest-neighbour squared distances and indices:
    (dist1, dist2, idx1, idx2), dist1[b, i] = min_j |x_i - y_j|^2."""
    D = pairwise_sqdist(x, y)
    dist1, idx1 = D.min(dim=2)
    dist2, idx2 = D.min(dim=1)
    return dist1, dist2, idx1.to(torch.int32), idx2.to(torch.int32)


def _multipliers(n: int, m: int) -> Tuple[float, float]:
    # integer division, as in the approxmatch CUDA kernel the metric comes from
    return (1.0, float(n // m)) if n >= m else (float(m // n), 1.0)


def _level_step(K, remainL, remainR):
    """One annealing level: (ratioL, ratioR, new remainR). K is (B, n, m)."""
    ratioL = remainL / (1e-9 + (K * remainR[:, None, :]).sum(2))
    sumr = (K * ratioL[:, :, None]).sum(1) * remainR
    consumption = torch.clamp(remainR / (sumr + 1e-9), max=1.0)
    ratioR = consumption * remainR
    return ratioL, ratioR, torch.clamp(remainR - sumr, min=0.0)


def approx_match(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """Approximate bipartite matching (B, N, 3) x (B, M, 3) -> match (B, M, N):
    annealed soft assignment over the levels -4^7 .. -4^-1 with supply/demand
    bookkeeping."""
    B, n, _ = xyz1.shape
    m = xyz2.shape[1]
    multiL, multiR = _multipliers(n, m)
    D = pairwise_sqdist(xyz1, xyz2)
    match = torch.zeros_like(D)
    remainL = D.new_full((B, n), multiL)
    remainR = D.new_full((B, m), multiR)
    for level in LEVELS:
        K = torch.exp(level * D)
        ratioL, ratioR, remainR = _level_step(K, remainL, remainR)
        w = K * ratioL[:, :, None] * ratioR[:, None, :]
        match = match + w
        remainL = torch.clamp(remainL - w.sum(2), min=0.0)
    return match.transpose(1, 2)


def match_cost(xyz1: torch.Tensor, xyz2: torch.Tensor, match: torch.Tensor) -> torch.Tensor:
    """sum over (l, k) of match[l, k] * |xyz1_k - xyz2_l|."""
    D = torch.sqrt(pairwise_sqdist(xyz1, xyz2))
    return (match.transpose(1, 2) * D).sum((1, 2))


def earth_mover_distance(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """Per-pair approximate EMD cost (B,), not divided by N (callers divide).

    The cost sum(match * |x - y|) accumulates inside the annealing loop, so the match
    tensor is never kept; equal to match_cost(approx_match(...)). No gradient is
    taken through it on the metric path."""
    B, n, _ = xyz1.shape
    m = xyz2.shape[1]
    multiL, multiR = _multipliers(n, m)
    D = pairwise_sqdist(xyz1, xyz2)
    sqrtD = torch.sqrt(D)
    remainL = D.new_full((B, n), multiL)
    remainR = D.new_full((B, m), multiR)
    cost = D.new_zeros((B,))
    for level in LEVELS:
        K = torch.exp(level * D)
        ratioL, ratioR, remainR = _level_step(K, remainL, remainR)
        w = K.mul_(ratioL[:, :, None]).mul_(ratioR[:, None, :])
        remainL = torch.clamp(remainL - w.sum(2), min=0.0)
        cost = cost + w.mul_(sqrtD).sum((1, 2))
    return cost


def fscore(dist1, dist2, threshold=1e-4):
    p1 = (dist1 < threshold).float().mean(1)
    p2 = (dist2 < threshold).float().mean(1)
    f = 2 * p1 * p2 / (p1 + p2)
    return torch.nan_to_num(f, nan=0.0), p1, p2


def _neighbour_counts(idx: torch.Tensor, size: int) -> torch.Tensor:
    """(B, k) indices -> (B, size): how often each index occurs in its row."""
    idx = idx.long()
    return torch.zeros(idx.shape[0], size, dtype=torch.long, device=idx.device).scatter_add_(
        1, idx, torch.ones_like(idx)
    )


def density_aware_chamfer_distance(
    x: torch.Tensor, gt: torch.Tensor, alpha: float = 1000.0, n_lambda: float = 1.0,
    non_reg: bool = False,
):
    """DCD. Returns (loss, cd_p, cd_t)."""
    n_x, n_gt = x.shape[1], gt.shape[1]
    if non_reg:
        frac_12 = max(1.0, n_x / n_gt)
        frac_21 = max(1.0, n_gt / n_x)
    else:
        frac_12 = n_x / n_gt
        frac_21 = n_gt / n_x

    # dist1 runs over gt, dist2 over x
    dist1, dist2, idx1, idx2 = chamfer_distance(gt, x)
    cd_p = (torch.sqrt(dist1).mean(1) + torch.sqrt(dist2).mean(1)) / 2
    cd_t = dist1.mean(1) + dist2.mean(1)

    def loss(dist, idx, size, frac):
        # weight: how often the point's nearest neighbour is someone's nearest neighbour
        count = _neighbour_counts(idx, size)
        weight = torch.gather(count, 1, idx.long()).float() ** n_lambda
        weight = 1.0 / (weight + 1e-6) * frac
        return (1 - torch.exp(-dist * alpha) * weight.detach()).mean(1)

    return (loss(dist1, idx1, n_x, frac_21) + loss(dist2, idx2, n_gt, frac_12)) / 2, cd_p, cd_t
