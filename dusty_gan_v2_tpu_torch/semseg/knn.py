"""kNN label refinement on depth images (the RangeNet++-style post-filter).

Counterpart of dusty_gan_v2_tpu/semseg/knn.py: depth jumps to each neighbour of a
window, penalised by an inverse-Gaussian kernel, the k nearest neighbours' labels voted
with a distance cutoff. Each jump plane is a shifted slice of one zero-padded depth
copy, and the penalty K scalar shift-scale-accumulates in the JAX package's order.

Ties: jax.lax.top_k keeps the lower index among equal values, and whole windows tie at
+inf where neighbours are masked. torch.topk promises no order among ties, so the k
nearest are the first k of a stable ascending sort; the vote's argmax takes the first
maximum in both frameworks. So the labels equal the JAX package's, and the card's the
CPU's.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["knn2d"]


def _inv_gaussian_kernel(kernel_size, sigma) -> np.ndarray:
    H, W = kernel_size
    hs = np.arange(H) - H // 2
    ws = np.arange(W) - W // 2
    pdist = (hs[:, None] ** 2 + ws[None, :] ** 2).astype(np.float32)
    k = np.exp(-pdist / (2 * sigma**2))
    k /= k.sum()
    return 1.0 - k  # (kh, kw)


def knn2d(depth: torch.Tensor, label: torch.Tensor, num_classes: int, k: int = 3,
          kernel_size: Tuple[int, int] = (3, 3), sigma: float = 1.0, cutoff: float = 1.0) -> torch.Tensor:
    """depth (B,1,H,W), label (B,H,W) int -> refined label (B,H,W) int64."""
    B, _, H, W = depth.shape
    ks = tuple(kernel_size)
    ph, pw = ks[0] // 2, ks[1] // 2
    K, HW = ks[0] * ks[1], H * W
    taps = _inv_gaussian_kernel(ks, sigma)
    offsets = [(dy, dx) for dy in range(ks[0]) for dx in range(ks[1])]

    def shifted(x_p, off):
        dy, dx = off
        return x_p[:, :, dy:dy + H, dx:dx + W]

    # |neighbour - centre|, a negative neighbour counting as +inf (zero padding stays finite)
    depth_p = F.pad(depth, (pw, pw, ph, ph))
    inf = torch.full((), float("inf"), dtype=depth.dtype, device=depth.device)
    jumps = []
    for off in offsets:
        nb = shifted(depth_p, off)
        jumps.append((torch.where(nb < 0, inf, nb) - depth).abs())

    # each jump plane correlated with the inverse-Gaussian kernel, tap by tap
    dists = []
    for jump in jumps:
        jp = F.pad(jump, (pw, pw, ph, ph))
        acc = torch.zeros_like(jump)
        for off in offsets:
            acc = acc + float(taps[off]) * shifted(jp, off)
        dists.append(acc)
    dist = torch.stack(dists, dim=2).reshape(B, 1, K, HW).transpose(2, 3)  # (B,1,HW,K)

    dist_sorted, idx = torch.sort(dist, dim=-1, stable=True)
    dist_top, idx_top = dist_sorted[..., :k], idx[..., :k]

    label_p = F.pad(label[:, None], (pw, pw, ph, ph))
    lab_nb = torch.stack([shifted(label_p, off) for off in offsets], dim=2).reshape(B, 1, K, HW).transpose(2, 3)
    lab_top = torch.gather(lab_nb, -1, idx_top).long()
    if cutoff > 0:
        lab_top = torch.where(dist_top > cutoff, torch.full_like(lab_top, num_classes), lab_top)

    # majority vote over the classes (the overflow bin excluded)
    classes = torch.arange(num_classes, device=label.device)
    votes = (lab_top[..., None] == classes).sum(3)  # (B,1,HW,C)
    return votes.argmax(-1).reshape(B, H, W)
