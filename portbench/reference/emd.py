"""Approximate earth mover's distance (approxmatch + match cost) and the COV / MMD /
1-NNA scores of three distance matrices, in plain torch and numpy.

The EMD is computed in float32 with no matrix product (the contraction over the three
coordinates is written out), so TF32 settings do not touch it; the evaluation cell's
control computes it in bfloat16 (`dtype`)."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

__all__ = ["earth_mover_distance", "emd_per_point", "cov_mmd", "nna", "scores"]

LEVELS = tuple(-(4.0 ** j) for j in range(7, -2, -1))


def _sq_norm(p: torch.Tensor) -> torch.Tensor:
    x, y, z = p.unbind(-1)
    return (x * x + y * y) + z * z


def pairwise_sqdist(x: torch.Tensor, y: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    x, y = x.to(dtype), y.to(dtype)
    x0, x1, x2 = (c[:, :, None] for c in x.unbind(-1))
    y0, y1, y2 = (c[:, None, :] for c in y.unbind(-1))
    xy = x0 * y0
    xy.add_(x1 * y1)
    xy.add_(x2 * y2)
    d = _sq_norm(x)[:, :, None] + _sq_norm(y)[:, None, :]
    d.sub_(xy, alpha=2.0)
    return d.clamp_(min=0.0)


def earth_mover_distance(xyz1: torch.Tensor, xyz2: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Per-pair approxmatch cost (B,), not divided by the cloud size; every operation in
    `dtype`."""
    B, n, _ = xyz1.shape
    m = xyz2.shape[1]
    multiL, multiR = (1.0, float(n // m)) if n >= m else (float(m // n), 1.0)
    D = pairwise_sqdist(xyz1, xyz2, dtype)
    sqrtD = torch.sqrt(D)
    remainL = D.new_full((B, n), multiL)
    remainR = D.new_full((B, m), multiR)
    cost = D.new_zeros((B,))
    for level in LEVELS:
        K = torch.exp(level * D)
        ratioL = remainL / (1e-9 + (K * remainR[:, None, :]).sum(2))
        sumr = (K * ratioL[:, :, None]).sum(1) * remainR
        ratioR = torch.clamp(remainR / (sumr + 1e-9), max=1.0) * remainR
        remainR = torch.clamp(remainR - sumr, min=0.0)
        w = K.mul_(ratioL[:, :, None]).mul_(ratioR[:, None, :])
        remainL = torch.clamp(remainL - w.sum(2), min=0.0)
        cost = cost + w.mul_(sqrtD).sum((1, 2))
    return cost


def emd_per_point(a: torch.Tensor, b: torch.Tensor, chunk: int = 32, dtype=torch.float32) -> torch.Tensor:
    """The evaluation's EMD of pairs (a[i], b[i]): the cost over the cloud size, in
    chunks of `chunk` pairs (each holds three (chunk, n, m) temporaries of `dtype`)."""
    out = [earth_mover_distance(a[i:i + chunk], b[i:i + chunk], dtype) for i in range(0, a.shape[0], chunk)]
    return torch.cat(out).float() / float(a.shape[1])


def cov_mmd(M_rg: np.ndarray) -> Dict[str, float]:
    N_ref, _ = M_rg.shape
    return {"mmd": float(M_rg.min(axis=1).mean()), "mmd-sample": float(M_rg.min(axis=0).mean()),
            "cov": float(len(np.unique(M_rg.argmin(axis=0)))) / float(N_ref)}


def nna(M_rr: np.ndarray, M_rg: np.ndarray, M_gg: np.ndarray) -> Dict[str, float]:
    """1-nearest-neighbour accuracy over the joint set (ties go to the lowest index)."""
    N_ref, N_gen = M_rg.shape
    label = np.concatenate([np.ones(N_ref), np.zeros(N_gen)])
    M = np.block([[M_rr, M_rg], [M_rg.T, M_gg]]).astype(np.float64)
    np.fill_diagonal(M, np.inf)
    pred = label[np.argmin(M, axis=0)]
    tp, fp = float((pred * label).sum()), float((pred * (1 - label)).sum())
    fn, tn = float(((1 - pred) * label).sum()), float(((1 - pred) * (1 - label)).sum())
    return {"tp": tp, "fp": fp, "fn": fn, "tn": tn, "precision": tp / (tp + fp + 1e-10),
            "recall": tp / (tp + fn + 1e-10), "accuracy_t": tp / (tp + fn + 1e-10),
            "accuracy_f": tn / (tn + fp + 1e-10), "accuracy": float((pred == label).mean())}


def scores(M_rr: np.ndarray, M_rg: np.ndarray, M_gg: np.ndarray, metric: str = "emd") -> Dict[str, float]:
    """COV, MMD and 1-NNA under the evaluation's key names."""
    out = {f"{k}-{metric}": v for k, v in cov_mmd(M_rg).items()}
    out.update({f"1-nn-{k}-{metric}": v for k, v in nna(M_rr, M_rg, M_gg).items()})
    return out
