"""COV / MMD / 1-NNA two-sample metrics over CD / EMD / DCD distance matrices
(counterpart of dusty_gan_v2_tpu/metrics/cov_mmd_1nna.py, on one device).

The design that matters on any accelerator is kept: both sets are uploaded once, each
chunk's flat pair indices are made on the device from the chunk start, each chunk's
values are written into one preallocated device buffer, and a matrix leaves the device
in a single download. Nothing synchronises per chunk.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..utils import resolve_device
from .distance import chamfer_distance, density_aware_chamfer_distance
from .emd import emd_cost

__all__ = ["compute_cov_mmd_1nna", "compute_cd", "compute_emd", "compute_dcd"]


def compute_cd(pcs_1, pcs_2):
    d1, d2, _, _ = chamfer_distance(pcs_1, pcs_2)
    return d1.mean(1) + d2.mean(1)


def compute_emd(pcs_1, pcs_2):
    N = pcs_1.shape[1]
    if N != pcs_2.shape[1]:
        raise ValueError(f"compute_emd needs equal cloud sizes, got {N} and {pcs_2.shape[1]}")
    return emd_cost(pcs_1, pcs_2) / float(N)


def compute_dcd(pcs_1, pcs_2):
    d, _, _ = density_aware_chamfer_distance(pcs_1, pcs_2)
    return d


_FNS = {"cd": compute_cd, "emd": compute_emd, "dcd": compute_dcd}


def _to_device(pcs, device) -> torch.Tensor:
    return torch.as_tensor(pcs, dtype=torch.float32).to(device)


@torch.no_grad()
def _pairwise_distance(pcs_1, pcs_2, batch_size, metrics=("cd",), device="cuda"):
    """(B1, N, 3) x (B2, M, 3) -> {metric: (B1, B2) numpy distance matrix}.

    The flat list of B1 * B2 pairs is walked in chunks of `batch_size` (the last may be
    shorter)."""
    device = resolve_device(device)
    p1, p2 = _to_device(pcs_1, device), _to_device(pcs_2, device)
    B1, B2 = p1.shape[0], p2.shape[0]
    total = B1 * B2
    accs = {m: torch.empty(total, dtype=torch.float32, device=device) for m in metrics}
    for start in range(0, total, batch_size):
        stop = min(start + batch_size, total)
        idx = torch.arange(start, stop, device=device)
        a, b = p1[idx // B2], p2[idx % B2]
        for m in metrics:
            accs[m][start:stop] = _FNS[m](a, b)
    return {m: accs[m].cpu().numpy().reshape(B1, B2) for m in metrics}


def _compute_cov_mmd(M_rg: np.ndarray) -> Dict[str, float]:
    N_ref, N_gen = M_rg.shape
    mmd_gen = M_rg.min(axis=0)
    min_idx_gen = M_rg.argmin(axis=0)
    mmd_ref = M_rg.min(axis=1)
    return {
        "mmd": float(mmd_ref.mean()),
        "mmd-sample": float(mmd_gen.mean()),
        "cov": float(len(np.unique(min_idx_gen))) / float(N_ref),
    }


def _compute_nna(M_rr, M_rg, M_gg, k=1, sqrt=False) -> Dict[str, float]:
    N_ref, N_gen = M_rg.shape
    label = np.concatenate([np.ones(N_ref), np.zeros(N_gen)])
    M = np.concatenate(
        [
            np.concatenate([M_rr, M_rg], axis=1),
            np.concatenate([M_rg.T, M_gg], axis=1),
        ],
        axis=0,
    )
    if sqrt:
        M = np.sqrt(np.abs(M))
    np.fill_diagonal(M, np.inf)
    idx = np.argpartition(M, k, axis=0)[:k]  # the k smallest of each column
    count = label[idx].sum(axis=0)
    pred = (count / k >= 0.5).astype(np.float64)

    tp = float((pred * label).sum())
    fp = float((pred * (1 - label)).sum())
    fn = float(((1 - pred) * label).sum())
    tn = float(((1 - pred) * (1 - label)).sum())
    return {
        "tp": tp,
        "fp": fp,
        "fn": fn,
        "tn": tn,
        "precision": tp / (tp + fp + 1e-10),
        "recall": tp / (tp + fn + 1e-10),
        "accuracy_t": tp / (tp + fn + 1e-10),
        "accuracy_f": tn / (tn + fp + 1e-10),
        "accuracy": float((pred == label).mean()),
    }


def compute_cov_mmd_1nna(
    pcs_gen, pcs_ref, batch_size, metrics=("cd", "emd", "dcd"), device="cuda"
) -> Dict[str, float]:
    """COV, MMD and 1-NNA of a generated set against a reference set, per distance."""
    if not isinstance(metrics, tuple):
        raise TypeError("metrics must be a tuple")
    device = resolve_device(device)
    # both sets go to the device once for all three matrices
    pcs_ref, pcs_gen = _to_device(pcs_ref, device), _to_device(pcs_gen, device)
    results: Dict[str, float] = {}
    M_rr = _pairwise_distance(pcs_ref, pcs_ref, batch_size, metrics, device)
    M_rg = _pairwise_distance(pcs_ref, pcs_gen, batch_size, metrics, device)
    M_gg = _pairwise_distance(pcs_gen, pcs_gen, batch_size, metrics, device)

    for m in metrics:
        for k, v in _compute_cov_mmd(M_rg[m]).items():
            results[f"{k}-{m}"] = v
        for k, v in _compute_nna(M_rr[m], M_rg[m], M_gg[m], k=1).items():
            results[f"1-nn-{k}-{m}"] = v
    return results
