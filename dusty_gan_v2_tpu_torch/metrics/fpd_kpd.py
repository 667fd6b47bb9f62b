"""Frechet (FPD) and kernel (KPD) distances over PointNet features (the port's own copy
of dusty_gan_v2_tpu/metrics/fpd_kpd.py: numpy/scipy math on the host, over feature
matrices downloaded once). The subset draws of the KPD come from an explicit
np.random.RandomState, not from numpy's global one, and the FPD regularises singular
covariances where SciPy's matrix root comes back non-finite.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import scipy.linalg

__all__ = ["compute_frechet_distance", "compute_squared_mmd"]

_SINGULAR_EPS = 1e-6


def compute_frechet_distance(feats1: np.ndarray, feats2: np.ndarray) -> float:
    mu1, sigma1 = np.mean(feats1, axis=0), np.cov(feats1, rowvar=False)
    mu2, sigma2 = np.mean(feats2, axis=0), np.cov(feats2, rowvar=False)
    assert mu1.shape == mu2.shape and sigma1.shape == sigma2.shape
    m = np.square(mu1 - mu2).sum()
    # no `disp` argument: SciPy removed it, and without it old and new versions alike
    # return the root alone (an old one also warns about a singular product)
    s = scipy.linalg.sqrtm(np.dot(sigma1, sigma2))
    if not np.isfinite(s).all():
        # fewer samples than feature dimensions make the product singular, and some
        # SciPy versions then return NaN; regularise as FID implementations do
        offset = np.eye(sigma1.shape[0]) * _SINGULAR_EPS
        s = scipy.linalg.sqrtm(np.dot(sigma1 + offset, sigma2 + offset))
    return float(np.real(m + np.trace(sigma1 + sigma2 - s * 2)))


def compute_squared_mmd(
    feats1: np.ndarray, feats2: np.ndarray, num_subsets=100, max_subset_size=1000,
    rng: Optional[np.random.RandomState] = None,
) -> float:
    """Cubic-polynomial-kernel squared MMD (KID-style subset estimator); `rng` draws
    the subsets (RandomState(0) when none is given)."""
    rng = np.random.RandomState(0) if rng is None else rng
    n = feats1.shape[1]
    m = min(min(feats1.shape[0], feats2.shape[0]), max_subset_size)
    t = 0.0
    for _ in range(num_subsets):
        x = feats2[rng.choice(feats2.shape[0], m, replace=False)]
        y = feats1[rng.choice(feats1.shape[0], m, replace=False)]
        a = (x @ x.T / n + 1) ** 3 + (y @ y.T / n + 1) ** 3
        b = (x @ y.T / n + 1) ** 3
        t += (a.sum() - np.diag(a).sum()) / (m - 1) - b.sum() * 2 / m
    return float(t / num_subsets / m)
