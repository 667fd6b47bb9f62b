"""CRF-as-RNN refinement layer (mean-field approximation).

Counterpart of dusty_gan_v2_tpu/semseg/crf_as_rnn.py, in its shift formulation: fixed
Gaussian smoothness kernels per class, a data-dependent appearance kernel from xyz
neighbour distances, trainable per-class kernel weights and a Potts label-compatibility
matrix, `num_iters` message-passing rounds. Every term is a statically shifted slice of
one zero-padded (B, C, H, W) copy times a per-(offset, class) scalar or a precomputed
plane; the appearance planes carry no gradient (the JAX package's stop_gradient).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

__all__ = ["CRFRNN"]


def _smoothness_taps(kernel_size, thetas) -> np.ndarray:
    """(K-1, C) float32 tap weights of the per-class diagonal Gaussian smoothness kernel,
    the centre tap excluded."""
    H, W = kernel_size
    assert H % 2 == 1 and W % 2 == 1
    hs = np.arange(H) - H // 2
    ws = np.arange(W) - W // 2
    pdist = (hs[:, None] ** 2 + ws[None, :] ** 2).astype(np.float32)
    taps = np.exp(-pdist[None] / (2 * np.asarray(thetas, np.float32)[:, None, None] ** 2))  # (C, kh, kw)
    taps = taps.reshape(len(thetas), -1).T  # (K, C)
    center = (H // 2) * W + (W // 2)
    return np.delete(taps, center, axis=0)


class CRFRNN(nn.Module):
    def __init__(self, num_classes: int, kernel_size: Tuple[int, int] = (3, 5), init_weight_smoothness: float = 0.02,
                 init_weight_appearance: float = 0.1, theta_gamma: Union[float, Sequence[float]] = 0.9,
                 theta_alpha: Union[float, Sequence[float]] = 0.9, theta_beta: Union[float, Sequence[float]] = 0.015,
                 num_iters: int = 3):
        super().__init__()
        C = self.num_classes = int(num_classes)
        self.kernel_size = tuple(int(k) for k in kernel_size)
        self.num_iters = int(num_iters)
        self.init_weight_smoothness = float(init_weight_smoothness)
        self.init_weight_appearance = float(init_weight_appearance)
        self.register_buffer("taps_gamma", torch.from_numpy(_smoothness_taps(self.kernel_size, self._per_class(theta_gamma))),
                             persistent=False)
        self.register_buffer("taps_alpha", torch.from_numpy(_smoothness_taps(self.kernel_size, self._per_class(theta_alpha))),
                             persistent=False)
        beta = np.asarray(self._per_class(theta_beta), np.float32)
        self.register_buffer("beta2", torch.from_numpy(2.0 * beta**2).reshape(1, C, 1, 1), persistent=False)
        self.weight_appearance = nn.Parameter(torch.empty(1, C, 1, 1))
        self.weight_smoothness = nn.Parameter(torch.empty(1, C, 1, 1))
        self.label_compatibility = nn.Parameter(torch.empty(C, C, 1, 1))
        self.reset_parameters(None)

    def _per_class(self, v):
        if isinstance(v, (int, float)):
            return [float(v)] * self.num_classes
        assert len(v) == self.num_classes
        return [float(x) for x in v]

    def reset_parameters(self, generator) -> None:
        with torch.no_grad():
            self.weight_appearance.fill_(self.init_weight_appearance)
            self.weight_smoothness.fill_(self.init_weight_smoothness)
            self.label_compatibility.copy_((1.0 - torch.eye(self.num_classes))[..., None, None])

    def forward(self, unary: torch.Tensor, xyz: torch.Tensor, mask: torch.Tensor, train: bool = False) -> torch.Tensor:
        B, _, H, W = unary.shape
        if mask.dim() == 3:
            mask = mask[:, None]
        ks = self.kernel_size
        ph, pw = ks[0] // 2, ks[1] // 2
        offsets = [(dy, dx) for dy in range(ks[0]) for dx in range(ks[1]) if not (dy == ph and dx == pw)]
        dt = unary.dtype
        taps_g, taps_a = self.taps_gamma.to(dt), self.taps_alpha.to(dt)

        def shifted(x_p, off):
            dy, dx = off
            return x_p[:, :, dy:dy + H, dx:dx + W]

        with torch.no_grad():
            xyz_p = F.pad(xyz, (pw, pw, ph, ph))
            beta2 = self.beta2.to(xyz.dtype)
            kernel_beta = [torch.exp(-(shifted(xyz_p, off) - xyz).square().sum(1, keepdim=True) / beta2)
                           for off in offsets]  # (B, C, H, W) each

        compat = self.label_compatibility[:, :, 0, 0]
        Q = unary
        for _ in range(self.num_iters):
            Q = torch.softmax(Q, dim=1)
            masked_Q = Q * mask
            Q_p = F.pad(Q, (pw, pw, ph, ph))
            mq_p = F.pad(masked_Q, (pw, pw, ph, ph))
            k_s = torch.zeros_like(Q)
            exp_smo = torch.zeros_like(Q)
            exp_app = torch.zeros_like(Q)
            for i, off in enumerate(offsets):
                q_sh = shifted(Q_p, off)
                k_s = k_s + q_sh * taps_g[i].reshape(1, -1, 1, 1)
                exp_smo = exp_smo + q_sh * taps_a[i].reshape(1, -1, 1, 1)
                exp_app = exp_app + shifted(mq_p, off) * kernel_beta[i]
            k_a = (exp_app * mask) * exp_smo
            weighted = self.weight_smoothness * k_s + self.weight_appearance * k_a
            pairwise = torch.einsum("ij,bjhw->bihw", compat, weighted)
            Q = unary - pairwise
        return Q
