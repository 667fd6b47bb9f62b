"""DiffAugment (Zhao et al. 2020): differentiable flip, brightness, contrast, translation
with horizontal circulation, and cutout, each applied per sample with probability p,
under the adaptive-p controller of ADA.

Counterpart of dusty_gan_v2_tpu/augment/diff_augment.py. Each op takes its draws from a
stream (parallel/persample.py: a PerSampleStream, or a ReplayStream that hands in the JAX
package's draws), in policy order and within an op in the JAX op's order, so that the two
packages agree on injected draws; Bernoulli choices are uniforms below their p, as
jax.random.bernoulli draws them. The reference's index arithmetic is kept: translation
wraps the width modulo W - 1, and cutout's centre runs to H + (1 - ch % 2). As in JAX, the
trainer does not call it.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from .ada import AdaptiveAugment, AdaState

__all__ = ["DiffAugment", "random_flip", "rand_brightness", "rand_contrast", "rand_translation", "rand_cutout"]


def _select(stream, p, aug: torch.Tensor, orig: torch.Tensor) -> torch.Tensor:
    """aug for the samples whose uniform draw is below p, orig for the others."""
    keep = stream.bernoulli(p, (1,) * (orig.ndim - 1)).to(orig.device)
    return torch.where(keep, aug, orig)


def random_flip(x: torch.Tensor, stream, p) -> torch.Tensor:
    return _select(stream, p * 0.5, torch.flip(x, dims=(3,)), x)


def rand_brightness(x: torch.Tensor, stream, p, band: float = 0.2) -> torch.Tensor:
    factor = stream.normal((1, 1, 1)).to(x.device, x.dtype) * band
    return _select(stream, p, x + factor, x)


def rand_contrast(x: torch.Tensor, stream, p, band: float = 0.5) -> torch.Tensor:
    factor = torch.exp2(stream.normal((1, 1, 1)).to(x.device, x.dtype) * band)
    return _select(stream, p, x * factor, x)


def rand_translation(x: torch.Tensor, stream, p, ratio: Tuple[float, float] = (1 / 8, 1 / 8)) -> torch.Tensor:
    """Shift each sample by up to ratio / 2 of its height (zero rows enter) and width
    (columns wrap around modulo W - 1, the reference's bound)."""
    B, C, H, W = x.shape
    sh, sw = int(H * ratio[0] / 2 + 0.5), int(W * ratio[1] / 2 + 0.5)
    th = stream.randint((1, 1), -sh, sh + 1).to(x.device, torch.int64)
    tw = stream.randint((1, 1), -sw, sw + 1).to(x.device, torch.int64)
    gh = torch.arange(H, device=x.device)[None, :, None]
    gw = torch.arange(W, device=x.device)[None, None, :]
    x_pad = F.pad(x, (0, 0, 1, 1))
    idx_h = torch.clamp(gh + th + 1, 0, H + 1)  # (B, H, 1)
    idx_w = torch.remainder(gw + tw, W - 1)  # (B, 1, W)
    bidx = torch.arange(B, device=x.device)[:, None, None]
    y = x_pad[bidx, :, idx_h, idx_w].permute(0, 3, 1, 2)  # (B, H, W, C) -> (B, C, H, W)
    return _select(stream, p, y, x)


def rand_cutout(x: torch.Tensor, stream, p, ratio: float = 0.5) -> torch.Tensor:
    """Zero a (ratio H) x (ratio W) rectangle around a uniform centre per sample."""
    B, C, H, W = x.shape
    ch, cw = int(H * ratio + 0.5), int(W * ratio + 0.5)
    oh = stream.randint((1, 1), 0, H + (1 - ch % 2)).to(x.device, torch.int64)
    ow = stream.randint((1, 1), 0, W + (1 - cw % 2)).to(x.device, torch.int64)
    gh = torch.arange(H, device=x.device)[None, :, None]
    gw = torch.arange(W, device=x.device)[None, None, :]
    in_h = (gh >= torch.clamp(oh - ch // 2, 0, H)) & (gh < torch.clamp(oh - ch // 2 + ch, 0, H))
    in_w = (gw >= torch.clamp(ow - cw // 2, 0, W)) & (gw < torch.clamp(ow - cw // 2 + cw, 0, W))
    mask = 1.0 - (in_h & in_w).to(x.dtype)
    return _select(stream, p, x * mask[:, None], x)


_FNS = {
    "flip": random_flip,
    "brightness": rand_brightness,
    "contrast": rand_contrast,
    "translation": rand_translation,
    "cutout": rand_cutout,
}


class DiffAugment:
    """AdaptiveAugment's interface: __call__(x, p, stream), cumulate, update_p.

        aug = DiffAugment(p_target=0.6, kimg=500)
        x_aug = aug(x, state.p, stream)
        state = aug.cumulate(state, d_real_logits)
        state, rt = aug.update_p(state)
    """

    def __init__(self, policy: Optional[Sequence[str]] = None, p_init: float = 0.0,
                 p_target: Optional[float] = 0.6, kimg: float = 500):
        self.policy = list(policy) if policy is not None else ["flip", "brightness", "contrast", "translation", "cutout"]
        unknown = set(self.policy) - set(_FNS)
        if unknown:
            raise ValueError(f"unknown DiffAugment ops {sorted(unknown)}")
        if p_target is None:
            p_init = 1.0
        self.p_init = float(p_init)
        self.p_target = p_target
        self.kimg = float(kimg) * 1000.0

    def init_state(self, device="cpu") -> AdaState:
        return AdaState.create(self.p_init, device)

    def __call__(self, x: torch.Tensor, p, stream) -> torch.Tensor:
        """Each op of the policy in turn at strength p (a float or 0-dim tensor); every
        draw comes from `stream`, whose batch must be x's."""
        if stream.n is not None and stream.n != x.shape[0]:
            raise ValueError(f"stream draws for {stream.n} samples, the batch has {x.shape[0]}")
        for name in self.policy:
            x = _FNS[name](x, stream, p)
        return x

    cumulate = staticmethod(AdaptiveAugment.cumulate)

    @torch.no_grad()
    def update_p(self, state: AdaState) -> Tuple[AdaState, torch.Tensor]:
        """Move p toward p_target by sign(rt - target) * n / kimg within [0, 1]; reset
        the sums."""
        rt = state.sign_cum / torch.clamp(state.n_pred_cum, min=1.0)
        p = state.p
        if self.p_target is not None:
            adjust = torch.sign(rt - self.p_target) * state.n_pred_cum / self.kimg
            p = torch.clamp(state.p + adjust, 0.0, 1.0)
        z = torch.zeros_like(state.p)
        return dataclasses.replace(state, p=p, sign_cum=z, n_pred_cum=z.clone()), rt
