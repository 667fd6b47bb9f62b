"""Shared StyleGAN-style generator plumbing.

Counterpart of dusty_gan_v2_tpu/models/base.py::GeneratorMixin (`_style`): map z (through
the arch's mapping function: dusty_v2's mapping network, the identity for the single-style
dusty_v1) and repeat w over the styles; in train mode move `w_avg` toward the batch mean of
the first style. No style mixing and no truncation: no benchmarked cell sets either.
"""

from __future__ import annotations

from typing import Callable

import torch
__all__ = ["GeneratorMixin"]


class GeneratorMixin:
    """Mixin for a Generator nn.Module with a `w_avg` buffer (1, style_dim)."""

    w_avg_decay: float = 0.995

    def _style(self, mapping_fn: Callable[[torch.Tensor], torch.Tensor], z: torch.Tensor, num_styles: int,
               train: bool = False) -> torch.Tensor:
        """z (B, D) -> ws (B, num_styles, D) through `mapping_fn`. Train mode updates w_avg
        in place from the detached float32 batch mean of the first style."""
        w = mapping_fn(z)[:, None, :].expand(-1, num_styles, -1)
        if train:
            with torch.no_grad():
                batch_mean = w[:, 0].float().mean(dim=0, keepdim=True)
                self.w_avg.copy_(self.w_avg + (1.0 - self.w_avg_decay) * (batch_mean - self.w_avg))
        return w
