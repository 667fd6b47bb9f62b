"""Shared StyleGAN-style generator plumbing.

Counterpart of dusty_gan_v2_tpu/models/base.py::GeneratorMixin._style: map z (through
the arch's mapping function: dusty_v2's mapping network, the identity for the
single-style vanilla and dusty_v1), repeat w over the styles (or take given styles,
`input_w`); in eval mode pull them toward `w_avg` by the truncation trick, in train mode
move `w_avg` toward the batch mean of the first style instead (no truncation). Style
mixing is not ported.
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from ..parallel.mesh import axis_pmean

__all__ = ["GeneratorMixin", "reset_children"]


def reset_children(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every submodule's weights anew from `generator`, in module order."""
    for m in module.modules():
        if m is not module and hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)


class GeneratorMixin:
    """Mixin for a Generator nn.Module with a `w_avg` buffer (1, style_dim)."""

    w_avg_decay: float = 0.995

    def _style(
        self, mapping_fn: Callable[[torch.Tensor], torch.Tensor], z: torch.Tensor, num_styles: int,
        truncation_psi: float, train: bool = False, input_w: bool = False,
    ) -> torch.Tensor:
        """z (B, D) -> ws (B, num_styles, D) through `mapping_fn`; with input_w, z is
        already ws. Train mode updates w_avg in place from the detached float32 batch
        mean of the first style."""
        if input_w:
            if z.ndim != 3 or z.shape[1] != num_styles:
                raise ValueError(f"input_w takes styles (B, {num_styles}, D), got {tuple(z.shape)}")
            w = z
        else:
            w = mapping_fn(z)
            w = w[:, None, :].expand(-1, num_styles, -1)
        if train:
            with torch.no_grad():
                batch_mean = axis_pmean(w[:, 0].float().mean(dim=0, keepdim=True))
                self.w_avg.copy_(self.w_avg + (1.0 - self.w_avg_decay) * (batch_mean - self.w_avg))
        elif truncation_psi != 1.0:
            w_avg = self.w_avg[None].to(w.dtype)
            w = w_avg + truncation_psi * (w - w_avg)
        return w
