"""Shared StyleGAN-style generator plumbing.

Counterpart of dusty_gan_v2_tpu/models/base.py::GeneratorMixin._style: map z, repeat w
over the styles (or take given styles, `input_w`); in eval mode pull them toward `w_avg`
by the truncation trick, in train mode move `w_avg` toward the batch mean of the first
style instead (no truncation). Style mixing is not ported.
"""

from __future__ import annotations

import torch

__all__ = ["GeneratorMixin"]


class GeneratorMixin:
    """Mixin for a Generator nn.Module with a `mapping_network` and a `w_avg` buffer."""

    w_avg_decay: float = 0.995

    def _style(
        self, z: torch.Tensor, num_styles: int, truncation_psi: float, train: bool = False, input_w: bool = False
    ) -> torch.Tensor:
        """z (B, D) -> ws (B, num_styles, D); with input_w, z is already ws. Train mode
        updates w_avg in place from the detached float32 batch mean of the first style."""
        if input_w:
            if z.ndim != 3 or z.shape[1] != num_styles:
                raise ValueError(f"input_w takes styles (B, {num_styles}, D), got {tuple(z.shape)}")
            w = z
        else:
            w = self.mapping_network(z)
            w = w[:, None, :].expand(-1, num_styles, -1)
        if train:
            with torch.no_grad():
                batch_mean = w[:, 0].float().mean(dim=0, keepdim=True)
                self.w_avg.copy_(self.w_avg + (1.0 - self.w_avg_decay) * (batch_mean - self.w_avg))
        elif truncation_psi != 1.0:
            w_avg = self.w_avg[None].to(w.dtype)
            w = w_avg + truncation_psi * (w - w_avg)
        return w
