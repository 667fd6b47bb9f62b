"""Shared StyleGAN-style generator plumbing, eval path.

Counterpart of dusty_gan_v2_tpu/models/base.py::GeneratorMixin._style: map z, repeat
w over the styles, and pull it toward `w_avg` by the truncation trick. Style mixing
and the train-time w_avg update are not ported yet.
"""

from __future__ import annotations

import torch

__all__ = ["GeneratorMixin"]


class GeneratorMixin:
    """Mixin for a Generator nn.Module with a `mapping_network` and a `w_avg` buffer."""

    def _style(self, z: torch.Tensor, num_styles: int, truncation_psi: float) -> torch.Tensor:
        """z (B, D) -> ws (B, num_styles, D)."""
        w = self.mapping_network(z)
        w = w[:, None, :].expand(-1, num_styles, -1)
        if truncation_psi != 1.0:
            w_avg = self.w_avg[None].to(w.dtype)
            w = w_avg + truncation_psi * (w - w_avg)
        return w
