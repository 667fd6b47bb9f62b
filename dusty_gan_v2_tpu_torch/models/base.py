"""Shared StyleGAN-style generator plumbing.

Counterpart of dusty_gan_v2_tpu/models/base.py::GeneratorMixin (`_forward_mapping`,
`_style`): map z (through the arch's mapping function: dusty_v2's mapping network, the
identity for the single-style vanilla and dusty_v1), repeat w over the styles, or with
style mixing take the first n styles from z's w and the rest from a partner latent's
(or take given styles, `input_w`); in eval mode pull them toward `w_avg` by the
truncation trick, in train mode move `w_avg` toward the batch mean of the first style
instead (no truncation).

Style mixing's two draws, the partner latent (one per sample) and the crossover n ~
U{1..num_styles} (one scalar for the batch), come from a stream (`draw_style_mixing`):
the JAX package keys the first by the sample's global id and draws the second once for
all shards; the port's PerSampleStream gives the same structure from its own bits, and
a ReplayStream hands in JAX's.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch
from torch import nn

from ..parallel.mesh import axis_pmean
from ..parallel.persample import PerSampleStream

__all__ = ["GeneratorMixin", "reset_children", "draw_style_mixing"]


def reset_children(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every submodule's weights anew from `generator`, in module order."""
    for m in module.modules():
        if m is not module and hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)


def draw_style_mixing(stream, dim: int, num_styles: int, dtype=torch.float32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Style mixing's draws from `stream`: the partner latent (n, dim) normal per sample,
    then the crossover, an int64 scalar uniform in [1, num_styles] for the whole batch."""
    return stream.normal((dim,), dtype), stream.scalar_randint(1, num_styles + 1)


class GeneratorMixin:
    """Mixin for a Generator nn.Module with a `w_avg` buffer (1, style_dim)."""

    w_avg_decay: float = 0.995

    @staticmethod
    def _mixing(style_mixing: bool, mixing, z: torch.Tensor, num_styles: int, generator):
        """Style mixing's draws for z's batch: `mixing` where given, else drawn from
        `generator` after the forward's other per-sample draws; None without style
        mixing."""
        if not style_mixing:
            if mixing is not None:
                raise ValueError("mixing draws are given, but style_mixing is off")
            return None
        if mixing is not None:
            return mixing
        if generator is None:
            raise ValueError("pass mixing or a torch.Generator to draw it")
        return draw_style_mixing(PerSampleStream(z.shape[0], generator, z.device), z.shape[1], num_styles, z.dtype)

    def _style(
        self, mapping_fn: Callable[[torch.Tensor], torch.Tensor], z: torch.Tensor, num_styles: int,
        truncation_psi: float, train: bool = False, input_w: bool = False,
        mixing: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> torch.Tensor:
        """z (B, D) -> ws (B, num_styles, D) through `mapping_fn`; with input_w, z is
        already ws. `mixing`, style mixing's draws (draw_style_mixing: the partner z2
        (B, D) and the crossover n), mixes the styles: the first n are z's, the rest
        z2's. Train mode updates w_avg in place from the detached float32 batch mean of
        the first style."""
        if input_w:
            if z.ndim != 3 or z.shape[1] != num_styles:
                raise ValueError(f"input_w takes styles (B, {num_styles}, D), got {tuple(z.shape)}")
            w = z
        elif mixing is not None:
            z2, n = mixing
            if z2.shape != z.shape or n.ndim != 0:
                raise ValueError(f"style mixing takes a partner z of {tuple(z.shape)} and a scalar crossover")
            w1, w2 = mapping_fn(z), mapping_fn(z2.to(z.dtype))
            sel = torch.arange(num_styles, device=w1.device)[None, :, None] < n.to(w1.device)
            w = torch.where(sel, w1[:, None, :], w2[:, None, :])
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
