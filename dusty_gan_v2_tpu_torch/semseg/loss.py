"""Focal loss, cross-entropy and the masked mean of the semseg training step.

Counterpart of dusty_gan_v2_tpu/semseg/loss.py: the label's log-probability is a
one-hot select-sum over the class axis of one log_softmax, and focal's p_label is
exp of it."""

from __future__ import annotations

import torch

from ..parallel.mesh import axis_pmean

__all__ = ["focal_loss", "cross_entropy", "masked_seg_loss"]


def _label_logp(logit: torch.Tensor, label: torch.Tensor):
    """log_softmax(logit)[label] as a one-hot select-sum: (B,C,H,W), (B,H,W) -> (B,H,W).
    where() rather than a product, so that a -inf logp never becomes 0 * inf = NaN."""
    logp = torch.log_softmax(logit, dim=1)
    classes = torch.arange(logit.shape[1], device=label.device, dtype=label.dtype).reshape(1, -1, 1, 1)
    onehot = label[:, None] == classes
    return torch.where(onehot, logp, torch.zeros((), dtype=logp.dtype, device=logp.device)).sum(1), onehot


def _class_weight(onehot: torch.Tensor, weight, dtype) -> torch.Tensor:
    """weight[label] as the same select-sum: (B,C,H,W) bool, (C,) -> (B,H,W)."""
    w = torch.as_tensor(weight, device=onehot.device).to(dtype).reshape(1, -1, 1, 1)
    return torch.where(onehot, w, torch.zeros((), dtype=dtype, device=onehot.device)).sum(1)


def cross_entropy(logit: torch.Tensor, label: torch.Tensor, class_weight=None) -> torch.Tensor:
    """Per-pixel weighted CE: logit (B,C,H,W), label (B,H,W) int."""
    logp_l, onehot = _label_logp(logit, label)
    ce = -logp_l
    if class_weight is not None:
        ce = ce * _class_weight(onehot, class_weight, ce.dtype)
    return ce


def focal_loss(logit: torch.Tensor, label: torch.Tensor, gamma: float, alpha=None) -> torch.Tensor:
    """(1 - p)^gamma weighted CE with optional class weights alpha."""
    logp_l, onehot = _label_logp(logit, label)
    ce = -logp_l
    if alpha is not None:
        ce = ce * _class_weight(onehot, alpha, ce.dtype)
    return (1.0 - torch.exp(logp_l)) ** gamma * ce


def masked_seg_loss(per_pixel_loss: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """sum(loss * mask) over this rank's batch / the ranks' mean of sum(mask).

    Dividing by the mask sum averaged over the ranks (axis_pmean, as the JAX package
    does) makes the mean of the ranks' losses and gradients the global masked mean
    whatever the split; with no process group bound it is sum(loss * mask) / sum(mask)."""
    return (per_pixel_loss * mask).sum() / axis_pmean(mask.sum())
