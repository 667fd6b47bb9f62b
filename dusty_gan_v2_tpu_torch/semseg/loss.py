"""Focal loss, cross-entropy and the masked mean of the semseg training step.

Counterpart of dusty_gan_v2_tpu/semseg/loss.py: the label's log-probability is a
one-hot select-sum over the class axis of one log_softmax, and focal's p_label is
exp of it."""

from __future__ import annotations

import torch

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
    """sum(loss * mask) / sum(mask) over one process's batch.

    A data-parallel step must divide by the mask sum averaged over the ranks (the JAX
    package's axis_pmean), so that the mean of the ranks' losses and gradients is the
    global masked mean whatever the split; this one-process form is that with one rank."""
    return (per_pixel_loss * mask).sum() / mask.sum()
