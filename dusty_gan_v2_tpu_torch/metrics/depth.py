"""Masked depth error and accuracy metrics (counterpart of
dusty_gan_v2_tpu/metrics/depth.py)."""

from __future__ import annotations

import torch

__all__ = ["compute_depth_error", "compute_depth_accuracy"]

_DIMS = (1, 2, 3)


def compute_depth_error(depth_ref, depth_gen, mask=None):
    mask = torch.ones_like(depth_ref) if mask is None else mask
    depth_ref = depth_ref + 1e-8
    depth_gen = depth_gen + 1e-8
    denom = mask.sum(_DIMS)
    diff = depth_ref - depth_gen
    abs_rel = (diff.abs() / depth_ref * mask).sum(_DIMS) / denom
    sq_rel = (diff**2 / depth_ref * mask).sum(_DIMS) / denom
    rmse = torch.sqrt((diff**2 * mask).sum(_DIMS) / denom)
    rmse_log = torch.sqrt(((torch.log(depth_ref) - torch.log(depth_gen)) ** 2 * mask).sum(_DIMS) / denom)
    return {"abs_rel": abs_rel, "sq_rel": sq_rel, "rmse": rmse, "rmse_log": rmse_log}


def compute_depth_accuracy(depth_ref, depth_gen, mask=None):
    mask = torch.ones_like(depth_ref) if mask is None else mask
    denom = mask.sum(_DIMS)
    delta = torch.maximum(depth_ref / depth_gen, depth_gen / depth_ref)
    return {
        f"accuracy_{i}": ((delta < 1.25**i).float() * mask).sum(_DIMS) / denom for i in (1, 2, 3)
    }
