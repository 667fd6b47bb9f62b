"""Small utilities: range-image value maps and device resolution."""

from __future__ import annotations

import torch

__all__ = ["tanh_to_sigmoid", "resolve_device"]


def tanh_to_sigmoid(x):
    """[-1,+1] -> [0,1]"""
    return (x + 1.0) / 2.0


def resolve_device(device) -> torch.device:
    """The torch.device for `device`; raises for a CUDA device when no card is present.

    Entry points default to "cuda" and call this first, so that a machine without a
    card fails at once instead of running on the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested but torch.cuda.is_available() is false; "
            "pass device='cpu' explicitly to run on the CPU"
        )
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device: {device}")
    return device
