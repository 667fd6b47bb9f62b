"""Small utilities: range-image value maps, device resolution, float32 guard."""

from __future__ import annotations

import contextlib

import torch

__all__ = ["tanh_to_sigmoid", "sigmoid_to_tanh", "resolve_device", "full_float32"]


def tanh_to_sigmoid(x):
    """[-1,+1] -> [0,1]"""
    return (x + 1.0) / 2.0


def sigmoid_to_tanh(x):
    """[0,1] -> [-1,+1]"""
    return x * 2.0 - 1.0


@contextlib.contextmanager
def full_float32():
    """Float32 matmuls and convolutions in full float32 inside the block, whatever the
    process-wide TF32 switches say (cuDNN convolutions take TF32 by default); the
    switches are restored on exit. The metrics use it so that a score does not depend
    on a flag set elsewhere."""
    matmul, cudnn = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = matmul
        torch.backends.cudnn.allow_tf32 = cudnn


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
