"""Small utilities: range-image value maps, colorization, surface-normal colours, spectra,
masked losses, device resolution, float32 guard, seeding.

Counterpart of dusty_gan_v2_tpu/utils/__init__.py (sigmoid / tanh maps, colorize,
points_to_normal_2d, power_spectrum_2d, masked_loss, init_random_seed). The colour table
is the port's own (utils/colormap.py) and images are written by utils/image_io.py.
"""

from __future__ import annotations

import contextlib
import random

import numpy as np
import torch

from .colormap import get_lut

__all__ = [
    "tanh_to_sigmoid", "sigmoid_to_tanh", "colorize", "colorize_indices", "points_to_normal_2d", "power_spectrum_2d",
    "masked_loss", "resolve_device", "full_float32", "init_random_seed",
]


def tanh_to_sigmoid(x):
    """[-1,+1] -> [0,1]"""
    return (x + 1.0) / 2.0


def sigmoid_to_tanh(x):
    """[0,1] -> [-1,+1]"""
    return x * 2.0 - 1.0


def _plane(x: torch.Tensor) -> torch.Tensor:
    if x.ndim == 4:
        if x.shape[1] != 1:
            raise ValueError(f"colorize takes (B, 1, H, W) or (B, H, W), got {tuple(x.shape)}")
        x = x[:, 0]
    if x.ndim != 3:
        raise ValueError(f"colorize takes (B, 1, H, W) or (B, H, W), got {tuple(x.shape)}")
    return x


def colorize_indices(x: torch.Tensor, n: int = 256) -> torch.Tensor:
    """(B, 1, H, W) or (B, H, W) values in [0, 1] -> (B, H, W) int64 rows of an n-entry
    table: clip(x * n, 0, n - 1) truncated (a NaN takes row 0, as in the JAX gather)."""
    return torch.clamp(_plane(x) * n, 0, n - 1).long().clamp(0, n - 1)


def colorize(x: torch.Tensor, cmap="turbo") -> torch.Tensor:
    """(B, 1, H, W) or (B, H, W) values in [0, 1] -> (B, 3, H, W) float32 colours of the
    table `cmap` (a name, or an (N, 3) array)."""
    lut = torch.tensor(get_lut(cmap), dtype=torch.float32, device=x.device)
    return lut[colorize_indices(x, lut.shape[0])].permute(0, 3, 1, 2)


def points_to_normal_2d(points_map: torch.Tensor, mode: str = "closest", d: int = 2) -> torch.Tensor:
    """(B, 3, H, W) points -> surface-normal colours in [0, 1]: the normals turned toward
    the sensor, NaN as 0, mapped from [-1, 1]."""
    from ..geometry.normals import estimate_surface_normal

    normals = torch.nan_to_num(-estimate_surface_normal(points_map, d=d, mode=mode), nan=0.0)
    return torch.clamp(tanh_to_sigmoid(normals), 0.0, 1.0)


def power_spectrum_2d(x) -> np.ndarray:
    """10 log10 |FFT2|^2 over the last two axes, DC centred, forward normalization; numpy
    on the host (a few logging images)."""
    x = x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    spec = np.fft.fftshift(np.fft.fft2(x, norm="forward"), axes=(-1, -2))
    return 10.0 * np.log10(np.abs(spec) ** 2 + 1e-24)


def masked_loss(img_ref: torch.Tensor, img_gen: torch.Tensor, mask: torch.Tensor, distance: str = "l1") -> torch.Tensor:
    """Per-sample mean absolute or squared error over the pixels where mask is 1."""
    if distance == "l1":
        loss = (img_ref - img_gen).abs()
    elif distance == "l2":
        loss = (img_ref - img_gen) ** 2
    else:
        raise NotImplementedError(distance)
    return (loss * mask).sum(dim=(1, 2, 3)) / mask.sum(dim=(1, 2, 3))


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


def init_random_seed(seed: int) -> None:
    """Seed Python's `random`, numpy's global generator and torch's default generators
    (the CPU's and every card's). The training step's own draws come from the trainer's
    generator, keyed by (seed, iteration)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
