"""Checkpoint autoloader (counterpart of dusty_gan_v2_tpu/pretrained.py::autoload_ckpt, its
local-checkpoint route).

    ckpt = autoload_ckpt("logs/gans/.../models/checkpoint_0000002048.ckpt")  # CUDA by default
    o = ckpt["G_ema"](z, ckpt["angle"], gumbel_noise=noise)

It reads the port's own checkpoints (training/checkpoint.py). The release keywords (a
download of the published `.pth` files), the conversion of released `.pth` checkpoints
and the JAX package's msgpack checkpoints are not read yet.
"""

from __future__ import annotations

import os
from typing import Any, Dict

from .models import build_discriminator, build_generator
from .training.checkpoint import load_checkpoint
from .utils import resolve_device

__all__ = ["autoload_ckpt"]


def autoload_ckpt(path: str, device="cuda") -> Dict[str, Any]:
    """{"cfg", "angle" (1, 2, H, W), "step" (images seen), "G", "G_ema", "D" (modules on
    `device`, G and G_ema in eval mode), "state" (the file's state dict, on the CPU)}."""
    device = resolve_device(device)
    if not os.path.isfile(path):
        raise ValueError(f"no checkpoint at {path!r} (the release keywords are not supported yet)")
    cfg, state, angle, num_imgs = load_checkpoint(path)
    out = {"cfg": cfg, "angle": angle.to(device), "step": num_imgs, "state": state}
    for name in ("G", "G_ema"):
        G = build_generator(cfg["model"]["generator"], device=device)
        G.load_state_dict(state[name], strict=True)
        out[name] = G.requires_grad_(False).eval()
    D = build_discriminator(cfg["model"]["discriminator"], device=device)
    D.load_state_dict(state["D"], strict=True)
    out["D"] = D
    return out
