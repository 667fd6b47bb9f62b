"""Checkpoint autoloader (counterpart of dusty_gan_v2_tpu/pretrained.py::autoload_ckpt, its
local-checkpoint routes).

    ckpt = autoload_ckpt("logs/gans/.../models/checkpoint_0000002048.ckpt")  # CUDA by default
    o = ckpt["G_ema"](z, ckpt["angle"], gumbel_noise=noise)

It reads three kinds of file: the port's own checkpoints and the JAX CLI's msgpack
checkpoints (training/checkpoint.py tells them apart by their first bytes), and the
reference implementation's `.pth` checkpoints (convert/torch_weights.py; a file named
*.pth). The release keywords (a download of the published `.pth` files) are not
supported: a checkpoint is a local file.
"""

from __future__ import annotations

import os
from typing import Any, Dict

from .convert.torch_weights import load_reference_checkpoint
from .models import build_discriminator, build_generator
from .training.checkpoint import load_checkpoint
from .utils import resolve_device

__all__ = ["autoload_ckpt"]


def autoload_ckpt(path: str, device="cuda") -> Dict[str, Any]:
    """{"cfg", "angle" (1, 2, H, W), "step" (images seen; None for a reference file),
    "G", "G_ema", "D" (modules on `device`, G and G_ema in eval mode; those the file
    holds), "state" (the file's state dict, on the CPU; the converted state_dicts for a
    reference file)}."""
    device = resolve_device(device)
    if not os.path.isfile(path):
        raise ValueError(f"no checkpoint at {path!r} (the release keywords are not supported)")
    if path.endswith(".pth"):
        state = load_reference_checkpoint(path)
        cfg, angle, num_imgs = state["cfg"], state["angle"], None
        if angle is None:
            raise ValueError(f"{path}: the checkpoint holds no angle table")
    else:
        cfg, state, angle, num_imgs = load_checkpoint(path)
    out = {"cfg": cfg, "angle": angle.to(device), "step": num_imgs, "state": state}
    for name in ("G", "G_ema"):
        if name in state:
            G = build_generator(cfg["model"]["generator"], device=device)
            G.load_state_dict(state[name], strict=True)
            out[name] = G.requires_grad_(False).eval()
    if "D" in state:
        D = build_discriminator(cfg["model"]["discriminator"], device=device)
        D.load_state_dict(state["D"], strict=True)
        out["D"] = D
    return out
