"""The port's sampling entry points (counterpart of __graft_entry__.py and of the
generate -> FPS stage of test_gan.py).

    G = build_generator(full_gen_cfg())               # CUDA by default
    angle = load_angle()
    coord = make_coord_bridge(angle)
    o = sample(G, z, angle, truncation_psi=0.7, gumbel_noise=noise)
    o, inv, points = sample_and_downsample(G, z, angle, coord, k=2048, ...)

Every generator arch samples through the same calls (build_generator(train_cfg("vanilla")
["model"]["generator"])): a vanilla generator reads neither the angle nor the noise.
"""

from __future__ import annotations

import copy
from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from .geometry import CoordBridge, resize_angle_lut
from .metrics import downsample_point_clouds
from .utils import resolve_device, tanh_to_sigmoid
from .utils.config import load_config

__all__ = [
    "ANGLE_FILE", "full_gen_cfg", "full_disc_cfg", "train_cfg", "full_train_cfg", "load_angle", "make_coord_bridge", "sample",
    "sample_and_downsample",
]

ANGLE_FILE = Path(__file__).resolve().parent.parent / "data" / "coords" / "kitti_raw.npy"
CONFIG_DIR = Path(__file__).resolve().parent.parent / "configs" / "gans"
# KITTI Raw depth range (configs/gans/dusty_v2.yaml, dataset.min_depth / max_depth)
MIN_DEPTH, MAX_DEPTH = 1.45, 80.0

_FULL_GEN_CFG = {
    "arch": "dusty_v2",
    "mapping_kwargs": {"in_ch": 512, "out_ch": 512, "depth": 2},
    "synthesis_kwargs": {
        "in_ch": 512,
        "out_ch": (
            {"name": "image", "ch": 1, "act": "tanh"},
            {"name": "raydrop_logit", "ch": 1, "act": None},
        ),
        "ch_base": 32,
        "ch_max": 512,
        "resolution": (64, 512),
        "layers": (2, 2, 2, 2),
        "ring": True,
        "use_noise": False,
        "aug_coords": True,
    },
    "measurement_kwargs": {"raydrop_const": -1, "gumbel_temperature": 1},
}


def full_gen_cfg(z_dim: int = 512, resolution=(64, 512)) -> dict:
    """The flagship dusty_v2 generator configuration (KITTI Raw 64x512)."""
    cfg = copy.deepcopy(_FULL_GEN_CFG)
    cfg["mapping_kwargs"].update(in_ch=z_dim, out_ch=z_dim)
    cfg["synthesis_kwargs"].update(in_ch=z_dim, resolution=tuple(resolution))
    return cfg


def full_disc_cfg(resolution=(64, 512)) -> dict:
    """The flagship dusty_v2 discriminator configuration (configs/gans/dusty_v2.yaml,
    model.discriminator)."""
    return {
        "arch": "dusty_v2",
        "layer_kwargs": {
            "in_ch": 1, "ring": True, "ch_base": 32, "ch_max": 512, "resolution": tuple(resolution),
            "mbdis_group": 4, "mbdis_feat": 1, "num_fp16_layers": -1, "pre_blur": True,
        },
    }


def train_cfg(name: str) -> dict:
    """The "dataset", "training" and "model" sections of configs/gans/<name>.yaml, read
    with utils/config.py::load_config: dusty_v1 (DUSty v1 G + vanilla D) and vanilla
    (vanilla G + vanilla D), both float32 at B=32, or the dusty_v2 pair."""
    cfg = load_config(str(CONFIG_DIR / f"{name}.yaml")).to_dict()
    return {k: cfg[k] for k in ("dataset", "training", "model")}


def full_train_cfg(bf16: bool) -> dict:
    """train_cfg of the flagship: configs/gans/dusty_v2_bf16.yaml (bf16=True: bfloat16
    compute, B=128) or configs/gans/dusty_v2.yaml (float32, B=32)."""
    return train_cfg("dusty_v2_bf16" if bf16 else "dusty_v2")


def load_angle(resolution=(64, 512), device="cuda") -> torch.Tensor:
    """The KITTI Raw laser-angle LUT resampled to `resolution`: (1, 2, H, W) float32."""
    device = resolve_device(device)
    return resize_angle_lut(np.load(ANGLE_FILE), tuple(resolution), device)


def make_coord_bridge(angle: torch.Tensor) -> CoordBridge:
    """A CoordBridge over `angle` (1, 2, H, W) with the KITTI Raw depth range."""
    H, W = angle.shape[-2:]
    return CoordBridge(H, W, MIN_DEPTH, MAX_DEPTH, angle=angle, device=angle.device)


@torch.no_grad()
def sample(
    G,
    z: torch.Tensor,
    angle: Optional[torch.Tensor],
    truncation_psi: float = 1.0,
    gumbel_noise: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    pe_cache=None,
    noise=None,
) -> Dict[str, torch.Tensor]:
    """One generator forward without autograd; returns the dict G returns. A
    generator with noise injection takes `noise` (its maps: models.fixed_noise_maps'
    layout) or draws them per sample from `generator`."""
    kw = {} if noise is None else {"noise": noise}
    return G(
        z, angle, truncation_psi=truncation_psi, gumbel_noise=gumbel_noise,
        generator=generator, pe_cache=pe_cache, **kw,
    )


@torch.no_grad()
def sample_and_downsample(
    G,
    z: torch.Tensor,
    angle: torch.Tensor,
    coord: CoordBridge,
    truncation_psi: float = 1.0,
    gumbel_noise: Optional[torch.Tensor] = None,
    k: int = 2048,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, torch.Tensor]:
    """Sample, map the image to points in units of max_depth, FPS-downsample to k:
    returns (G's dict, inv_depth_norm (B, 1, H, W), points (B, k, 3))."""
    o = sample(G, z, angle, truncation_psi, gumbel_noise)
    inv = torch.clamp(tanh_to_sigmoid(o["image"]), 0, 1)
    pts = coord.convert(inv, "inv_depth_norm", "point_set") / coord.max_depth
    return o, inv, downsample_point_clouds(pts, k)
