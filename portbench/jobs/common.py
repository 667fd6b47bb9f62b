"""Inputs the jobs share, all made on the device from the seed."""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch

from ..harness.cells import ROOT
from ..reference.geometry import resize_angle_lut
from ..reference.stream import SeedStream, mix_seed

ANGLE_LUT = ROOT / "data" / "coords" / "kitti_raw.npy"  # the sensor's laser-angle table (a raw file)

# salts: each kind of input draws from a generator of its own
BATCH, DRAWS, LATENTS = 11, 12, 13


def model_cfg(config: Dict[str, Any]) -> Dict[str, Any]:
    """The sections a trainer reads, from a configuration file."""
    return {k: config[k] for k in ("dataset", "training", "model")}


def angle(resolution, device) -> torch.Tensor:
    return resize_angle_lut(np.load(ANGLE_LUT), tuple(resolution), device)


def depth_batch(seed: int, it: int, B: int, H: int, W: int, traffic: Dict[str, Any], device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Synthetic depth (m) and a mask for iteration `it`: depth uniform over the traffic's
    range, each ray kept with probability mask_keep."""
    gen = torch.Generator(device=device).manual_seed(mix_seed(seed, BATCH, it))
    lo, hi = traffic["depth_range_m"]
    u = torch.rand(2, B, 1, H, W, generator=gen, device=device)
    return lo + (hi - lo) * u[0], (u[1] < traffic["mask_keep"]).float()


def step_stream(seed: int, it: int, B: int, device) -> SeedStream:
    return SeedStream.seeded(B, device, seed, DRAWS, it)


def load_limits(cell: str) -> Dict[str, float]:
    path = Path(__file__).resolve().parent.parent / "limits" / f"{cell}.json"
    return json.loads(path.read_text())["limits"]
