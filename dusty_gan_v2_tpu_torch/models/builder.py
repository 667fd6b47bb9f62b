"""Model builder (counterpart of dusty_gan_v2_tpu/models/builder.py::build_generator)."""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..utils import resolve_device
from . import dusty_v2

__all__ = ["build_generator"]


def _normalize(kwargs: Dict[str, Any]) -> Dict[str, Any]:
    kwargs = dict(kwargs)
    for key in ("resolution", "layers", "pe_scale_offset"):
        if key in kwargs:
            kwargs[key] = tuple(kwargs[key])
    if "out_ch" in kwargs:
        kwargs["out_ch"] = tuple(dict(o) for o in kwargs["out_ch"])
    return kwargs


def build_generator(cfg: Dict[str, Any], device="cuda", seed: int = 0) -> dusty_v2.Generator:
    """cfg: {"arch", "mapping_kwargs", "synthesis_kwargs", "measurement_kwargs",
    "compute_dtype"} (the JAX package's schema). Weights are drawn on the CPU from a
    torch.Generator seeded with `seed`, then moved to `device` (CUDA by default; raises
    when no card is present). The model is returned in eval mode."""
    device = resolve_device(device)
    arch = cfg["arch"]
    if arch != "dusty_v2":
        raise NotImplementedError(f"generator arch {arch!r} is not ported yet")
    G = dusty_v2.Generator(
        mapping_kwargs=dict(cfg["mapping_kwargs"]),
        synthesis_kwargs=_normalize(cfg["synthesis_kwargs"]),
        measurement_kwargs=dict(cfg.get("measurement_kwargs", {})),
        compute_dtype=cfg.get("compute_dtype", "float32"),
    )
    G.reset_parameters(torch.Generator().manual_seed(seed))
    return G.to(device).eval()
