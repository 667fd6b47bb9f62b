"""Model builders (counterpart of dusty_gan_v2_tpu/models/builder.py)."""

from __future__ import annotations

from typing import Any, Dict

import torch
from torch import nn

from ..utils import resolve_device
from . import dusty_v1, dusty_v2, vanilla

__all__ = ["build_generator", "build_discriminator"]


def _normalize(kwargs: Dict[str, Any]) -> Dict[str, Any]:
    kwargs = dict(kwargs)
    for key in ("resolution", "layers", "pe_scale_offset"):
        if key in kwargs:
            kwargs[key] = tuple(kwargs[key])
    if "out_ch" in kwargs:
        kwargs["out_ch"] = tuple(dict(o) for o in kwargs["out_ch"])
    return kwargs


def build_generator(cfg: Dict[str, Any], device="cuda", seed: int = 0) -> nn.Module:
    """cfg: {"arch", "mapping_kwargs", "synthesis_kwargs", "measurement_kwargs",
    "compute_dtype"} (the JAX package's schema; arch vanilla, dusty_v1 or dusty_v2, the
    first two reading only their synthesis and measurement kwargs). Weights are drawn on
    the CPU from a torch.Generator seeded with `seed`, then moved to `device` (CUDA by
    default; raises when no card is present). The model is returned in eval mode."""
    device = resolve_device(device)
    arch = cfg["arch"]
    if arch == "vanilla":
        G = vanilla.Generator(synthesis_kwargs=_normalize(cfg["synthesis_kwargs"]))
    elif arch == "dusty_v1":
        G = dusty_v1.Generator(
            synthesis_kwargs=_normalize(cfg["synthesis_kwargs"]),
            measurement_kwargs=dict(cfg.get("measurement_kwargs", {})),
        )
    elif arch == "dusty_v2":
        G = dusty_v2.Generator(
            mapping_kwargs=dict(cfg["mapping_kwargs"]),
            synthesis_kwargs=_normalize(cfg["synthesis_kwargs"]),
            measurement_kwargs=dict(cfg.get("measurement_kwargs", {})),
            compute_dtype=cfg.get("compute_dtype", "float32"),
        )
    else:
        raise NotImplementedError(f"generator arch: {arch!r}")
    G.reset_parameters(torch.Generator().manual_seed(seed))
    return G.to(device).eval()


def build_discriminator(cfg: Dict[str, Any], device="cuda", seed: int = 0) -> nn.Module:
    """cfg: {"arch", "layer_kwargs", "compute_dtype"} (the JAX package's schema; arch
    vanilla or dusty_v2, whose layer_kwargs take the cfg's compute_dtype as default).
    Weights are drawn on the CPU from a torch.Generator seeded with `seed`, then moved to
    `device` (CUDA by default; raises when no card is present)."""
    device = resolve_device(device)
    arch = cfg["arch"]
    kwargs = _normalize(cfg["layer_kwargs"])
    if arch == "vanilla":
        D = vanilla.Discriminator(**kwargs)
    elif arch == "dusty_v2":
        kwargs.setdefault("compute_dtype", cfg.get("compute_dtype", "float32"))
        D = dusty_v2.Discriminator(**kwargs)
    else:
        raise NotImplementedError(f"discriminator arch: {arch!r}")
    D.reset_parameters(torch.Generator().manual_seed(seed))
    return D.to(device)
