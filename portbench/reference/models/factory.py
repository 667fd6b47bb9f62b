"""Build the reference's generator and discriminator from a configuration's model section.
Parameters are left as allocated: the benchmark loads its seeded weights into them."""

from __future__ import annotations

from typing import Any, Dict

from torch import nn

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


def build_generator(cfg: Dict[str, Any], device) -> nn.Module:
    """The generator of `cfg` (arch dusty_v1 or dusty_v2) in float32: the reference
    ignores the configuration's compute_dtype."""
    arch = cfg["arch"]
    if arch == "dusty_v1":
        G = dusty_v1.Generator(
            synthesis_kwargs=_normalize(cfg["synthesis_kwargs"]),
            measurement_kwargs=dict(cfg.get("measurement_kwargs", {})),
        )
    elif arch == "dusty_v2":
        syn = _normalize(cfg["synthesis_kwargs"])
        # float32 compute; the Fourier phase at the configuration's dtype (dusty_v2.py::pe_volume)
        syn["pe_dtype"] = syn.get("compute_dtype", cfg.get("compute_dtype", "float32"))
        syn["compute_dtype"] = "float32"
        G = dusty_v2.Generator(
            mapping_kwargs=dict(cfg["mapping_kwargs"]), synthesis_kwargs=syn,
            measurement_kwargs=dict(cfg.get("measurement_kwargs", {})),
        )
    else:
        raise NotImplementedError(f"generator arch: {arch!r}")
    return G.to(device).eval()


def build_discriminator(cfg: Dict[str, Any], device) -> nn.Module:
    """The discriminator of `cfg` (arch vanilla or dusty_v2) in float32."""
    arch = cfg["arch"]
    kwargs = _normalize(cfg["layer_kwargs"])
    if arch == "vanilla":
        D = vanilla.Discriminator(**kwargs)
    elif arch == "dusty_v2":
        kwargs["compute_dtype"] = "float32"
        D = dusty_v2.Discriminator(**kwargs)
    else:
        raise NotImplementedError(f"discriminator arch: {arch!r}")
    return D.to(device)
