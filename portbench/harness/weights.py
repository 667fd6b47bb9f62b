"""Seeded weights, made on the device from the benchmark's seed in a few large draws.

Every parameter of the configuration's G and D (enumerated on the reference's modules,
built on the meta device) takes one slice of one normal draw a network: a weight of
ndim >= 2 N(0, 1 / lr_mul^2), the equalized-learning-rate convention its module scales at
run time; a bias or any other vector N(0, BIAS_STD^2), so that biases are not all zero as a
trained model's are not. Buffers: each Fourier feature's random bank (frequencies uniform
over its band along H and on its power-of-two lattice along W, phases uniform), ema_var 1,
w_avg 0. The state dicts are keyed as the program's and the reference's modules are."""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from ..reference.models import build_discriminator, build_generator
from ..reference.ops import FourierFeature
from ..reference.stream import mix_seed

BIAS_STD = 0.1


def _owner_lr_mul(net: nn.Module) -> Dict[str, float]:
    out = {}
    for mname, mod in net.named_modules():
        for pname, _ in mod.named_parameters(recurse=False):
            out[f"{mname}.{pname}" if mname else pname] = float(getattr(mod, "lr_mul", 1.0))
    return out


def _params(net: nn.Module, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    named = list(net.named_parameters())
    total = sum(p.numel() for _, p in named)
    flat = torch.randn(total, generator=gen, device=device)
    lr_mul = _owner_lr_mul(net)
    out, o = {}, 0
    for name, p in named:
        v = flat[o:o + p.numel()].reshape(p.shape)
        o += p.numel()
        out[name] = v * (1.0 / lr_mul[name] if p.ndim >= 2 else BIAS_STD)
    return out


def _buffers(net: nn.Module, gen: torch.Generator, device) -> Dict[str, torch.Tensor]:
    out = {}
    for mname, mod in net.named_modules():
        prefix = f"{mname}." if mname else ""
        if isinstance(mod, FourierFeature):
            n = mod.freqs.shape[0]
            band_h = 2.0 ** (mod.L_h - 1)
            lattice = torch.tensor([-(2.0 ** k) for k in range(mod.L_w)] + [0.0] + [2.0 ** k for k in range(mod.L_w)],
                                   device=device)
            u = torch.rand(3, n, generator=gen, device=device)
            pick = torch.clamp((u[1] * len(lattice)).long(), max=len(lattice) - 1)
            out[prefix + "freqs"] = torch.stack([(2 * u[0] - 1) * band_h, lattice[pick]], dim=1)
            out[prefix + "phase"] = u[2] * (2 * math.pi)
        for bname, b in mod.named_buffers(recurse=False):
            key = prefix + bname
            if key not in out:
                out[key] = torch.ones(b.shape, device=device) if bname == "ema_var" else torch.zeros(b.shape, device=device)
    return out


def seeded_weights(model_cfg: Dict, seed: int, device, salt: int = 0) -> Dict[str, Dict[str, torch.Tensor]]:
    """{"G": state dict, "D": state dict} for the configuration's model section."""
    device = torch.device(device)
    with torch.device("meta"):
        G = build_generator(model_cfg["generator"], "meta")
        D = build_discriminator(model_cfg["discriminator"], "meta")
    out = {}
    for k, (net, tag) in {"G": (G, 1), "D": (D, 2)}.items():
        gen = torch.Generator(device=device).manual_seed(mix_seed(seed, salt, tag))
        sd = _params(net, gen, device)
        sd.update(_buffers(net, gen, device))
        missing = set(net.state_dict()) - set(sd)
        if missing:
            raise KeyError(f"seeded weights miss {sorted(missing)[:4]}")
        out[k] = {name: sd[name] for name in net.state_dict()}
    return out
