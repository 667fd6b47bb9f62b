"""Output-head activation by name (counterpart of dusty_gan_v2_tpu/models/heads.py)."""

from __future__ import annotations

import torch

__all__ = ["resolve_act"]


def _identity(x):
    return x


_ACTS = {
    None: _identity,
    "none": _identity,
    "identity": _identity,
    "nn.Identity": _identity,
    "tanh": torch.tanh,
    "nn.Tanh": torch.tanh,
    "sigmoid": torch.sigmoid,
    "nn.Sigmoid": torch.sigmoid,
}


def resolve_act(name):
    if callable(name):
        return name
    try:
        return _ACTS[name]
    except KeyError:
        raise ValueError(f"unknown head activation: {name!r}") from None
