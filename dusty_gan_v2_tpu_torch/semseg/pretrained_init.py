"""ImageNet-pretrained SqueezeNet v1.1 Fire weights for SqueezeSegV2's encoder.

Counterpart of dusty_gan_v2_tpu/semseg/pretrained_init.py, local files only: a joblib
pickle mapping "fire{k}/{layer}" -> (weight OIHW, bias) (k = 2..9, layer squeeze1x1 /
expand1x1 / expand3x3) is read from a given path or data/pretrained/squeezenet_v1.1.pkl
of the checkout, checked, and copied into the convolutions of the encoder's Fire
modules. Nothing is downloaded: a missing file raises FileNotFoundError, and the
training CLI then warns and trains from its own init.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "FIRE_NAMES",
    "FIRE_LAYERS",
    "squeezenet_fire_shapes",
    "load_squeezenet_v11",
    "apply_squeezenet_fire_weights",
]

# the encoder Fire modules that take pretrained weights
FIRE_NAMES = ("fire2", "fire3", "fire4", "fire5", "fire6", "fire7", "fire8", "fire9")
FIRE_LAYERS = ("squeeze1x1", "expand1x1", "expand3x3")

# (in_ch, s1x1, e1x1, e3x3) of each encoder Fire
_FIRE_DIMS = {
    "fire2": (64, 16, 64, 64),
    "fire3": (128, 16, 64, 64),
    "fire4": (128, 32, 128, 128),
    "fire5": (256, 32, 128, 128),
    "fire6": (256, 48, 192, 192),
    "fire7": (384, 48, 192, 192),
    "fire8": (384, 64, 256, 256),
    "fire9": (512, 64, 256, 256),
}


def squeezenet_fire_shapes() -> Dict[str, Tuple[Tuple[int, ...], Tuple[int, ...]]]:
    """The pickle's expected "fire/layer" -> (weight OIHW shape, bias shape)."""
    shapes = {}
    for fire, (in_ch, s, e1, e3) in _FIRE_DIMS.items():
        shapes[f"{fire}/squeeze1x1"] = ((s, in_ch, 1, 1), (s,))
        shapes[f"{fire}/expand1x1"] = ((e1, s, 1, 1), (e1,))
        shapes[f"{fire}/expand3x3"] = ((e3, s, 3, 3), (e3,))
    return shapes


def _default_path() -> Path:
    return Path(__file__).resolve().parents[2] / "data" / "pretrained" / "squeezenet_v1.1.pkl"


def load_squeezenet_v11(path: Optional[str] = None) -> Dict[str, tuple]:
    """The checked pickle at `path` (default: data/pretrained/squeezenet_v1.1.pkl).
    Raises FileNotFoundError when the file is not there."""
    file = Path(path) if path else _default_path()
    if not file.is_file():
        raise FileNotFoundError(f"SqueezeNet v1.1 weights not found at {file}")
    import joblib

    weights = joblib.load(file)
    _validate(weights)
    return weights


def _validate(weights: Dict[str, tuple]) -> None:
    for key, (w_shape, b_shape) in squeezenet_fire_shapes().items():
        if key not in weights:
            raise KeyError(f"pretrained pickle missing {key}")
        w, b = (np.asarray(a) for a in weights[key])
        if tuple(w.shape) != w_shape or tuple(b.shape) != b_shape:
            raise ValueError(f"{key}: got weight {w.shape} / bias {b.shape}, expected {w_shape} / {b_shape}")


def apply_squeezenet_fire_weights(model: torch.nn.Module, weights: Dict[str, tuple]) -> torch.nn.Module:
    """Copy the 8 encoder Fires' pretrained (weight, bias) pairs into `model`'s convs in
    place and return it. Only the conv of each ConvReLUNorm changes; BN keeps its init."""
    _validate(weights)
    with torch.no_grad():
        for fire in FIRE_NAMES:
            for layer in FIRE_LAYERS:
                conv = getattr(getattr(model, fire), layer).conv
                w, b = weights[f"{fire}/{layer}"]
                conv.weight.copy_(torch.as_tensor(np.asarray(w, np.float32)))
                conv.bias.copy_(torch.as_tensor(np.asarray(b, np.float32)))
    return model
