"""The reference implementation's checkpoints -> the port's state_dicts (counterpart of
dusty_gan_v2_tpu/convert/torch_weights.py).

The released `.pth` files hold state_dicts of the reference modules (gans/models/*.py,
semseg/models/squeezeseg_v*.py). The port's modules carry the flax scope names, so each
reference key maps straight to a port path; the layout is the same but for a few
shapes: a modulated conv's weight drops its leading broadcast dim (1, O, I, k, k) ->
(O, I, k, k), its per-channel biases (1, O, 1, 1) become (O,), and a Fourier bank's
frequencies (F, 2, 1, 1) become (F, 2). A key that maps nowhere fails (as in the JAX
converter), except the reference's fixed resample kernels and constants.

`load_reference_checkpoint` reads a `.pth` with torch.load(weights_only=True): a config
pickled as an OmegaConf object cannot be read without omegaconf (the card's machine
has none), and such a file raises rather than being unpickled in full.

`reference_state_dict` is the inverse map, a port state_dict in the reference's keys and
shapes, which the checks use to build reference-layout files from seeded models.
"""

from __future__ import annotations

import pickle
import re
from typing import Any, Dict, Tuple

import torch

from ..utils.config import Config

__all__ = [
    "convert_generator_state", "convert_discriminator_state", "convert_squeezeseg_state",
    "load_reference_checkpoint", "load_reference_state", "reference_state_dict",
]

StateDict = Dict[str, torch.Tensor]


class _Map:
    """Takes reference keys into a port state_dict and remembers what it took."""

    def __init__(self, sd: Dict[str, Any]):
        self.sd, self.taken, self.out = sd, set(), {}

    def has(self, key: str) -> bool:
        return key in self.sd

    def put(self, port_key: str, ref_key: str, shape=None) -> None:
        self.taken.add(ref_key)
        v = torch.as_tensor(self.sd[ref_key]).detach().cpu()
        self.out[port_key] = (v if shape is None else v.reshape(shape)).clone()

    def keys_under(self, prefix: str):
        return sorted({k[len(prefix):].split(".")[0] for k in self.sd if k.startswith(prefix)})

    def done(self, what: str, ignore=()) -> StateDict:
        left = [k for k in self.sd if k not in self.taken and not any(t in k for t in ignore)]
        if left:
            raise KeyError(f"unconverted {what} keys: {left}")
        return self.out


def convert_generator_state(state_dict: Dict[str, Any], arch: str) -> StateDict:
    """A reference G state_dict -> the port generator's state_dict (dusty_v2, with or
    without noise injection; dusty_v1; vanilla)."""
    m = _Map(state_dict)
    if m.has("w_avg"):
        m.put("w_avg", "w_avg")
    if arch == "dusty_v2":
        # mapping network: Sequential[PixelNorm, Seq(EqualLR, LReLU), ...]
        d = 0
        while m.has(f"mapping_network.{d + 1}.0.module.weight"):
            for p in ("weight", "bias"):
                m.put(f"mapping_network.fc{d}.{p}", f"mapping_network.{d + 1}.0.module.{p}")
            d += 1
        for b in sorted({int(k.split(".")[2]) for k in state_dict if k.startswith("synthesis_network.layers.")}):
            pre, mine = f"synthesis_network.layers.{b}", f"synthesis_network.b{b}"
            if m.has(f"{pre}.pe.freqs"):
                m.put(f"{mine}.pe.freqs", f"{pre}.pe.freqs", (state_dict[f"{pre}.pe.freqs"].shape[0], -1))
                m.put(f"{mine}.pe.phase", f"{pre}.pe.phase")
            for conv in ("conv1", "conv2"):
                if not m.has(f"{pre}.{conv}.weight"):
                    continue
                m.put(f"{mine}.{conv}.weight", f"{pre}.{conv}.weight", state_dict[f"{pre}.{conv}.weight"].shape[1:])
                for p in ("weight", "bias"):
                    m.put(f"{mine}.{conv}.mod.{p}", f"{pre}.{conv}.mod.module.{p}")
                if m.has(f"{pre}.{conv}.bias"):
                    m.put(f"{mine}.{conv}.bias", f"{pre}.{conv}.bias", (-1,))
                if m.has(f"{pre}.{conv}.ema_var"):
                    m.put(f"{mine}.{conv}.ema_var", f"{pre}.{conv}.ema_var")
            for name in ("noise1", "noise2"):
                if m.has(f"{pre}.{name}.weight"):
                    m.put(f"{mine}.{name}.weight", f"{pre}.{name}.weight")
            for act in ("bias_act1", "bias_act2"):
                if m.has(f"{pre}.{act}.bias"):
                    m.put(f"{mine}.{act}.bias", f"{pre}.{act}.bias")
            for hn in m.keys_under(f"{pre}.head.heads."):
                hpre, hmine = f"{pre}.head.heads.{hn}", f"{mine}.head.{hn}"
                m.put(f"{hmine}.weight", f"{hpre}.weight", state_dict[f"{hpre}.weight"].shape[1:])
                if m.has(f"{hpre}.bias"):
                    m.put(f"{hmine}.bias", f"{hpre}.bias", (-1,))
                for p in ("weight", "bias"):
                    m.put(f"{hmine}.mod.{p}", f"{hpre}.mod.module.{p}")
                if m.has(f"{hpre}.ema_var"):
                    m.put(f"{hmine}.ema_var", f"{hpre}.ema_var")
    elif arch in ("vanilla", "dusty_v1"):
        # synthesis: Sequential[Projection, Up x3, Head]
        for i, name in ((0, "projection"), (1, "up1"), (2, "up2"), (3, "up3")):
            m.put(f"synthesis_network.{name}.conv.weight", f"synthesis_network.{i}.1.module.weight")
            m.put(f"synthesis_network.{name}.act.bias", f"synthesis_network.{i}.2.bias")
        for hn in m.keys_under("synthesis_network.4.heads."):
            for p in ("weight", "bias"):
                m.put(f"synthesis_network.head.{hn}.{p}", f"synthesis_network.4.heads.{hn}.1.module.{p}")
    else:
        raise NotImplementedError(arch)
    return m.done("generator", ignore=("resample.kernel", "downsample.kernel", "raydrop_const", "kernel"))


def convert_discriminator_state(state_dict: Dict[str, Any], arch: str) -> StateDict:
    """A reference D state_dict -> the port discriminator's state_dict (dusty_v2, vanilla)."""
    m = _Map(state_dict)
    if arch == "dusty_v2":
        m.put("stem.conv.weight", "layers.1.0.module.weight")
        m.put("stem_act.bias", "layers.2.bias")
        res_ids = sorted({int(k.split(".")[1]) for k in state_dict if k.startswith("layers.") and ".conv1." in k})
        for j, tid in enumerate(res_ids):
            pre = f"layers.{tid}"
            for conv, ref in (("conv1", "conv1.1"), ("conv2", "conv2.1"), ("skip", "skip.0")):
                m.put(f"res{j}.{conv}.conv.weight", f"{pre}.{ref}.module.weight")
            for act in ("bias_act1", "bias_act2"):
                m.put(f"res{j}.{act}.bias", f"{pre}.{act}.bias")
        m.put("epi_conv.conv.weight", "epilogue.1.1.module.weight")
        m.put("epi_act1.bias", "epilogue.2.bias")
        m.put("fc1.weight", "epilogue.4.module.weight")
        m.put("epi_act2.bias", "epilogue.5.bias")
        m.put("fc2.weight", "epilogue.6.module.weight")
        m.put("fc2.bias", "epilogue.6.module.bias")
    elif arch == "vanilla":
        for i, name in ((1, "down1"), (2, "down2"), (3, "down3"), (4, "down4")):
            m.put(f"{name}.conv.weight", f"{i}.1.module.weight")
            m.put(f"{name}.act.bias", f"{i}.2.bias")
        m.put("final.weight", "5.module.weight")
        m.put("final.bias", "5.module.bias")
    else:
        raise NotImplementedError(arch)
    return m.done("discriminator", ignore=("kernel",))


def convert_squeezeseg_state(state_dict: Dict[str, Any], arch: str = "squeezeseg_v2") -> Tuple[StateDict, StateDict]:
    """A reference SqueezeSeg state_dict -> (params, batch_stats) of the port model.

    V2 (squeezeseg_v2.py): encoder / decoder ModuleDicts of Sequential blocks,
    ConvReLUNorm = Sequential(conv, relu, bn), CAM.attn = Sequential(maxpool, conv, relu,
    conv, sigmoid). V1 (squeezeseg_v1.py): flat attributes, ConvReLU = Sequential(conv,
    relu), no BatchNorm (batch_stats comes back empty)."""
    if arch not in ("squeezeseg_v1", "squeezeseg_v2"):
        raise NotImplementedError(arch)
    v2 = arch == "squeezeseg_v2"
    m, stats = _Map(state_dict), {}

    def conv(ref, mine):
        for p in ("weight", "bias"):
            m.put(f"{mine}.conv.{p}", f"{ref}.0.{p}")
        if v2:
            for p in ("weight", "bias"):
                m.put(f"{mine}.bn.{p}", f"{ref}.2.{p}")
            for p in ("running_mean", "running_var"):
                m.put(f"{mine}.bn.{p}", f"{ref}.2.{p}")
                stats[f"{mine}.bn.{p}"] = m.out.pop(f"{mine}.bn.{p}")
            m.taken.add(f"{ref}.2.num_batches_tracked")

    def fire(ref, mine, up=False):
        for part in ("squeeze1x1", "expand1x1", "expand3x3"):
            conv(f"{ref}.{part}", f"{mine}.{part}")
        if up:
            for p in ("weight", "bias"):
                m.put(f"{mine}.upsample.{p}", f"{ref}.upsample.0.{p}")

    def cam(ref, mine):
        for fc, i in (("fc1", 1), ("fc2", 3)):
            for p in ("weight", "bias"):
                m.put(f"{mine}.{fc}.{p}", f"{ref}.attn.{i}.{p}")

    if v2:
        conv("encoder.conv_1a.0", "conv1a")
        cam("encoder.conv_1a.1", "cam1")
        conv("encoder.conv_1b", "conv1b")
        fire("encoder.fire_2_3.1", "fire2")
        cam("encoder.fire_2_3.2", "cam2")
        fire("encoder.fire_2_3.3", "fire3")
        cam("encoder.fire_2_3.4", "cam3")
        fire("encoder.fire_4_5.1", "fire4")
        fire("encoder.fire_4_5.2", "fire5")
        for i in range(1, 5):
            fire(f"encoder.fire_6_9.{i}", f"fire{i + 5}")
        for i in range(10, 14):
            fire(f"decoder.fire_{i}", f"fire{i}", up=True)
        head = "decoder.head.1"
    else:
        conv("conv1a", "conv1a")
        conv("conv1b", "conv1b")
        fire("fire2_3.1", "fire2")
        fire("fire2_3.2", "fire3")
        fire("fire4_5.1", "fire4")
        fire("fire4_5.2", "fire5")
        for i in range(1, 5):
            fire(f"fire6_9.{i}", f"fire{i + 5}")
        for i in range(10, 14):
            fire(f"fire{i}", f"fire{i}", up=True)
        head = "head.1"
    for p in ("weight", "bias"):
        m.put(f"head.{p}", f"{head}.{p}")
    if m.has("crf.weight_appearance"):
        m.put("crf.weight_appearance", "crf.weight_appearance")
        m.put("crf.weight_smoothness", "crf.weight_smoothness")
        m.put("crf.label_compatibility", "crf.label_compatibility.weight")
    params = m.done(arch, ignore=("num_batches_tracked", "theta_", "kernel_gamma", "kernel_alpha"))
    return params, stats


def load_reference_state(path: str) -> Dict[str, Any]:
    """torch.load of a reference `.pth` on the CPU, weights only, with its config as a
    Config. A config pickled as an OmegaConf object raises ValueError."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError as e:  # weights_only refuses the class
        if "omegaconf" in str(e).lower():
            raise ValueError(
                f"{path}: its config is a pickled OmegaConf object, which cannot be read without omegaconf; "
                "save it again with the config as a plain dict (OmegaConf.to_container(cfg)) where omegaconf is "
                "installed") from e
        raise
    if not isinstance(ckpt, dict) or not isinstance(ckpt.get("cfg"), dict):
        raise ValueError(f"{path}: not a reference checkpoint (a dict with a dict 'cfg')")
    ckpt["cfg"] = Config(ckpt["cfg"])
    return ckpt


def load_reference_checkpoint(path: str) -> Dict[str, Any]:
    """A reference GAN `.pth` -> {"cfg": Config, "angle": (1, 2, H, W) float32 or None,
    "G", "G_ema", "D": the port's state_dicts (those the file holds)}."""
    ckpt = load_reference_state(path)
    cfg = ckpt["cfg"]
    out = {"cfg": cfg, "angle": None if ckpt.get("angle") is None else torch.as_tensor(ckpt["angle"]).float()}
    for key in ("G", "G_ema"):
        if key in ckpt:
            out[key] = convert_generator_state(ckpt[key], cfg.model.generator.arch)
    if "D" in ckpt:
        out["D"] = convert_discriminator_state(ckpt["D"], cfg.model.discriminator.arch)
    return out


# ------------------------------------------------------------------ the inverse map
_mod = lambda v: v[None]  # noqa: E731  (O, I, k, k) -> (1, O, I, k, k)
_chan = lambda v: v.reshape(1, -1, 1, 1)  # noqa: E731
_bank = lambda v: v.reshape(*v.shape, 1, 1)  # noqa: E731
_INVERSE = {
    ("G", "dusty_v2"): [
        (r"mapping_network\.fc(\d+)\.(weight|bias)", lambda m: f"mapping_network.{int(m[1]) + 1}.0.module.{m[2]}", None),
        (r"synthesis_network\.b(\d+)\.pe\.freqs", r"synthesis_network.layers.\1.pe.freqs", _bank),
        (r"synthesis_network\.b(\d+)\.(conv\d)\.weight", r"synthesis_network.layers.\1.\2.weight", _mod),
        (r"synthesis_network\.b(\d+)\.(conv\d)\.bias", r"synthesis_network.layers.\1.\2.bias", _chan),
        (r"synthesis_network\.b(\d+)\.(conv\d)\.mod\.(weight|bias)", r"synthesis_network.layers.\1.\2.mod.module.\3", None),
        (r"synthesis_network\.b(\d+)\.head\.(\w+)\.weight", r"synthesis_network.layers.\1.head.heads.\2.weight", _mod),
        (r"synthesis_network\.b(\d+)\.head\.(\w+)\.bias", r"synthesis_network.layers.\1.head.heads.\2.bias", _chan),
        (r"synthesis_network\.b(\d+)\.head\.(\w+)\.mod\.(weight|bias)",
         r"synthesis_network.layers.\1.head.heads.\2.mod.module.\3", None),
        (r"synthesis_network\.b(\d+)\.head\.(\w+)\.ema_var", r"synthesis_network.layers.\1.head.heads.\2.ema_var", None),
        (r"synthesis_network\.b(\d+)\.(.+)", r"synthesis_network.layers.\1.\2", None),
        (r"w_avg", "w_avg", None),
    ],
    ("G", "vanilla"): [
        (r"synthesis_network\.(projection|up1|up2|up3)\.conv\.weight",
         lambda m: f"synthesis_network.{_STAGES.index(m[1])}.1.module.weight", None),
        (r"synthesis_network\.(projection|up1|up2|up3)\.act\.bias",
         lambda m: f"synthesis_network.{_STAGES.index(m[1])}.2.bias", None),
        (r"synthesis_network\.head\.(\w+)\.(weight|bias)", r"synthesis_network.4.heads.\1.1.module.\2", None),
        (r"w_avg", "w_avg", None),
    ],
    ("D", "dusty_v2"): [
        (r"stem\.conv\.weight", "layers.1.0.module.weight", None),
        (r"stem_act\.bias", "layers.2.bias", None),
        (r"res(\d+)\.(conv1|conv2)\.conv\.weight", lambda m: f"layers.{int(m[1]) + 3}.{m[2]}.1.module.weight", None),
        (r"res(\d+)\.skip\.conv\.weight", lambda m: f"layers.{int(m[1]) + 3}.skip.0.module.weight", None),
        (r"res(\d+)\.(bias_act\d)\.bias", lambda m: f"layers.{int(m[1]) + 3}.{m[2]}.bias", None),
        (r"epi_conv\.conv\.weight", "epilogue.1.1.module.weight", None),
        (r"epi_act1\.bias", "epilogue.2.bias", None),
        (r"fc1\.weight", "epilogue.4.module.weight", None),
        (r"epi_act2\.bias", "epilogue.5.bias", None),
        (r"fc2\.(weight|bias)", r"epilogue.6.module.\1", None),
    ],
    ("D", "vanilla"): [
        (r"down(\d)\.conv\.weight", r"\1.1.module.weight", None),
        (r"down(\d)\.act\.bias", r"\1.2.bias", None),
        (r"final\.(weight|bias)", r"5.module.\1", None),
    ],
}
_INVERSE[("G", "dusty_v1")] = _INVERSE[("G", "vanilla")]
_STAGES = ("projection", "up1", "up2", "up3")
# SqueezeSeg: the port's module -> the reference's Sequential (ConvReLU(Norm) = (conv, relu[, bn]))
_SQUEEZESEG = {
    "squeezeseg_v2": {"conv1a": "encoder.conv_1a.0", "cam1": "encoder.conv_1a.1", "conv1b": "encoder.conv_1b",
                      "fire2": "encoder.fire_2_3.1", "cam2": "encoder.fire_2_3.2", "fire3": "encoder.fire_2_3.3",
                      "cam3": "encoder.fire_2_3.4", "fire4": "encoder.fire_4_5.1", "fire5": "encoder.fire_4_5.2",
                      **{f"fire{i}": f"encoder.fire_6_9.{i - 5}" for i in range(6, 10)},
                      **{f"fire{i}": f"decoder.fire_{i}" for i in range(10, 14)}, "head": "decoder.head.1"},
    "squeezeseg_v1": {"conv1a": "conv1a", "conv1b": "conv1b", "fire2": "fire2_3.1", "fire3": "fire2_3.2",
                      "fire4": "fire4_5.1", "fire5": "fire4_5.2", **{f"fire{i}": f"fire6_9.{i - 5}" for i in range(6, 10)},
                      **{f"fire{i}": f"fire{i}" for i in range(10, 14)}, "head": "head.1"},
}
_SQUEEZESEG_PARTS = [(r"(^|\.)conv\.", r"\g<1>0."), (r"(^|\.)bn\.", r"\g<1>2."), (r"^upsample\.", "upsample.0."),
                     (r"^fc1\.", "attn.1."), (r"^fc2\.", "attn.3.")]


def reference_state_dict(state_dict: Dict[str, torch.Tensor], kind: str, arch: str) -> StateDict:
    """The inverse of convert_generator_state ("G"), convert_discriminator_state ("D") and
    convert_squeezeseg_state ("squeezeseg", params and batch_stats in one dict): a port
    state_dict in the reference's keys and shapes (a SqueezeSegV2's BatchNorms get their
    num_batches_tracked back)."""
    out = {}
    for key, v in state_dict.items():
        v = v.detach().cpu().clone()
        if kind == "squeezeseg":
            if key.startswith("crf."):
                out[key + (".weight" if key == "crf.label_compatibility" else "")] = v
                continue
            mod, rest = key.split(".", 1)
            for pat, rep in _SQUEEZESEG_PARTS:
                rest = re.sub(pat, rep, rest)
            ref = f"{_SQUEEZESEG[arch][mod]}.{rest}"
            out[ref] = v
            if ref.endswith(".2.running_mean"):
                out[ref.replace("running_mean", "num_batches_tracked")] = torch.tensor(0)
            continue
        for pat, rep, reshape in _INVERSE[(kind, arch)]:
            m = re.fullmatch(pat, key)
            if m:
                out[rep(m) if callable(rep) else m.expand(rep)] = v if reshape is None else reshape(v)
                break
        else:
            raise KeyError(f"{kind} {arch}: no reference key for {key}")
    return out
