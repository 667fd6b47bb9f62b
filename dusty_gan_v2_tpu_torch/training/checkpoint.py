"""Single-file checkpoints of the training state (counterpart of the msgpack route of
dusty_gan_v2_tpu/training/checkpoint.py).

One file written by torch.save, atomically (a temporary file, then os.replace):

    {"cfg": the config as JSON text, "step": images seen, "angle": (1, 2, H, W) float32,
     "state": {"G", "G_ema", "D": state_dicts,
               "opt_G", "opt_D": {parameter index: {"step", "exp_avg", "exp_avg_sq"}},
               "ada": {"p", "sign_cum", "n_pred_cum"}, "pl_ema": 0-dim tensor,
               "iteration": iterations completed}}

It holds only dicts, tensors (on the CPU), strs and ints, so torch.load(weights_only=True)
reads it. Adam's hyperparameters are not stored: they follow from the config when the
Trainer is built. Under data parallelism every rank holds the same state: the chief
writes the file, then every rank passes a barrier, and every rank loads it. Orbax's
sharded directories (the JAX CLI's --ckpt_backend orbax) are not ported.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from ..augment.ada import AdaState
from ..parallel.mesh import barrier, is_chief
from ..utils.config import Config
from .train_state import TrainState

__all__ = ["save_checkpoint", "load_checkpoint", "state_payload", "load_state_payload"]

_ADA_FIELDS = ("p", "sign_cum", "n_pred_cum")


def _cpu(sd: Dict[str, Any]) -> Dict[str, Any]:
    return {k: (_cpu(v) if isinstance(v, dict) else v.detach().cpu().clone() if torch.is_tensor(v) else v)
            for k, v in sd.items()}


def state_payload(state: TrainState) -> Dict[str, Any]:
    """The training state as dicts of CPU tensors and ints."""
    return {
        "G": _cpu(state.G.state_dict()),
        "G_ema": _cpu(state.G_ema.state_dict()),
        "D": _cpu(state.D.state_dict()),
        "opt_G": _cpu(state.opt_G.state_dict()["state"]),
        "opt_D": _cpu(state.opt_D.state_dict()["state"]),
        "ada": {f: getattr(state.ada, f).detach().cpu().clone() for f in _ADA_FIELDS},
        "pl_ema": state.pl_ema.detach().cpu().clone(),
        "iteration": int(state.step),
    }


def load_state_payload(state: TrainState, payload: Dict[str, Any]) -> TrainState:
    """Load a state_payload into a template TrainState in place (strict: a missing or
    extra key fails) and return it. Tensors move to the template's devices."""
    for name in ("G", "G_ema", "D"):
        getattr(state, name).load_state_dict(payload[name], strict=True)
    for name in ("opt_G", "opt_D"):
        opt = getattr(state, name)
        opt.load_state_dict({"state": payload[name], "param_groups": opt.state_dict()["param_groups"]})
    dev = state.pl_ema.device
    state.ada = AdaState(**{f: payload["ada"][f].to(dev) for f in _ADA_FIELDS})
    state.pl_ema = payload["pl_ema"].to(dev)
    state.step = int(payload["iteration"])
    return state


def save_checkpoint(path: str, cfg, state: TrainState, angle: torch.Tensor, num_imgs: int) -> None:
    """Write the file on the chief (rank 0); then every rank of a bound process group
    waits at a barrier, so that none reads a checkpoint before it is whole."""
    if is_chief():
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        payload = {
            "cfg": json.dumps(cfg.to_dict() if isinstance(cfg, Config) else cfg),
            "step": int(num_imgs),
            "angle": angle.detach().cpu().clone(),
            "state": state_payload(state),
        }
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
    barrier()


def load_checkpoint(path: str, state_template: Optional[TrainState] = None) -> Tuple[Config, Any, torch.Tensor, int]:
    """(cfg, state, angle, num_imgs). With a template the state is loaded into it (and
    returned); else `state` is the file's state dict, on the CPU."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    cfg = Config(json.loads(payload["cfg"]))
    state = payload["state"]
    if state_template is not None:
        state = load_state_payload(state_template, state)
    return cfg, state, payload["angle"], int(payload["step"])
