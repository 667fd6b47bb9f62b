"""Single-file checkpoints of the training state (counterpart of the msgpack route of
dusty_gan_v2_tpu/training/checkpoint.py). `load_checkpoint` reads the port's files and
the JAX CLI's, telling them apart by their first bytes (`checkpoint_format`).

One file written by torch.save, atomically (a temporary file, then os.replace):

    {"cfg": the config as JSON text, "step": images seen, "angle": (1, 2, H, W) float32,
     "state": {"G", "G_ema", "D": state_dicts,
               "opt_G", "opt_D": {parameter index: {"step", "exp_avg", "exp_avg_sq"}},
               "ada": {"p", "sign_cum", "n_pred_cum"}, "pl_ema": 0-dim tensor,
               "iteration": iterations completed}}

It holds only dicts, tensors (on the CPU), strs and ints, so torch.load(weights_only=True)
reads it. Adam's hyperparameters are not stored: they follow from the config when the
Trainer is built. Under data parallelism every rank holds the same state: the chief
writes the file, then every rank passes a barrier, and every rank loads it.

The JAX CLI's file is flax msgpack (convert/flax_msgpack.py):

    {"cfg_yaml": the config as YAML text, "step": images seen (int64 scalar),
     "angle": (1, 2, H, W) float32, "state": flax's state dict of a GANTrainState}

Read without a template, its "state" comes back as G, G_ema and D state_dicts with the
ADA state, pl_ema and the iteration (the port's payload without the optimizers); with a
template, convert/jax_variables.py::load_jax_train_state carries everything over, Adam's
moments included, so train_gan --resume continues a JAX run. `save_jax_checkpoint`
writes that format.

The JAX CLI's --ckpt_backend orbax writes a directory instead:

    <path>/state/        an orbax item of the same flax state dict (convert/orbax.py: zarr v2
                         arrays in an OCDBT database, read and written by the port's own
                         zstd, OCDBT and zarr code)
    <path>/meta.msgpack  {"cfg_yaml", "step", "angle"} in flax msgpack

`load_checkpoint` sends a directory to `load_checkpoint_orbax`, which returns what the
msgpack file of the same state gives. `save_checkpoint_orbax` writes one: the state is
copied to CPU tensors before the call returns, and with use_async one background thread
writes `<path>.tmp/` and renames it to `<path>` when whole. A failed write raises at
`wait_for_checkpoints()` or at the next save. Under data parallelism the chief writes,
and every rank passes a barrier in `wait_for_checkpoints()` (at once, without use_async).
"""

from __future__ import annotations

import json
import os
import shutil
import time
from concurrent.futures import Future, ThreadPoolExecutor
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import yaml

from ..augment.ada import AdaState
from ..convert import flax_msgpack, orbax
from ..convert.jax_variables import jax_train_state_dict, jax_variables_to_state_dict, load_jax_train_state
from ..parallel.mesh import barrier, is_chief
from ..utils.config import Config
from .train_state import TrainState

__all__ = [
    "save_checkpoint", "load_checkpoint", "state_payload", "load_state_payload", "checkpoint_format",
    "save_jax_checkpoint", "save_checkpoint_orbax", "load_checkpoint_orbax", "wait_for_checkpoints", "ORBAX_WRITES",
]

_ADA_FIELDS = ("p", "sign_cum", "n_pred_cum")


def _cpu(sd: Dict[str, Any]) -> Dict[str, Any]:
    """A copy of a nested dict with every tensor copied once to the CPU."""
    return {k: (_cpu(v) if isinstance(v, dict) else v.detach().to("cpu", copy=True) if torch.is_tensor(v) else v)
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


def checkpoint_format(path: str) -> str:
    """"orbax" for a directory, "torch" for a torch.save file (a zip archive, or a legacy
    pickle), "msgpack" for a flax msgpack file (a map at the top); else ValueError."""
    if os.path.isdir(path):
        return "orbax"
    with open(path, "rb") as f:
        head = f.read(4)
    if head.startswith(b"PK\x03\x04") or (len(head) > 1 and head[0] == 0x80 and 2 <= head[1] <= 5):
        return "torch"
    if head and (0x81 <= head[0] <= 0x8F or head[0] in (0xDE, 0xDF)):
        return "msgpack"
    raise ValueError(f"{path}: neither a torch.save file nor a flax msgpack file (first bytes {head!r})")


def _jax_payload_state(js: Dict[str, Any]) -> Dict[str, Any]:
    """A JAX state dict as the port's payload, without the optimizers."""
    return {
        "G": jax_variables_to_state_dict({"params": js["params_G"], "stats": js["stats_G"], "consts": js["consts_G"]}),
        "G_ema": jax_variables_to_state_dict(
            {"params": js["params_G_ema"], "stats": js["stats_G_ema"], "consts": js["consts_G"]}),
        "D": jax_variables_to_state_dict({"params": js["params_D"]}),
        "ada": {f: js["ada"][f].float().reshape(()) for f in _ADA_FIELDS},
        "pl_ema": js["pl_ema"].float().reshape(()),
        "iteration": int(js["step"]),
    }


def load_checkpoint(path: str, state_template: Optional[TrainState] = None) -> Tuple[Config, Any, torch.Tensor, int]:
    """(cfg, state, angle, num_imgs) of a port or JAX CLI checkpoint file. With a
    template the state is loaded into it (and returned); else `state` is the file's
    state dict, on the CPU (a JAX file's without the optimizers). A directory is an orbax
    checkpoint (load_checkpoint_orbax)."""
    fmt = checkpoint_format(path)
    if fmt == "orbax":
        return load_checkpoint_orbax(path, state_template)
    if fmt == "msgpack":
        payload = flax_msgpack.load(path)
        if "cfg_yaml" not in payload or "state" not in payload:
            raise ValueError(f"{path}: a msgpack file without cfg_yaml and state is not a GAN checkpoint")
        return _jax_checkpoint(payload, payload["state"], state_template)
    payload = torch.load(path, map_location="cpu", weights_only=True)
    cfg = Config(json.loads(payload["cfg"]))
    state = payload["state"]
    if state_template is not None:
        state = load_state_payload(state_template, state)
    return cfg, state, payload["angle"], int(payload["step"])


def _jax_checkpoint(meta: Dict[str, Any], js: Dict[str, Any], state_template):
    cfg = Config(yaml.safe_load(meta["cfg_yaml"]))
    state = _jax_payload_state(js) if state_template is None else load_jax_train_state(state_template, js)
    return cfg, state, meta["angle"].float(), int(meta["step"])


def save_jax_checkpoint(path: str, cfg, state: TrainState, angle: torch.Tensor, num_imgs: int) -> None:
    """Write the JAX CLI's single-file format (dusty_gan_v2_tpu/training/checkpoint.py::
    save_checkpoint), which its load_checkpoint and this module's read; on the chief,
    atomically, then a barrier as save_checkpoint."""
    if is_chief():
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        payload = {
            "cfg_yaml": yaml.safe_dump(cfg.to_dict() if isinstance(cfg, Config) else cfg),
            "step": np.int64(num_imgs),
            "angle": angle.detach().cpu(),
            "state": jax_train_state_dict(state),
        }
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            flax_msgpack.dump(payload, f)
        os.replace(tmp, path)
    barrier()


# ------------------------------------------------------------------ orbax directories
_WRITER = ThreadPoolExecutor(1, thread_name_prefix="orbax-writer")  # starts its thread at the first save
_pending: List[Future] = []
# one record a directory written: {"path", "snapshot_s" (the caller's time in the save),
# "write_s" (the writer's time), "bytes"}
ORBAX_WRITES: List[Dict[str, Any]] = []


def _write_orbax(path: Path, tree: Dict[str, Any], meta: Dict[str, Any], record: Dict[str, Any]) -> None:
    t0 = time.perf_counter()
    tmp = path.with_name(path.name + ".tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    orbax.write_item(tmp / "state", tree)
    with open(tmp / "meta.msgpack", "wb") as f:
        flax_msgpack.dump(meta, f)
    if path.exists():  # the JAX CLI's save overwrites (force=True)
        shutil.rmtree(path)
    os.replace(tmp, path)
    record["write_s"] = time.perf_counter() - t0
    record["bytes"] = sum(p.stat().st_size for p in path.rglob("*") if p.is_file())


def _raise_failed(wait: bool) -> None:
    """Re-raise the first failed write (waiting for every write first if `wait`)."""
    for fut in list(_pending):
        if wait or fut.done():
            _pending.remove(fut)
            fut.result()


def save_checkpoint_orbax(path: str, cfg, state: TrainState, angle: torch.Tensor, num_imgs: int,
                          use_async: bool = True) -> None:
    """Write the JAX CLI's orbax checkpoint directory (dusty_gan_v2_tpu/training/checkpoint.py::
    save_checkpoint_orbax): `<path>/state` and `<path>/meta.msgpack`, on the chief. The
    state is copied to CPU tensors before the call returns; with use_async the write runs
    on one background thread (wait_for_checkpoints() joins it), else here, followed by a
    barrier. An earlier write's error is raised here."""
    _raise_failed(wait=False)
    if is_chief():
        t0 = time.perf_counter()
        tree = _cpu(jax_train_state_dict(state))
        meta = {"cfg_yaml": yaml.safe_dump(cfg.to_dict() if isinstance(cfg, Config) else cfg),
                "step": np.int64(num_imgs), "angle": angle.detach().cpu().clone()}
        record = {"path": str(path), "snapshot_s": time.perf_counter() - t0}
        ORBAX_WRITES.append(record)
        if use_async:
            _pending.append(_WRITER.submit(_write_orbax, Path(path).absolute(), tree, meta, record))
        else:
            _write_orbax(Path(path).absolute(), tree, meta, record)
    if not use_async:
        barrier()


def wait_for_checkpoints() -> None:
    """Block until every background write has finished, raising the first one's error;
    then every rank of a bound process group passes a barrier."""
    _raise_failed(wait=True)
    barrier()


def load_checkpoint_orbax(path: str, state_template: Optional[TrainState] = None):
    """(cfg, state, angle, num_imgs) of an orbax checkpoint directory, as load_checkpoint
    returns them for the msgpack file of the same state."""
    root = Path(path)
    for part in ("meta.msgpack", "state"):
        if not (root / part).exists():
            raise ValueError(f"{path}: an orbax checkpoint directory holds {part}; this one does not")
    meta = flax_msgpack.load(str(root / "meta.msgpack"))
    return _jax_checkpoint(meta, orbax.read_item(root / "state"), state_template)
