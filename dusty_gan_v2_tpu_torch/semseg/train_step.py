"""One SqueezeSeg training step, and the semseg checkpoint.

Counterpart of the step inside train_semseg.py (its `step_fn`, `loss_of`, optax chain
and `confusion_device`): the model in train mode (BatchNorm updating
its running statistics, Dropout2d in the head), the configured loss (focal or CE,
class-weighted, masked mean, times cls_loss_coef), and the update of optax's chain

    clip_by_global_norm(max_grad_norm) -> add_decayed_weights(weight_decay)
    -> sgd(lr * lr_decay ** floor((step - 1) / lr_decay_steps), momentum)

over every parameter (no mask: BN affines, biases, the transposed convs' weights and the
CRF's three parameters included). optax clips as g / |g| * max_norm when |g| >= max_norm
(torch's clip_grad_norm_ divides by |g| + 1e-6), so the clip is written out; the rest of
the chain is torch.optim.SGD(momentum, weight_decay) with the lr set every step.
Schedules count 1-based steps: optax's update count is step - 1.

The head's Dropout2d draws from a generator seeded with fold_seed(seed, step), so that a
step's draws do not depend on the steps before it; `keep` injects the masks instead.

Data parallel (a process group bound, parallel/mesh.py), each rank steps on its rows of
the global batch as the JAX step does on its shard: BatchNorm takes the global moments,
the masked loss divides by the ranks' mean mask sum, the gradients are averaged over the
ranks before the clip, the running statistics are averaged after the forward, the loss
is averaged and the confusion counts summed. Two processes on halves of a global batch
take the one-process step.

The checkpoint holds what the JAX CLI's msgpack holds: the config (as JSON text), the
step, the parameters and the BatchNorm statistics (as {dotted name: tensor}); no
optimizer state, so there is no resume, as in the JAX CLI.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import torch

from ..convert import flatten_variables, flax_msgpack
from ..convert.torch_weights import convert_squeezeseg_state, load_reference_state
from ..parallel import fold_seed, is_chief
from ..parallel.mesh import barrier, pmean_, pmean_flat_, psum_
from ..training.checkpoint import checkpoint_format
from ..utils.config import Config
from .loss import cross_entropy, focal_loss, masked_seg_loss

__all__ = ["SemsegTrainer", "confusion_device", "save_checkpoint", "load_checkpoint", "load_model_state"]


def confusion_device(label: torch.Tensor, pred: torch.Tensor, num_classes: int) -> torch.Tensor:
    """(3, C) int64 [tp, fp, fn] per class of integer label / pred maps, on their device.
    A value outside [0, C) counts for no class, as a one-hot of it is all zeros."""
    classes = torch.arange(num_classes, device=label.device)
    P = pred.reshape(-1, 1) == classes
    L = label.reshape(-1, 1) == classes
    tp = (P & L).sum(0)
    return torch.stack([tp, P.sum(0) - tp, L.sum(0) - tp])


class SemsegTrainer:
    """The model on `device`, its SGD chain and schedule; `step(batch, step)` trains once.

    A batch is a dict of device tensors: "xyz" (B,3,H,W), "mask" (B,H,W), "label" (B,H,W)
    and every other modality of cfg.arch.inputs, in any dtype (float16 / uint8 uploads
    are restored here)."""

    def __init__(self, model: torch.nn.Module, cfg, device):
        self.device = torch.device(device)
        self.model = model.to(self.device)
        t = cfg.training
        self.base_lr, self.lr_decay = float(t.lr), float(t.lr_decay)
        self.lr_decay_steps = int(t.lr_decay_steps)
        self.max_grad_norm = float(t.max_grad_norm)
        self.seed = int(cfg.random_seed)
        self.modalities = tuple(cfg.arch.inputs)
        self.num_classes = int(cfg.dataset.num_classes)
        self.loss_name = cfg.loss.name
        self.cls_weight = torch.tensor(list(cfg.loss.cls_weight), dtype=torch.float32, device=self.device)
        self.gamma = float(cfg.loss.get("focal_gamma", 2.0))
        self.coef = float(cfg.loss.cls_loss_coef)
        self.params = list(self.model.parameters())
        self.opt = torch.optim.SGD(self.params, lr=self.base_lr, momentum=float(t.lr_momentum),
                                   weight_decay=float(t.weight_decay))

    def lr(self, step: int) -> float:
        """The learning rate of 1-based step `step` (optax's staircase exponential decay)."""
        return self.base_lr * self.lr_decay ** ((step - 1) // self.lr_decay_steps)

    def unpack(self, batch: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
        """(inputs, xyz, mask, label): the modalities concatenated in float32, the mask in
        float32, the label as int64."""
        inputs = torch.cat([(t if t.dim() == 4 else t[:, None]).float() for t in (batch[m] for m in self.modalities)],
                           dim=1)
        return inputs, batch["xyz"].float(), batch["mask"].float(), batch["label"].long()

    def loss_of(self, logit, label, mask) -> torch.Tensor:
        if self.loss_name == "focal_loss":
            pl = focal_loss(logit, label, self.gamma, self.cls_weight)
        else:
            pl = cross_entropy(logit, label, self.cls_weight)
        return masked_seg_loss(pl, mask) * self.coef

    def forward_backward(self, batch, step: int, keep: Optional[torch.Tensor] = None):
        """Train-mode forward (running statistics updated) and backward into each
        parameter's .grad, both averaged over the ranks; returns (this rank's loss,
        logit), detached."""
        inputs, xyz, mask, label = self.unpack(batch)
        gen = None if keep is not None else torch.Generator(self.device).manual_seed(fold_seed(self.seed, step))
        self.opt.zero_grad(set_to_none=True)
        logit = self.model(inputs, xyz, mask, train=True, keep=keep, generator=gen)
        loss = self.loss_of(logit, label, mask)
        loss.backward()
        pmean_flat_([p.grad for p in self.params if p.grad is not None])
        pmean_flat_([b for n, b in self.model.named_buffers() if n.endswith(("running_mean", "running_var"))])
        return loss.detach(), logit.detach()

    def clip_grads(self) -> torch.Tensor:
        """optax.clip_by_global_norm on the .grads in place; returns the global norm. The
        choice stays on the device (no host sync)."""
        grads = [p.grad for p in self.params]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        below = norm < self.max_grad_norm
        one = torch.ones((), dtype=norm.dtype, device=norm.device)
        torch._foreach_div_(grads, torch.where(below, one, norm))
        torch._foreach_mul_(grads, torch.where(below, one, one * self.max_grad_norm))
        return norm

    def update(self, step: int) -> None:
        self.clip_grads()
        for group in self.opt.param_groups:
            group["lr"] = self.lr(step)
        self.opt.step()

    def step(self, batch, step: int, keep: Optional[torch.Tensor] = None) -> Dict[str, torch.Tensor]:
        """One training step; returns {"loss": 0-dim, "conf": (3, C) int64 [tp, fp, fn] of
        the step's predictions on the masked pixels}, on the device: the ranks' mean loss
        and summed counts."""
        loss, logit = self.forward_backward(batch, step, keep)
        self.update(step)
        mask, label = batch["mask"].float(), batch["label"].long()
        conf = confusion_device((label * mask).long(), (logit.argmax(1) * mask).long(), self.num_classes)
        return {"loss": pmean_(loss.clone()), "conf": psum_(conf)}


def _split_state(model: torch.nn.Module):
    names = {n for n, _ in model.named_parameters()}
    sd = {k: v.detach().cpu().clone() for k, v in model.state_dict().items()}
    return {k: v for k, v in sd.items() if k in names}, {k: v for k, v in sd.items() if k not in names}


def save_checkpoint(path: str, cfg, model: torch.nn.Module, step: int) -> None:
    """One torch.save file, written atomically by the chief (rank 0): {"cfg": JSON text,
    "step": int, "params": {name: tensor}, "batch_stats": {name: tensor}} (tensors on the
    CPU); then every rank of a bound process group waits at a barrier."""
    if is_chief():
        params, stats = _split_state(model)
        payload = {"cfg": json.dumps(cfg.to_dict() if isinstance(cfg, Config) else cfg), "step": int(step),
                   "params": params, "batch_stats": stats}
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        tmp = path + ".tmp"
        torch.save(payload, tmp)
        os.replace(tmp, path)
    barrier()


def load_checkpoint(path: str) -> Tuple[Config, Dict[str, Any]]:
    """(cfg, payload) of a file save_checkpoint wrote, of the JAX CLI's msgpack
    checkpoint (train_semseg.py: {"cfg_yaml": JSON text, "step", "params",
    "batch_stats"} as flax state dicts) or of a reference `.pth` ({"cfg", "model": a
    SqueezeSeg state_dict}, converted by convert/torch_weights.py for cfg.arch.name);
    tensors on the CPU, "params" and "batch_stats" flat state_dicts."""
    if path.endswith(".pth"):
        ckpt = load_reference_state(path)
        cfg = ckpt["cfg"]
        params, stats = convert_squeezeseg_state(ckpt["model"], cfg.arch.name)
        return cfg, {"params": params, "batch_stats": stats}
    if checkpoint_format(path) == "msgpack":
        payload = flax_msgpack.load(path)
        flat = lambda tree: dict(flatten_variables({"params": tree}))  # noqa: E731
        return Config(json.loads(payload["cfg_yaml"])), {
            "step": int(payload["step"]), "params": flat(payload["params"]), "batch_stats": flat(payload["batch_stats"])}
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return Config(json.loads(payload["cfg"])), payload


def load_model_state(model: torch.nn.Module, payload: Dict[str, Any]) -> torch.nn.Module:
    """Load a checkpoint payload's params and batch_stats into `model` (strict)."""
    model.load_state_dict({**payload["params"], **payload["batch_stats"]}, strict=True)
    return model
