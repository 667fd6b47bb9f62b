"""Data parallelism: one process per card, joined by torch.distributed.

Counterpart of dusty_gan_v2_tpu/parallel/mesh.py and of the collectives of its
persample.py. The JAX package runs one program over a mesh whose "data" axis is bound
inside the train step's shard_map; here each process holds one card (NCCL) or one CPU
(gloo), and the port's modules reduce over the process group that `init_distributed`
binds. With no group bound every collective below is the identity, rank() is 0 and
world_size() is 1, so the same module code runs in one process, in tests and in
evaluation, as the JAX code does outside shard_map.

The collectives with gradients are autograd Functions of the port's own, with the JAX
package's transposes, so that each rank's backward computes its share of the gradient
of the SUM of the ranks' losses and a pmean of the ranks' gradients is the one-process
gradient of the global mean loss:

    axis_psum(x)        sum over ranks;  backward: psum of the cotangent
    axis_pmean(x)       mean over ranks; backward: pmean of the cotangent (the symmetric
                        VJP of dusty_gan_v2_tpu/parallel/persample.py::axis_pmean; a plain
                        transpose would drop the cross-rank term of a batch statistic)
    all_gather_rows(x)  the ranks' rows concatenated along dim 0 in rank order;
                        backward: psum of the cotangent, this rank's rows kept

Each backward is built of the differentiable collectives again, so a double backward
(R1 through the gathered minibatch-stddev) crosses ranks as the first one does.

A gloo group given CUDA tensors (two processes sharing one card) stages each collective
through host memory, as gloo's own CUDA paths do: a transport, not a fallback.
"""

from __future__ import annotations

import datetime
import os
from typing import Iterable, Optional

import torch
import torch.distributed as dist

__all__ = [
    "init_distributed", "shutdown", "bound", "rank", "world_size", "is_chief", "local_batch", "barrier",
    "axis_psum", "axis_pmean", "all_gather_rows", "psum_", "pmean_", "pmean_flat_", "pmean_grads_", "GRAD_LOG",
]

# the bound process group's rank, size, backend and device; bound is False with no group,
# owner when init_distributed created the group
_GROUP = {"bound": False, "rank": 0, "world": 1, "backend": None, "device": None, "owner": False}
# a list to time the gradient averages in while it is not None (pmean_flat_'s records)
GRAD_LOG: Optional[list] = None


def _address(coordinator: str) -> str:
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
    device="cuda",
    timeout: float = 600.0,
) -> torch.device:
    """Join the process group and bind it; returns this process's device.

    With `coordinator` ("host:port" or "tcp://host:port"), `num_processes` and
    `process_id` the rendezvous is that address; with none of them it is torchrun's
    environment (env://: MASTER_ADDR, MASTER_PORT, RANK, WORLD_SIZE), the counterpart
    of JAX's auto-detection. The backend is NCCL on a CUDA device and gloo on the CPU,
    unless `backend` names one (gloo for processes that share a card). The card is
    LOCAL_RANK's, else process_id % the number of cards. `timeout` (seconds) bounds the
    rendezvous and every collective. A group already initialized is bound as it is."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_distributed on a CUDA device, but torch.cuda.is_available() is false; "
                               "pass device='cpu' to join over gloo on the CPU")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device: {device}")
    given = [a is not None for a in (coordinator, num_processes, process_id)]
    if any(given) and not all(given):
        raise ValueError("give coordinator, num_processes and process_id together, or none of them (env://)")
    if not dist.is_initialized():
        backend = backend or ("nccl" if device.type == "cuda" else "gloo")
        kw = dict(backend=backend, timeout=datetime.timedelta(seconds=timeout))
        if coordinator is not None:
            kw.update(init_method=_address(coordinator), world_size=int(num_processes), rank=int(process_id))
        else:
            kw.update(init_method="env://")
        pid = int(process_id) if process_id is not None else int(os.environ.get("RANK", 0))
        if device.type == "cuda" and device.index is None:
            local_rank = os.environ.get("LOCAL_RANK")
            device = torch.device("cuda", int(local_rank) if local_rank is not None
                                  else pid % torch.cuda.device_count())
        if device.type == "cuda":
            torch.cuda.set_device(device)
            if backend == "nccl":
                kw["device_id"] = device
        dist.init_process_group(**kw)
        _GROUP["owner"] = True
    elif device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    _GROUP.update(bound=True, rank=dist.get_rank(), world=dist.get_world_size(), backend=dist.get_backend(),
                  device=device)
    return device


def shutdown() -> None:
    """Unbind the group, and destroy it if init_distributed created it."""
    if _GROUP["owner"] and dist.is_initialized():
        dist.destroy_process_group()
    _GROUP.update(bound=False, rank=0, world=1, backend=None, device=None, owner=False)


def bound() -> bool:
    """True while a process group is bound (the JAX package's axis_bound)."""
    return _GROUP["bound"]


def rank() -> int:
    return _GROUP["rank"] if _GROUP["bound"] else 0


def world_size() -> int:
    return _GROUP["world"] if _GROUP["bound"] else 1


def is_chief() -> bool:
    return rank() == 0


def local_batch(global_batch: int) -> int:
    """This rank's share of a global batch (the global batch with no group bound)."""
    n = world_size()
    assert global_batch % n == 0, f"batch {global_batch} not divisible by {n} processes"
    return global_batch // n


def barrier() -> None:
    if not bound():
        return
    if _GROUP["backend"] == "nccl":
        dist.barrier(device_ids=[_GROUP["device"].index])
    else:
        dist.barrier()


# ------------------------------------------------------------------ raw collectives
def _staged(t: torch.Tensor) -> bool:
    return t.is_cuda and _GROUP["backend"] == "gloo"


def psum_(t: torch.Tensor) -> torch.Tensor:
    """In-place sum over the ranks (no autograd); returns t."""
    if bound():
        if _staged(t):
            h = t.cpu()
            dist.all_reduce(h)
            t.copy_(h)
        else:
            dist.all_reduce(t)
    return t


def pmean_(t: torch.Tensor) -> torch.Tensor:
    """In-place mean over the ranks (no autograd); returns t."""
    if bound():
        psum_(t).div_(world_size())
    return t


def _gather(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    src = x.cpu() if _staged(x) else x
    parts = [torch.empty_like(src) for _ in range(world_size())]
    dist.all_gather(parts, src)
    return torch.cat(parts).to(x.device)


def pmean_flat_(tensors: Iterable[torch.Tensor], log: Optional[list] = None) -> None:
    """Average `tensors` over the ranks in place, in one collective per dtype (one flat
    buffer each). With `log` (a list) on a card, appends (bytes, and CUDA events before
    the packing, the collective, the unpacking and after it) of each one."""
    if not bound():
        return
    ts = list(tensors)
    for dtype in sorted({t.dtype for t in ts}, key=str):
        group = [t for t in ts if t.dtype == dtype]
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)] if log is not None and group[0].is_cuda else []
        mark = (lambda i: ev[i].record()) if ev else (lambda i: None)  # noqa: E731
        mark(0)
        flat = torch.cat([t.reshape(-1) for t in group])
        mark(1)
        pmean_(flat)
        mark(2)
        torch._foreach_copy_(group, [v.view_as(t) for t, v in zip(group, flat.split([t.numel() for t in group]))])
        mark(3)
        if ev:
            log.append((flat.numel() * flat.element_size(), *ev))


def pmean_grads_(params: Iterable[torch.Tensor]) -> None:
    """Average the .grad of `params` over the ranks, as the JAX step pmeans a phase's
    gradient tree (timed into GRAD_LOG while it is a list)."""
    pmean_flat_([p.grad for p in params if p.grad is not None], GRAD_LOG)


# ------------------------------------------------------------------ with gradients
class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return psum_(x.clone())

    @staticmethod
    def backward(ctx, ct):
        return _PSum.apply(ct)


class _PMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return pmean_(x.clone())

    @staticmethod
    def backward(ctx, ct):
        return _PMean.apply(ct)


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.rows = x.shape[0]
        return _gather(x)

    @staticmethod
    def backward(ctx, ct):
        n = ctx.rows
        return _PSum.apply(ct)[rank() * n:(rank() + 1) * n]


def axis_psum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the ranks, differentiable (identity with no group bound)."""
    return _PSum.apply(x) if bound() else x


def axis_pmean(x: torch.Tensor) -> torch.Tensor:
    """Mean over the ranks with the symmetric backward (identity with no group bound)."""
    return _PMean.apply(x) if bound() else x


def all_gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of x, concatenated along dim 0 in rank order (x with no group
    bound). The ranks' x must have one shape."""
    return _AllGatherRows.apply(x) if bound() else x
