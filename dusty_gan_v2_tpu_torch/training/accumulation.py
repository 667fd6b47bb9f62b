"""Gradient accumulation (counterpart of dusty_gan_v2_tpu/training/accumulation.py).

The mean loss and the mean gradients over micro-batches, one micro-batch's activations
alive at a time: each micro-batch's graph is freed by its own backward before the next
forward. No step of the port calls it; it serves configs whose batch does not fit.
"""

from __future__ import annotations

from typing import Any, Callable, List, Sequence, Tuple

import torch

__all__ = ["microbatch_value_and_grad"]


def _split(batch: Any, n: int, i: int) -> Any:
    """Micro-batch i of n of a tensor or a dict / list / tuple of tensors (contiguous
    chunks of the leading axis, as the JAX reshape to (n, B / n, ...) takes them)."""
    if isinstance(batch, torch.Tensor):
        B = batch.shape[0]
        if B % n:
            raise ValueError(f"a batch of {B} does not split into {n} micro-batches")
        m = B // n
        return batch[i * m : (i + 1) * m]
    if isinstance(batch, dict):
        return {k: _split(v, n, i) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(_split(v, n, i) for v in batch)
    raise TypeError(f"cannot split a {type(batch).__name__} into micro-batches")


def microbatch_value_and_grad(
    loss_fn: Callable[..., torch.Tensor], params: Sequence[torch.Tensor], batch: Any, num_accumulation: int,
    *loss_args, **loss_kwargs,
) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(mean loss, mean gradients with respect to `params`) of loss_fn(micro_batch,
    *loss_args, **loss_kwargs) over num_accumulation micro-batches of `batch`. A
    parameter the loss does not reach gets a zero gradient, as jax.grad gives."""
    n = max(int(num_accumulation), 1)
    params = list(params)
    loss_sum, grad_sum = None, [torch.zeros_like(p) for p in params]
    for i in range(n):
        loss = loss_fn(_split(batch, n, i), *loss_args, **loss_kwargs)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        for acc, g in zip(grad_sum, grads):
            if g is not None:
                acc.add_(g)
        loss_sum = loss.detach() if loss_sum is None else loss_sum + loss.detach()
    return loss_sum / n, [g / n for g in grad_sum]
