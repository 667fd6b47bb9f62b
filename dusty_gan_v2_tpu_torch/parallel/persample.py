"""Per-sample draws of the training step.

Counterpart of dusty_gan_v2_tpu/parallel/persample.py. The JAX package keys every
per-sample draw by the sample's global id (threefry `fold_in`), so that a step does not
depend on the number of devices. The port draws batch-wide from an explicit
torch.Generator instead: `PerSampleStream` has the JAX stream's draw methods, each
returning a (n, *shape) tensor, one row per sample. Its draws are not threefry draws,
so the port matches the JAX step only on injected draws: `ReplayStream` hands out given
arrays in call order and checks each one's shape, which is how the tests feed both
sides the same numbers.

Every method takes the shape of one sample's draw; the batch is the stream's `n`, and
`with_batch(n)` gives a stream of another batch over the same source (the trainer's
concatenated reals and fakes).

`fold_seed(seed, *data)` derives a seed from a run's seed and integers, as the JAX
package folds an iteration into its run key: the trainer seeds each step's generator
with fold_seed(seed, iteration), so that a step's draws do not depend on the steps
before it (a resumed run draws what the uninterrupted one drew).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

__all__ = ["global_ids", "fold_seed", "PerSampleStream", "ReplayStream"]

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def fold_seed(seed: int, *data: int) -> int:
    """A 64-bit seed from `seed` and each int of `data` in turn, through splitmix64's
    mixer: fold_seed(s, a, b) = mix(mix(mix(s) ^ a) ^ b). Nearby inputs give unrelated
    seeds."""
    x = _splitmix64(int(seed) & _MASK64)
    for d in data:
        x = _splitmix64(x ^ (int(d) & _MASK64))
    return x


def global_ids(n_local: int, offset: int = 0, rank: int = 0, device=None) -> torch.Tensor:
    """Global indices of rank `rank`'s `n_local` consecutive samples, shifted by
    `offset` (int64). One process: arange(n_local) + offset."""
    return torch.arange(n_local, device=device) + offset + rank * n_local


class PerSampleStream:
    """Draws for `n` samples from `generator` (on `device`, which must be the
    generator's device)."""

    def __init__(self, n: int, generator: torch.Generator, device=None):
        self.n = int(n)
        self.generator = generator
        self.device = torch.device(device) if device is not None else generator.device

    def with_batch(self, n: int) -> "PerSampleStream":
        return PerSampleStream(n, self.generator, self.device)

    def _shape(self, shape) -> tuple:
        return (self.n,) + tuple(shape)

    def normal(self, shape=(), dtype=torch.float32) -> torch.Tensor:
        return torch.randn(self._shape(shape), generator=self.generator, device=self.device, dtype=dtype)

    def uniform(self, shape=(), dtype=torch.float32, minval=0.0, maxval=1.0) -> torch.Tensor:
        out = torch.empty(self._shape(shape), device=self.device, dtype=dtype)
        return out.uniform_(minval, maxval, generator=self.generator)

    def randint(self, shape=(), minval=0, maxval=2, dtype=torch.int32) -> torch.Tensor:
        return torch.randint(
            minval, maxval, self._shape(shape), generator=self.generator, device=self.device, dtype=dtype
        )

    def bernoulli(self, p, shape=()) -> torch.Tensor:
        """Boolean (n, *shape): uniform < p, as jax.random.bernoulli draws."""
        return self.uniform(shape) < p

    def logistic(self, shape=(), dtype=torch.float32, eps: float = 1e-7) -> torch.Tensor:
        """Logistic(0, 1) noise, log(u) - log(1 - u) with u ~ U(eps, 1 - eps), as
        ops/gumbel.py::sample_logistic draws it."""
        u = self.uniform(shape, dtype, eps, 1.0 - eps)
        return torch.log(u) - torch.log1p(-u)


class ReplayStream:
    """Hands out given arrays in call order. Each draw checks that the next array has
    the shape it asks for, (n, *shape), and moves it to `device`.

    `bernoulli(p, shape)` takes the next array as the uniforms under the draw and
    returns them < p; every other method returns the array as given (cast to the
    asked dtype). Streams made by `with_batch` share the queue."""

    def __init__(self, arrays: Sequence, n: Optional[int] = None, device="cpu", _queue: Optional[List] = None):
        self.queue = list(arrays) if _queue is None else _queue
        self.n = n
        self.device = torch.device(device)

    def with_batch(self, n: int) -> "ReplayStream":
        return ReplayStream((), n, self.device, _queue=self.queue)

    @property
    def remaining(self) -> int:
        return len(self.queue)

    def _next(self, shape, dtype) -> torch.Tensor:
        if not self.queue:
            raise RuntimeError(f"replay stream exhausted: a draw of {(self.n,) + tuple(shape)} has no array left")
        a = self.queue[0]
        a = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a, copy=True))
        want = (a.shape[0] if self.n is None else self.n,) + tuple(shape)
        if tuple(a.shape) != want:
            raise ValueError(f"replay stream: next array has shape {tuple(a.shape)}, the draw asks for {want}")
        self.queue.pop(0)
        return a.to(device=self.device, dtype=dtype)

    def normal(self, shape=(), dtype=torch.float32) -> torch.Tensor:
        return self._next(shape, dtype)

    def uniform(self, shape=(), dtype=torch.float32, minval=0.0, maxval=1.0) -> torch.Tensor:
        return self._next(shape, dtype)

    def randint(self, shape=(), minval=0, maxval=2, dtype=torch.int32) -> torch.Tensor:
        return self._next(shape, dtype)

    def bernoulli(self, p, shape=()) -> torch.Tensor:
        return self._next(shape, torch.float32) < p

    def logistic(self, shape=(), dtype=torch.float32, eps: float = 1e-7) -> torch.Tensor:
        return self._next(shape, dtype)
