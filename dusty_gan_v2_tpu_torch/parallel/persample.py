"""Per-sample draws of the training step.

Counterpart of dusty_gan_v2_tpu/parallel/persample.py. The JAX package keys every
per-sample draw by the sample's global id (threefry `fold_in`), so that a step does not
depend on the number of devices. The port keeps that property with another bit source:
every rank draws the GLOBAL rows of a draw from the step's torch.Generator (seeded alike
on every rank) and keeps its own, so the rows a sample gets are the same on any number
of processes. `PerSampleStream` has the JAX stream's draw methods, each returning this
rank's (n, *shape) rows. Its bits are not threefry's, so the port matches the JAX step
only on injected draws: `ReplayStream` hands out given global arrays in call order,
checks each one's shape and gives each rank its rows, which is how the tests feed the
JAX step, one process and several the same numbers.

Every method takes the shape of one sample's draw; the local batch is the stream's `n`
and the global one n * world. `scalar_randint` is the exception: one draw for the whole
batch, the same on every rank (style mixing's crossover). `with_batch(n, parts)` gives a stream of another batch
over the same source; `parts` > 1 lays out a batch made of that many concatenated
sub-batches, each with ids of its own (the trainer's reals ++ fakes: the reals take the
global rows [0, B), the fakes [B, 2B), and rank k keeps rows k*b.. of each half, as the
JAX step's global_ids with an offset).

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


def _layout(n: int, rank: int, world: int, parts: int) -> Optional[List[slice]]:
    """The global rows of rank `rank`'s n local ones: `parts` pieces of n // parts rows,
    piece p at p * (n // parts) * world + rank * (n // parts). None for all rows."""
    if world == 1:
        return None
    if n % parts:
        raise ValueError(f"a batch of {n} does not split into {parts} parts")
    m = n // parts
    return [slice(p * m * world + rank * m, p * m * world + (rank + 1) * m) for p in range(parts)]


def _rows(a: torch.Tensor, layout: Optional[List[slice]]) -> torch.Tensor:
    if layout is None:
        return a
    return a[layout[0]] if len(layout) == 1 else torch.cat([a[s] for s in layout])


class PerSampleStream:
    """Draws for this rank's `n` samples from `generator` (on `device`, which must be
    the generator's device): each draw is made for the n * world samples of the global
    batch and this rank's rows are kept."""

    def __init__(self, n: int, generator: torch.Generator, device=None, rank: int = 0, world: int = 1,
                 parts: int = 1):
        self.n = int(n)
        self.generator = generator
        self.device = torch.device(device) if device is not None else generator.device
        self.rank, self.world, self.parts = int(rank), int(world), int(parts)
        self._layout = _layout(self.n, self.rank, self.world, self.parts)

    def with_batch(self, n: int, parts: int = 1) -> "PerSampleStream":
        return PerSampleStream(n, self.generator, self.device, self.rank, self.world, parts)

    def _shape(self, shape) -> tuple:
        return (self.n * self.world,) + tuple(shape)

    def normal(self, shape=(), dtype=torch.float32) -> torch.Tensor:
        a = torch.randn(self._shape(shape), generator=self.generator, device=self.device, dtype=dtype)
        return _rows(a, self._layout)

    def uniform(self, shape=(), dtype=torch.float32, minval=0.0, maxval=1.0) -> torch.Tensor:
        out = torch.empty(self._shape(shape), device=self.device, dtype=dtype)
        return _rows(out.uniform_(minval, maxval, generator=self.generator), self._layout)

    def randint(self, shape=(), minval=0, maxval=2, dtype=torch.int32) -> torch.Tensor:
        a = torch.randint(minval, maxval, self._shape(shape), generator=self.generator, device=self.device,
                          dtype=dtype)
        return _rows(a, self._layout)

    def scalar_randint(self, minval: int, maxval: int) -> torch.Tensor:
        """One int64 in [minval, maxval) for the whole batch (every rank draws it alike)."""
        return torch.randint(minval, maxval, (), generator=self.generator, device=self.device)

    def bernoulli(self, p, shape=()) -> torch.Tensor:
        """Boolean (n, *shape): uniform < p, as jax.random.bernoulli draws."""
        return self.uniform(shape) < p

    def logistic(self, shape=(), dtype=torch.float32, eps: float = 1e-7) -> torch.Tensor:
        """Logistic(0, 1) noise, log(u) - log(1 - u) with u ~ U(eps, 1 - eps), as
        ops/gumbel.py::sample_logistic draws it."""
        u = self.uniform(shape, dtype, eps, 1.0 - eps)
        return torch.log(u) - torch.log1p(-u)


class ReplayStream:
    """Hands out given arrays in call order. Each array holds a draw's global rows: the
    draw checks that the next one has the shape it asks for, (n * world, *shape), and
    moves this rank's rows (the layout of PerSampleStream) to `device`.

    `bernoulli(p, shape)` takes the next array as the uniforms under the draw and
    returns them < p; every other method returns the rows as given (cast to the asked
    dtype). Streams made by `with_batch` share the queue. With n None (one process only)
    every array is taken whole."""

    def __init__(self, arrays: Sequence, n: Optional[int] = None, device="cpu", rank: int = 0, world: int = 1,
                 parts: int = 1, _queue: Optional[List] = None):
        self.queue = list(arrays) if _queue is None else _queue
        self.n = n
        self.device = torch.device(device)
        self.rank, self.world, self.parts = int(rank), int(world), int(parts)
        self._layout = None if n is None else _layout(n, self.rank, self.world, self.parts)

    def with_batch(self, n: int, parts: int = 1) -> "ReplayStream":
        return ReplayStream((), n, self.device, self.rank, self.world, parts, _queue=self.queue)

    @property
    def remaining(self) -> int:
        return len(self.queue)

    def _next(self, shape, dtype) -> torch.Tensor:
        if not self.queue:
            raise RuntimeError(f"replay stream exhausted: a draw of {(self.n,) + tuple(shape)} has no array left")
        if self.n is None and self.world != 1:
            raise ValueError("a replay stream over several ranks needs its local batch n (with_batch)")
        a = self.queue[0]
        a = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a, copy=True))
        want = (a.shape[0] if self.n is None else self.n * self.world,) + tuple(shape)
        if tuple(a.shape) != want:
            raise ValueError(f"replay stream: next array has shape {tuple(a.shape)}, the draw asks for {want}")
        self.queue.pop(0)
        return _rows(a, self._layout).to(device=self.device, dtype=dtype)

    def normal(self, shape=(), dtype=torch.float32) -> torch.Tensor:
        return self._next(shape, dtype)

    def uniform(self, shape=(), dtype=torch.float32, minval=0.0, maxval=1.0) -> torch.Tensor:
        return self._next(shape, dtype)

    def randint(self, shape=(), minval=0, maxval=2, dtype=torch.int32) -> torch.Tensor:
        return self._next(shape, dtype)

    def scalar_randint(self, minval: int, maxval: int) -> torch.Tensor:
        """The next array, which must be 0-dimensional, as an int64 scalar on `device`."""
        if not self.queue:
            raise RuntimeError("replay stream exhausted: a scalar draw has no array left")
        a = self.queue[0]
        a = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a, copy=True))
        if a.ndim != 0:
            raise ValueError(f"replay stream: next array has shape {tuple(a.shape)}, the draw asks for a scalar")
        self.queue.pop(0)
        return a.to(device=self.device, dtype=torch.int64)

    def bernoulli(self, p, shape=()) -> torch.Tensor:
        return self._next(shape, torch.float32) < p

    def logistic(self, shape=(), dtype=torch.float32, eps: float = 1e-7) -> torch.Tensor:
        return self._next(shape, dtype)
