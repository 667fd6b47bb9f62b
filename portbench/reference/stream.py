"""The draws of a step, made by the benchmark from its seed.

`SeedStream` has the draw methods of the program's per-sample streams (normal, uniform,
randint, scalar_randint, bernoulli, logistic, each returning (n, *shape) rows, and
with_batch), for one process. Every draw comes from one torch.Generator that the benchmark
seeds from (seed, iteration), so the program's step and the reference's step, each handed a
stream seeded alike, draw the same numbers wherever they ask for the same draws in the same
order. `log` records each draw's kind and shape, so that a caller can check that both asked
for the same draws. On the meta device (the FLOP count) a draw is an empty tensor.
"""

from __future__ import annotations

from typing import List, Optional

import torch

_MASK64 = (1 << 64) - 1


def mix_seed(*data: int) -> int:
    """A 63-bit seed from integers, through splitmix64's mixer."""
    x = 0
    for d in data:
        x = (x ^ (int(d) & _MASK64)) & _MASK64
        x = (x + 0x9E3779B97F4A7C15) & _MASK64
        x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
        x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
        x = x ^ (x >> 31)
    return x & ((1 << 63) - 1)


class SeedStream:
    def __init__(self, n: int, generator: Optional[torch.Generator], device, log: Optional[List] = None):
        self.n = int(n)
        self.generator = generator
        self.device = torch.device(device)
        self.log = [] if log is None else log

    @classmethod
    def seeded(cls, n: int, device, *seed: int) -> "SeedStream":
        device = torch.device(device)
        gen = None if device.type == "meta" else torch.Generator(device=device).manual_seed(mix_seed(*seed))
        return cls(n, gen, device)

    def with_batch(self, n: int, parts: int = 1) -> "SeedStream":
        return SeedStream(n, self.generator, self.device, self.log)

    def _shape(self, kind, shape) -> tuple:
        s = (self.n,) + tuple(shape)
        self.log.append((kind, s))
        return s

    def _empty(self, s, dtype):
        return torch.empty(s, device=self.device, dtype=dtype)

    def normal(self, shape=(), dtype=torch.float32) -> torch.Tensor:
        s = self._shape("normal", shape)
        if self.generator is None:
            return self._empty(s, dtype)
        return torch.randn(s, generator=self.generator, device=self.device, dtype=dtype)

    def uniform(self, shape=(), dtype=torch.float32, minval=0.0, maxval=1.0) -> torch.Tensor:
        s = self._shape("uniform", shape)
        out = self._empty(s, dtype)
        return out if self.generator is None else out.uniform_(minval, maxval, generator=self.generator)

    def randint(self, shape=(), minval=0, maxval=2, dtype=torch.int32) -> torch.Tensor:
        s = self._shape("randint", shape)
        if self.generator is None:
            return self._empty(s, dtype)
        return torch.randint(minval, maxval, s, generator=self.generator, device=self.device, dtype=dtype)

    def scalar_randint(self, minval: int, maxval: int) -> torch.Tensor:
        self.log.append(("scalar_randint", ()))
        if self.generator is None:
            return self._empty((), torch.int64)
        return torch.randint(minval, maxval, (), generator=self.generator, device=self.device)

    def bernoulli(self, p, shape=()) -> torch.Tensor:
        return self.uniform(shape) < p

    def logistic(self, shape=(), dtype=torch.float32, eps: float = 1e-7) -> torch.Tensor:
        u = self.uniform(shape, dtype, eps, 1.0 - eps)
        return torch.log(u) - torch.log1p(-u)
