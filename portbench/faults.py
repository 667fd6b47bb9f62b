"""The control and the planted faults each cell's comparison must catch.

`control(cell)` is the program factory of the control run: the reference put in the
program's place at the precision below the configuration's (a bfloat16 configuration:
fp8 operands; float32 with TF32 off: TF32). For the evaluation cell, whose float32 EMD has
no matrix product for TF32 to touch, it is the reference's approxmatch computed in
bfloat16 at every entry the comparison reads (one sampled pair a launch); the rest of each
round runs the program's kernel, since a whole round of the plain reference takes minutes.

`planted(cell)` gives the faults the cell can have, each a program factory: a state left
unchanged by the step, half of the batch left out (its rows replaced by the other
half's, so that every mean is taken over the rest), an answer altered where it is
produced. One chip: no exchange between chips to leave out."""

from __future__ import annotations

import copy
from typing import Callable, Dict

import torch

from .harness.cells import Cell


class HalfDraws:
    """A stream whose per-sample draws repeat the first half of each block of B rows."""

    def __init__(self, stream, B: int):
        self.s, self.B = stream, B
        self.n = stream.n

    def with_batch(self, n: int, parts: int = 1) -> "HalfDraws":
        return HalfDraws(self.s.with_batch(n, parts), self.B)

    def _half(self, a: torch.Tensor) -> torch.Tensor:
        b = a.reshape(-1, self.B, *a.shape[1:]).clone()
        h = self.B // 2
        b[:, h:] = b[:, :h]
        return b.reshape(a.shape)

    def normal(self, *a, **k):
        return self._half(self.s.normal(*a, **k))

    def uniform(self, *a, **k):
        return self._half(self.s.uniform(*a, **k))

    def randint(self, *a, **k):
        return self._half(self.s.randint(*a, **k))

    def logistic(self, *a, **k):
        return self._half(self.s.logistic(*a, **k))

    def bernoulli(self, *a, **k):
        return self._half(self.s.bernoulli(*a, **k))

    def scalar_randint(self, *a, **k):
        return self.s.scalar_randint(*a, **k)

    @property
    def log(self):
        return self.s.log


def _precision_below(cell: Cell) -> str:
    return "fp8" if cell.config.get("precision") == "bf16" else "tf32"


def control(cell: Cell) -> Callable:
    kind = cell.traffic["kind"]
    if kind == "train":
        from .jobs.train import RefProgram

        prec = _precision_below(cell)
        return lambda cfg, dev, seed: RefProgram(cfg, dev, seed, prec)
    if kind == "eval":
        from .jobs.eval import PortEval
        from .reference import emd as REF

        class Bf16Reference(PortEval):
            def sampled_entries(self, a, b):
                return REF.emd_per_point(a, b, dtype=torch.bfloat16)

        return Bf16Reference
    raise KeyError(kind)


def planted(cell: Cell) -> Dict[str, Callable]:
    kind = cell.traffic["kind"]
    if kind == "train":
        from .jobs.train import PortTrainer

        class Unchanged(PortTrainer):
            def step(self, st, depth, mask, it, stream, on_phase=None):
                return super().step(copy.deepcopy(st), depth, mask, it, stream, on_phase)

        class HalfBatch(PortTrainer):
            """The second half of every batch replaced by the first: the reals' rows and
            every per-sample draw (latents, shifts, ray-drop noise, augmentations)."""

            def step(self, st, depth, mask, it, stream, on_phase=None):
                h = depth.shape[0] // 2
                depth, mask = torch.cat([depth[:h], depth[:h]]), torch.cat([mask[:h], mask[:h]])
                return super().step(st, depth, mask, it, HalfDraws(stream, 2 * h), on_phase)

        return {"unchanged": Unchanged, "half_batch": HalfBatch}
    if kind == "eval":
        from .jobs.eval import PortEval

        class AlteredE(PortEval):
            """Every answer of one EMD launch of each matrix 5% off."""

            def __init__(self, device):
                super().__init__(device)
                inner = self.M._pairwise_distance

                def altered(p1, p2, batch_size, metrics=("cd",), device="cuda"):
                    out = inner(p1, p2, batch_size, metrics, device)
                    for m in out.values():
                        m.reshape(-1)[:batch_size] *= 1.05
                    return out

                self.M._pairwise_distance = altered

        class HalfPairs(PortEval):
            """Each launch computes the first half of its pairs; the rest stay unset (0)."""

            def __init__(self, device):
                super().__init__(device)
                M = self.M
                orig_emd = M._FNS["emd"]

                def half(a, b):
                    h = a.shape[0] // 2
                    out = torch.zeros(a.shape[0], device=a.device)
                    out[:h] = orig_emd(a[:h], b[:h]) if h else out[:h]
                    return out

                self._orig_fns = dict(M._FNS)
                M._FNS["emd"] = half

            def close(self):
                self.M._FNS.update(self._orig_fns)
                super().close()

        return {"altered": AlteredE, "half_batch": HalfPairs}
    raise KeyError(kind)
