"""The numbers that decide `correct`, each beside its limit.

A training cell compares, over its first three steps: each step's losses (relative gap),
the first step's gradient of every leaf as the optimizer gets it and the parameters'
change after the three steps, each by the worst leaf: the gap between the program's norm
and the reference's, over the reference's norm of that leaf or of the median leaf,
whichever is larger (`worst_leaf_gap`)."""

from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Dict, Iterable, List, Optional, Set

import torch


@dataclasses.dataclass
class Check:
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


def leaf_norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """{name: float32 L2 norm}, computed on the device, read in one transfer."""
    names = list(tensors)
    if not names:
        return {}
    vals = torch.stack([torch.linalg.vector_norm(tensors[n].detach().float()) for n in names]).cpu().tolist()
    return dict(zip(names, vals))


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float], skip: Optional[Set[str]] = None) -> float:
    """max over leaves of |prog - ref| / max(ref, the median leaf's ref norm); a leaf the
    program lacks counts as a gap of 1."""
    skip = skip or set()
    keys = [k for k in ref if k not in skip]
    if not keys:
        return 0.0
    med = statistics.median(ref[k] for k in keys)
    worst = 0.0
    for k in keys:
        if k not in prog or not math.isfinite(prog[k]):
            return float("inf") if k in prog else 1.0
        worst = max(worst, abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30))
    return worst


def median_leaf_gap(prog: Dict[str, float], ref: Dict[str, float], skip: Optional[Set[str]] = None) -> float:
    """The median over leaves of worst_leaf_gap's per-leaf gap: a number steady from seed to
    seed where the worst leaf is one small leaf's rounding; a leaf the program lacks reads inf."""
    skip = skip or set()
    keys = [k for k in ref if k not in skip]
    if not keys:
        return 0.0
    if any(k not in prog or not math.isfinite(prog[k]) for k in keys):
        return float("inf")
    med = statistics.median(ref[k] for k in keys)
    return statistics.median(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in keys)


def worst_leaf(prog: Dict[str, float], ref: Dict[str, float], skip: Optional[Set[str]] = None):
    """(leaf, gap, prog norm, ref norm, median) of worst_leaf_gap's worst leaf."""
    skip = skip or set()
    keys = [k for k in ref if k not in skip and k in prog]
    if not keys:
        return None
    med = statistics.median(ref[k] for k in keys)
    k = max(keys, key=lambda k: abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30))
    return k, abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30), prog[k], ref[k], med


def rel_gap(a: float, b: float) -> float:
    if not (math.isfinite(a) and math.isfinite(b)):
        return float("inf")
    return abs(a - b) / max(abs(b), 1e-30)


def report(checks: Iterable[Check]) -> Dict[str, Dict[str, float]]:
    return {c.name: {"value": c.value, "limit": c.limit} for c in checks}


def lines(checks: List[Check]) -> List[str]:
    return [f"check {c.name}: {c.value!r} (limit {c.limit!r}) {'ok' if c.ok else 'FAILED'}" for c in checks]
