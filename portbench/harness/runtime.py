"""What every job shares: the process's start, the outcome of a run, the card."""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, List, Optional

import torch

from .checks import Check


def process_start_perf() -> float:
    """time.perf_counter()'s reading at this process's start (from /proc; now where
    /proc cannot tell)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - start_ticks / os.sysconf("SC_CLK_TCK")
        return time.perf_counter() - max(age, 0.0)
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


@dataclasses.dataclass
class Outcome:
    e2e: Dict[str, float]  # end-to-end metric name -> value (setup_s included)
    attempted: int
    failed: int
    checks: List[Check]
    memory_peak_bytes: int
    trace: Optional[Dict[str, Any]] = None  # the per-layer readers' context (--trace 1)
    notes: List[str] = dataclasses.field(default_factory=list)  # earlier stderr lines

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(c.ok for c in self.checks) and self.failed == 0


def set_precision(cfg: Dict[str, Any]) -> None:
    """The configuration's settings of the card's math: TF32 and cuDNN autotuning."""
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg.get("tf32", False))
    torch.backends.cudnn.allow_tf32 = bool(cfg.get("tf32", False))
    torch.backends.cudnn.benchmark = bool(cfg.get("cudnn_benchmark", False))


def free_cuda() -> None:
    import gc

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
