"""Work counts kept with the benchmark: each kernel's bytes and operations, and the FLOPs
behind the mfu metrics, from the shapes and dtypes of a call's inputs and outputs.

A kernel's least time is the larger of its bytes over the card's memory rate and its
operations over the rate of the units that execute them (peaks.json). Bytes count each
input read once and each output written once; operations count the arithmetic the
mathematics needs, whatever a kernel recomputes.

The model FLOPs are counted by torch.utils.flop_counter on the reference, run on the meta
device (no numbers, shapes only): every matrix product and convolution of the step, with
each resampling counted by its filter taps (reference/ops/resample.py), not by the dense
operators the plain version multiplies."""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from .reference.ops.resample import COUNT
from .reference.stream import SeedStream

# the discriminator's blur window, (1, 3, 3, 1): four taps along each axis
BLUR_TAPS = 4
# approxmatch: per element of the n x m plane, d once (x.y: 3 mul + 2 add; + |x|^2 + |y|^2,
# 2 x.y, clamp: 4 more) and its square root once; per level one exp, the exponent's
# multiply, pass A's and pass B's multiply-add and pass C's three multiplies and two adds
EMD_LEVELS = 9
EMD_F32_PER_ELEM = 9 + EMD_LEVELS * 10
EMD_SFU_PER_ELEM = 1 + EMD_LEVELS


def bias_act(shape: Sequence[int], esize: int) -> Dict[str, float]:
    """K1: y = leaky_relu(x + bias[c]) * scale over x (B, C, ...): x read, bias read, y
    written; an add, a select-multiply and a scale an element."""
    n = math.prod(shape)
    return {"bytes": (2 * n + shape[1]) * esize, "f32_ops": 3 * n, "sfu_ops": 0}


def _taps(n_in: int, n_out: int) -> int:
    """Taps an output of one resampled axis needs: the window's 4 at the same size or
    at 2x down, half of them at 2x up."""
    return BLUR_TAPS // 2 if n_out > n_in else BLUR_TAPS


def chain_fwd(in_shape: Sequence[int], out_shape: Sequence[int], esize: int, act: bool) -> Dict[str, float]:
    """K4: out = resample(act(x)) per plane: x read, out written; the activation's 3 ops an
    input element where there is one, then a W pass (H x Wo outputs) and an H pass
    (Ho x Wo) of a multiply-add per tap."""
    B, C, H, W = in_shape
    Ho, Wo = out_shape[-2:]
    planes = B * C
    ops = planes * 2 * (H * Wo * _taps(W, Wo) + Ho * Wo * _taps(H, Ho))
    if act:
        ops += 3 * planes * H * W
    return {"bytes": (planes * (H * W + Ho * Wo) + (C if act else 0)) * esize, "f32_ops": ops, "sfu_ops": 0}


def chain_bwd(in_shape: Sequence[int], out_shape: Sequence[int], esize: int) -> Dict[str, float]:
    """K5: dx = adjoint_resample(g) * act'(x): g (the output's shape) and x read, dx
    written; the adjoint passes' multiply-adds and the mask's compare and multiply."""
    B, C, H, W = in_shape
    Ho, Wo = out_shape[-2:]
    planes = B * C
    ops = planes * 2 * (Ho * W * _taps(H, Ho) + H * W * _taps(W, Wo)) + 3 * planes * H * W
    return {"bytes": (planes * (2 * H * W + Ho * Wo) + C) * esize, "f32_ops": ops, "sfu_ops": 0}


def emd(pairs: int, n: int, m: int) -> Dict[str, float]:
    """K3: approxmatch and its match cost for `pairs` pairs of n- and m-point clouds: the
    clouds read (float32 xyz), a cost written a pair."""
    plane = pairs * n * m
    return {"bytes": pairs * ((n + m) * 12 + 4), "f32_ops": plane * EMD_F32_PER_ELEM, "sfu_ops": plane * EMD_SFU_PER_ELEM}


def least_seconds(work: Dict[str, float], peaks: Dict[str, float]) -> Tuple[float, str]:
    """(least time, "bytes" or "operations") of one launch on the card."""
    by_bytes = work["bytes"] / peaks["hbm_bytes_per_s"]
    by_ops = work["f32_ops"] / peaks["fp32_flops_per_s"] + work["sfu_ops"] / peaks["sfu_ops_per_s"]
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


class _Counting:
    def __enter__(self):
        COUNT.update(on=True, flops=0)
        self.fc = FlopCounterMode(display=False)
        self.fc.__enter__()
        return self

    def __exit__(self, *exc):
        self.fc.__exit__(*exc)
        COUNT["on"] = False

    @property
    def flops(self) -> int:
        return int(self.fc.get_total_flops()) + int(COUNT["flops"])


def train_step_flops(cfg: Dict, iterations: Sequence[int]) -> Dict[int, int]:
    """{iteration: model FLOPs of the reference's training step at that iteration} at the
    configuration's shapes: G's and D's forwards and backwards, R1's double backward on
    an R1 iteration, the augmentation's matrices left out; the optimizers and EMA are
    elementwise and not counted."""
    from .reference.step import RefTrainer

    H, W = cfg["model"]["generator"]["synthesis_kwargs"]["resolution"]
    ref = RefTrainer(cfg, torch.zeros(1, 2, H, W, device="meta"), "meta")
    with torch.device("meta"):
        from .reference.models import build_discriminator, build_generator
        sd = {"G": build_generator(cfg["model"]["generator"], "meta").state_dict(),
              "D": build_discriminator(cfg["model"]["discriminator"], "meta").state_dict()}
    out = {}
    B = ref.batch_size
    for it in iterations:
        state = ref.init_state(sd, 0.0)
        state.opt_G.step = state.opt_D.step = lambda: None
        depth = torch.empty(B, 1, H, W, device="meta")
        with _Counting() as c:
            ref.step(state, depth, depth, it, SeedStream(B, None, "meta"))
        out[it] = c.flops
    return out


def train_window_flops(cfg: Dict, first: int, n: int) -> int:
    """Model FLOPs of iterations first .. first + n - 1: each R1 iteration's count, each
    other iteration's (train_step_flops of one of each kind)."""
    lazy = int(cfg["training"]["lazy"]["gp"])
    r1_on = cfg["training"]["loss"].get("gp", 0) > 0
    n_r1 = sum(1 for i in range(first, first + n) if r1_on and i % lazy == 0)
    r1_it = next(i for i in range(first, first + lazy + 1) if i % lazy == 0)
    f = train_step_flops(cfg, [r1_it, r1_it + 1])
    return n_r1 * f[r1_it] + (n - n_r1) * f[r1_it + 1]
