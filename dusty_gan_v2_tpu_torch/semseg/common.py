"""Semseg building blocks: torch-layout convolutions, BatchNorm with one-pass or
two-pass moments, conv -> ReLU (-> BN), the W-only 2x transposed conv, the Dropout2d +
conv head, the max pool in its three forms and the neighbour unfold.

Counterpart of dusty_gan_v2_tpu/semseg/common.py. Submodules and parameters carry the
flax names (conv, bn, weight, bias, running_mean, running_var), so a JAX variable tree
maps onto the state_dict by flattening its paths (convert/jax_variables.py). Conv
weights are (O, I, kh, kw), the transposed conv's (I, O, 1, 4): torch's layouts.

Compute-dtype policy: parameters stay float32 (the master copy); each block casts its
weights to the activation's dtype, and BatchNorm reduces in at least float32 and casts
back. `train` is an explicit argument, as in the JAX modules, not nn.Module.training.

Under data parallelism (a process group bound, parallel/mesh.py) BatchNorm normalizes
with the global batch's moments (SyncBatchNorm semantics: the one-pass form's two means
reduced together in one collective, the two-pass form's mean and then its centred second
moment) and the head's Dropout2d masks are the global batch's rows, so the forward is a
one-process run's on the same global batch.

The JAX package's implementation switches (`arch.pool_impl`, `arch.bn_one_pass`, module
globals there) are module arguments here: `max_pool2d(impl=)` "separable" (the default),
"reduce_window" or "shift", and `BatchNorm2d(one_pass=)`. The three pools give the same
values; they differ in where the gradient goes at exact ties, and each routes it as its
JAX form does (see max_pool2d).
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..parallel.mesh import axis_pmean, bound, rank, world_size
from ..parallel.persample import PerSampleStream

__all__ = [
    "TorchConv2d",
    "BatchNorm2d",
    "ConvReLU",
    "ConvReLUNorm",
    "DeconvReLU",
    "HeadConv",
    "max_pool2d",
    "POOL_IMPLS",
    "unfold_neighbors",
    "setup_in_ch",
    "trunc_normal_init",
    "xavier_uniform_init",
    "reset_parameters",
]

Init = Callable[[Tuple[int, ...], torch.Generator], torch.Tensor]


def setup_in_ch(inputs: Sequence[str]) -> int:
    channels = {"xyz": 3, "depth": 1, "reflectance": 1, "mask": 1}
    return sum(channels[m] for m in inputs)


def trunc_normal_init(std: float) -> Init:
    """N(0, 1) truncated to [-2, 2], times std (the JAX package's truncated_normal(-2, 2)
    * std), by the inverse CDF of a uniform draw."""
    lo, hi = (0.5 * (1.0 + math.erf(v / math.sqrt(2.0))) for v in (-2.0, 2.0))

    def init(shape, generator):
        u = torch.rand(shape, generator=generator, dtype=torch.float64) * (hi - lo) + lo
        z = math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0)
        return (z.clamp(-2.0, 2.0) * std).float()

    return init


def xavier_uniform_init() -> Init:
    def init(shape, generator):
        # shape (O, I, kh, kw)
        fan_out = shape[0] * shape[2] * shape[3]
        fan_in = shape[1] * shape[2] * shape[3]
        a = math.sqrt(6.0 / (fan_in + fan_out))
        return torch.empty(shape).uniform_(-a, a, generator=generator)

    return init


def _torch_conv_default_init(shape, generator):
    # torch Conv2d's default: kaiming_uniform(a=sqrt(5)) == U(-b, b), b = 1/sqrt(fan_in)
    b = 1.0 / math.sqrt(shape[1] * shape[2] * shape[3])
    return torch.empty(shape).uniform_(-b, b, generator=generator)


def reset_parameters(module: nn.Module, generator: torch.Generator) -> None:
    """Draw every parameter of `module`'s submodules from `generator`, in registration
    order."""
    for m in module.modules():
        if m is not module and hasattr(m, "reset_parameters"):
            m.reset_parameters(generator)


class TorchConv2d(nn.Module):
    def __init__(self, in_ch: int, out_ch: int, kernel_size=(3, 3), stride=(1, 1), padding=(1, 1),
                 use_bias: bool = True, kernel_init: Optional[Init] = None):
        super().__init__()
        self.stride, self.padding = tuple(stride), tuple(padding)
        self.kernel_init = kernel_init or _torch_conv_default_init
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, *kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch)) if use_bias else None

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.copy_(self.kernel_init(tuple(self.weight.shape), generator))
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = None if self.bias is None else self.bias.to(x.dtype)
        return F.conv2d(x, self.weight.to(x.dtype), b, self.stride, self.padding)


class BatchNorm2d(nn.Module):
    """BatchNorm with torch's momentum convention (running = (1 - m) running + m batch),
    eps 1e-5 and the unbiased running variance.

    Train mode takes, with `one_pass` (the JAX package's default form), moments centred
    on the running mean c (a constant): v = max(E[(x - c)^2] - (m - c)^2, 0); without it
    the two-pass v = E[(x - m)^2]. Both are written in plain torch ops (F.batch_norm
    rounds bf16 otherwise); the moments are at least float32 whatever the activation's
    dtype."""

    def __init__(self, ch: int, momentum: float = 0.001, one_pass: bool = True):
        super().__init__()
        self.momentum = float(momentum)
        self.one_pass = bool(one_pass)
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("running_mean", torch.zeros(ch))
        self.register_buffer("running_var", torch.ones(ch))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.fill_(1.0)
            self.bias.zero_()
            self.running_mean.zero_()
            self.running_var.fill_(1.0)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        x32 = x.to(torch.promote_types(x.dtype, torch.float32))
        shape = (1, -1, 1, 1)
        if train:
            dims = (0, 2, 3)
            m = x32.mean(dims)
            if self.one_pass:
                c = self.running_mean.to(x32.dtype, copy=True)
                ex2c = (x32 - c.reshape(shape)).square().mean(dims)
                if bound():  # the global batch's moments: both means in one collective
                    m, ex2c = axis_pmean(torch.cat([m, ex2c])).split(m.shape[0])
                v = torch.maximum(ex2c - (m - c).square(), torch.zeros_like(ex2c))
            else:  # the global mean first, then the second moment centred on it
                m = axis_pmean(m) if bound() else m
                v = (x32 - m.reshape(shape)).square().mean(dims)
                v = axis_pmean(v) if bound() else v
            with torch.no_grad():
                n = x.shape[0] * x.shape[2] * x.shape[3] * world_size()
                unbiased = v * n / max(n - 1, 1)
                mom = self.momentum
                self.running_mean.copy_((1 - mom) * self.running_mean + mom * m)
                self.running_var.copy_((1 - mom) * self.running_var + mom * unbiased)
        else:
            m, v = self.running_mean, self.running_var
        inv = torch.rsqrt(v.reshape(shape) + 1e-5)
        out = (x32 - m.reshape(shape)) * inv * self.weight.reshape(shape) + self.bias.reshape(shape)
        return out.to(x.dtype)


class ConvReLU(nn.Module):
    def __init__(self, in_ch, out_ch, kernel_size=(3, 3), stride=(1, 1), padding=(1, 1), kernel_init=None):
        super().__init__()
        self.conv = TorchConv2d(in_ch, out_ch, kernel_size, stride, padding, kernel_init=kernel_init)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return torch.relu(self.conv(x))


class ConvReLUNorm(nn.Module):
    """conv -> ReLU -> BN (SqueezeSegV2's order)."""

    def __init__(self, in_ch, out_ch, kernel_size=(3, 3), stride=(1, 1), padding=(1, 1), bn_momentum=0.001,
                 kernel_init=None, bn_one_pass: bool = True):
        super().__init__()
        self.conv = TorchConv2d(in_ch, out_ch, kernel_size, stride, padding, kernel_init=kernel_init)
        self.bn = BatchNorm2d(out_ch, bn_momentum, bn_one_pass)

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self.bn(torch.relu(self.conv(x)), train=train)


class DeconvReLU(nn.Module):
    """W-only 2x transposed conv, kernel (1, 4), stride (1, 2), padding (0, 1), then ReLU.

    The weight starts as the bilinear [1, 3, 3, 1] / 4 on the channel diagonal and is a
    trained parameter, as in the JAX package (whose docstring calls it frozen; its
    optimizer has no mask)."""

    def __init__(self, in_ch: int, out_ch: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(in_ch, out_ch, 1, 4))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def reset_parameters(self, generator: torch.Generator) -> None:
        k = torch.tensor([1.0, 3.0, 3.0, 1.0])
        with torch.no_grad():
            self.weight.zero_()
            for c in range(self.weight.shape[0]):
                self.weight[c, c, 0] = k / k.sum() * 2.0
            self.bias.zero_()

    def forward(self, x: torch.Tensor, train: bool = False) -> torch.Tensor:
        y = F.conv_transpose2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), stride=(1, 2), padding=(0, 1))
        return torch.relu(y)


class HeadConv(nn.Module):
    """Dropout2d (whole channels) + conv.

    In train mode the keep mask is `keep`, a (B, C, 1, 1) bool tensor, when given, else
    drawn as uniform < 1 - p from `generator` (on x's device) for the global batch, of
    which this rank keeps its rows (parallel/persample.py), so that a sample's mask does
    not depend on the number of processes. The JAX package keys each sample's mask by its
    global id with threefry bits; the two agree on injected masks only. With
    `bias_init_values` p the bias starts at -log((1 - p) / p) (the class-frequency prior)."""

    def __init__(self, in_ch: int, out_ch: int, kernel_size: int = 3, dropout_p: float = 0.5,
                 kernel_init: Optional[Init] = None, bias_init_values: Optional[Sequence[float]] = None):
        super().__init__()
        self.dropout_p = float(dropout_p)
        self.kernel_init = kernel_init or _torch_conv_default_init
        self.bias_init_values = None if bias_init_values is None else tuple(float(v) for v in bias_init_values)
        self.weight = nn.Parameter(torch.empty(out_ch, in_ch, kernel_size, kernel_size))
        self.bias = nn.Parameter(torch.zeros(out_ch))

    def reset_parameters(self, generator: torch.Generator) -> None:
        with torch.no_grad():
            self.weight.copy_(self.kernel_init(tuple(self.weight.shape), generator))
            if self.bias_init_values is None:
                self.bias.zero_()
            else:
                p = torch.tensor(self.bias_init_values, dtype=torch.float32)
                self.bias.copy_(-torch.log((1 - p) / p))

    def forward(self, x: torch.Tensor, train: bool = False, keep: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        p = self.dropout_p
        if train and p > 0:
            if keep is None:
                if generator is None:
                    raise ValueError("a train-mode HeadConv needs a keep mask or a generator")
                st = PerSampleStream(x.shape[0], generator, x.device, rank(), world_size())
                keep = st.uniform((x.shape[1], 1, 1)) < 1.0 - p
            elif keep.shape != (x.shape[0], x.shape[1], 1, 1):
                raise ValueError(f"keep mask {tuple(keep.shape)} for activations {tuple(x.shape)}")
            x = x * keep.to(x.dtype) / (1.0 - p)
        k = self.weight.shape[-1]
        return F.conv2d(x, self.weight.to(x.dtype), self.bias.to(x.dtype), padding=k // 2)


POOL_IMPLS = ("separable", "reduce_window", "shift")


def _sliding_max_1d(x: torch.Tensor, k: int, dim: int) -> torch.Tensor:
    """Stride-1 max over k-windows along `dim` (valid positions: length L - k + 1) by
    shift-doubling: the max of two w-windows w apart covers 2w, and two w-windows k - w
    apart cover k. torch.maximum, like JAX's, splits the gradient of a tie in half."""
    m, w = x, 1
    while 2 * w <= k:
        n = m.shape[dim] - w
        m = torch.maximum(m.narrow(dim, 0, n), m.narrow(dim, w, n))
        w *= 2
    if w < k:
        d = k - w
        n = m.shape[dim] - d
        m = torch.maximum(m.narrow(dim, 0, n), m.narrow(dim, d, n))
    return m


def _window_scan(x: torch.Tensor, kernel: int, stride, padding: int) -> torch.Tensor:
    """The k x k max as one scan over the window's taps in row-major order, each tap
    taken where it is strictly greater: the gradient of a tie goes to the first maximum
    in row-major order, the element XLA's select-and-scatter (JAX's reduce_window VJP,
    select >=) picks."""
    xp = F.pad(x, (padding,) * 4, value=-math.inf)
    H = (xp.shape[2] - kernel) // stride[0] + 1
    W = (xp.shape[3] - kernel) // stride[1] + 1
    best = None
    for dy in range(kernel):
        for dx in range(kernel):
            tap = xp[:, :, dy:dy + (H - 1) * stride[0] + 1:stride[0], dx:dx + (W - 1) * stride[1] + 1:stride[1]]
            best = tap if best is None else torch.where(tap > best, tap, best)
    return best


def max_pool2d(x: torch.Tensor, kernel: int = 3, stride=(1, 2), padding: int = 1, impl: str = "separable") -> torch.Tensor:
    """torch MaxPool2d(kernel, stride, padding) with -inf padding, in the JAX package's
    three forms, equal in value; at exact ties (common in bf16 and after a ReLU) each
    routes the gradient as its JAX form does:

    - "separable": two 1-D pools, (k, 1) then (1, k): the first maximum along H, then
      along W, as JAX's two 1-D reduce_window VJPs (a 2-D pool would pick the first in
      row-major order: another element);
    - "reduce_window": the k x k window as one scan (`_window_scan`): the first maximum
      in row-major order;
    - "shift": the stride-1 sliding max per axis by pairwise maxima, then subsampled: a
      tie's gradient is split between the tied elements."""
    if isinstance(stride, int):
        stride = (stride, stride)
    if impl == "separable":
        m = F.max_pool2d(x, (kernel, 1), (stride[0], 1), (padding, 0))
        return F.max_pool2d(m, (1, kernel), (1, stride[1]), (0, padding))
    if impl == "reduce_window":
        return _window_scan(x, kernel, stride, padding)
    if impl == "shift":
        xp = F.pad(x, (padding,) * 4, value=-math.inf)
        m = _sliding_max_1d(_sliding_max_1d(xp, kernel, 2), kernel, 3)
        return m[:, :, :: stride[0], :: stride[1]]
    raise ValueError(f"max pool impl {impl!r}: one of {POOL_IMPLS}")


def unfold_neighbors(x: torch.Tensor, kernel_size, exclude_center: bool = True) -> torch.Tensor:
    """torch F.unfold with zero padding: (B,C,H,W) -> (B,C,K[-1],H*W) neighbour stacks,
    K = kh * kw, the centre optionally removed."""
    kh, kw = kernel_size
    B, C, H, W = x.shape
    ph, pw = kh // 2, kw // 2
    xp = F.pad(x, (pw, pw, ph, ph))
    slabs = [xp[:, :, dy:dy + H, dx:dx + W] for dy in range(kh) for dx in range(kw)
             if not (exclude_center and dy == ph and dx == pw)]
    out = torch.stack(slabs, dim=2)
    return out.reshape(B, C, out.shape[2], H * W)
