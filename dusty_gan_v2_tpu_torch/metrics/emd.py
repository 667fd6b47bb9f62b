"""The fused approxmatch EMD kernel's wrapper and dispatcher (counterpart of
dusty_gan_v2_tpu/metrics/pallas_emd.py and of cov_mmd_1nna.py::_emd_impl).

`emd_cuda` launches the hand-written kernel (csrc/emd.cu, replacing the Pallas
pallas_emd.py::_build_kernel). Its plain PyTorch version is
metrics/distance.py::earth_mover_distance. `emd_cost` dispatches by the tensor's
device: the CPU takes the plain version, a CUDA tensor takes the kernel or raises.
Only a shape outside the kernel's contract (`emd_cuda_available`) sends a CUDA tensor
to the plain version, and `emd_cost.plain_route` counts every call that went there;
a build or launch failure is never caught.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels
from .distance import earth_mover_distance

__all__ = ["emd_cuda", "emd_cuda_available", "emd_cost", "MAX_POINTS_SUM"]

# csrc/emd.cu keeps both clouds and its state in 24 * (n + m) bytes of shared memory
MAX_POINTS_SUM = 8192
_C_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
    ctypes.c_int, ctypes.c_void_p,
]


def emd_cuda_available(n: int, m: int) -> bool:
    """The kernel's contract: any 1 <= n, m with n + m <= 8192 (the Pallas kernel's
    n == m, m % 512 == 0 lies inside it up to 4096 points a side)."""
    return n >= 1 and m >= 1 and n + m <= MAX_POINTS_SUM


def emd_cuda(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on xyz1's current stream; counts its launches.

    xyz1 (B, n, 3), xyz2 (B, m, 3), float32 on one CUDA device -> (B,) costs with the
    semantics of earth_mover_distance. One block works on one pair."""
    if not (xyz1.is_cuda and xyz2.is_cuda) or xyz1.device != xyz2.device:
        raise ValueError("emd_cuda needs two tensors on one CUDA device")
    for t in (xyz1, xyz2):
        if t.dtype != torch.float32 or t.ndim != 3 or t.shape[-1] != 3:
            raise ValueError(f"emd_cuda takes float32 (B, N, 3), got {t.dtype} {tuple(t.shape)}")
    B, n, _ = xyz1.shape
    m = xyz2.shape[1]
    if xyz2.shape[0] != B:
        raise ValueError(f"emd_cuda: batch sizes differ, {B} and {xyz2.shape[0]}")
    if not emd_cuda_available(n, m):
        raise ValueError(f"emd_cuda takes n + m <= {MAX_POINTS_SUM}, got n={n} m={m}")
    lib = kernels.library("emd")
    lib.emd_f32.argtypes, lib.emd_f32.restype = _C_ARGS, ctypes.c_int
    xyz1, xyz2 = xyz1.contiguous(), xyz2.contiguous()
    cost = torch.empty((B,), dtype=torch.float32, device=xyz1.device)
    with torch.cuda.device(xyz1.device):
        err = lib.emd_f32(
            xyz1.data_ptr(), xyz2.data_ptr(), cost.data_ptr(), B, n, m,
            torch.cuda.current_stream(xyz1.device).cuda_stream,
        )
    kernels.check("emd", err)
    emd_cuda.launches += 1
    return cost


emd_cuda.launches = 0


def emd_cost(xyz1: torch.Tensor, xyz2: torch.Tensor) -> torch.Tensor:
    """Per-pair approximate EMD cost (B,): CPU: plain version, CUDA: the kernel."""
    if xyz1.device.type == "cuda":
        if emd_cuda_available(xyz1.shape[1], xyz2.shape[1]):
            return emd_cuda(xyz1.float(), xyz2.float())
    elif xyz1.device.type != "cpu":
        raise ValueError(f"emd_cost: unsupported device {xyz1.device}")
    emd_cost.plain_route += 1
    return earth_mover_distance(xyz1, xyz2)


emd_cost.plain_route = 0
