"""Furthest-point sampling (counterpart of dusty_gan_v2_tpu/metrics/fps.py).

`furthest_point_sampling` is the plain PyTorch scan; `fps_cuda` launches the
hand-written kernel (csrc/fps.cu, replacing the Pallas pallas_fps.py::_build_kernel).
`downsample_point_clouds` dispatches by the tensor's device: the CPU takes the plain
scan, a CUDA tensor takes the kernel or raises. Both start at index 0 and resolve ties
to the lowest index, and compute the squared distance as (dx^2 + dy^2) + dz^2, so
their indices are identical.
"""

from __future__ import annotations

import ctypes

import torch

from .. import kernels

__all__ = ["furthest_point_sampling", "fps_cuda", "gather_points", "downsample_point_clouds"]


def furthest_point_sampling(xyz: torch.Tensor, k: int) -> torch.Tensor:
    """Plain version: (B, N, 3) -> (B, k) int32 indices maximizing the minimum distance."""
    B, N, _ = xyz.shape
    x, y, z = xyz.float().unbind(-1)
    rows = torch.arange(B, device=xyz.device)
    min_d = torch.full((B, N), 1e10, dtype=torch.float32, device=xyz.device)
    last = torch.zeros(B, dtype=torch.long, device=xyz.device)
    picks = [last]
    for _ in range(k - 1):
        px, py, pz = x[rows, last][:, None], y[rows, last][:, None], z[rows, last][:, None]
        d = (x - px).square() + (y - py).square() + (z - pz).square()
        min_d = torch.minimum(min_d, d)
        last = torch.argmax(min_d, dim=-1)  # first maximum on ties
        picks.append(last)
    return torch.stack(picks, dim=1).to(torch.int32)


# csrc/fps.cu keeps each cloud's running minimum in registers: 1024 threads x 32
MAX_POINTS = 32 * 1024
_C_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_void_p,
]


def fps_cuda(xyz: torch.Tensor, k: int) -> torch.Tensor:
    """Launch the CUDA kernel on xyz's current stream; counts its launches.

    xyz: float32 (B, N, 3) on a CUDA device, any strides (no copy is made)."""
    if not xyz.is_cuda:
        raise ValueError("fps_cuda needs a CUDA tensor")
    if xyz.dtype != torch.float32 or xyz.ndim != 3 or xyz.shape[-1] != 3:
        raise ValueError(f"fps_cuda takes float32 (B, N, 3), got {xyz.dtype} {tuple(xyz.shape)}")
    B, N, _ = xyz.shape
    if not 1 <= N <= MAX_POINTS or k < 1:
        raise ValueError(f"fps_cuda takes 1 <= N <= {MAX_POINTS} and k >= 1, got N={N} k={k}")
    lib = kernels.library("fps")
    lib.fps_f32.argtypes, lib.fps_f32.restype = _C_ARGS, ctypes.c_int
    idx = torch.empty((B, k), dtype=torch.int32, device=xyz.device)
    sb, sn, sc = xyz.stride()
    err = lib.fps_f32(
        xyz.data_ptr(), idx.data_ptr(), B, N, int(k), sb, sn, sc,
        torch.cuda.current_stream(xyz.device).cuda_stream,
    )
    kernels.check("fps", err)
    fps_cuda.launches += 1
    return idx


fps_cuda.launches = 0


def gather_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """(B, N, C), (B, k) -> (B, k, C)."""
    return torch.gather(points, 1, idx.long()[..., None].expand(-1, -1, points.shape[-1]))


def downsample_point_clouds(xyz: torch.Tensor, k: int) -> torch.Tensor:
    """FPS-downsample (B, N, 3) -> (B, k, 3); CPU: plain scan, CUDA: the kernel."""
    if xyz.device.type == "cuda":
        idx = fps_cuda(xyz, k)
    elif xyz.device.type == "cpu":
        idx = furthest_point_sampling(xyz, k)
    else:
        raise ValueError(f"downsample_point_clouds: unsupported device {xyz.device}")
    return gather_points(xyz, idx)
