"""Furthest-point sampling (counterpart of dusty_gan_v2_tpu/metrics/fps.py).

`furthest_point_sampling` is the plain PyTorch scan; `fps_cuda` launches the
hand-written kernel (csrc/fps.cu, replacing the Pallas pallas_fps.py::_build_kernel):
a cluster of CS blocks per cloud where B * CS blocks fill the card in one wave
(`cluster_size`), one block per cloud otherwise.
`downsample_point_clouds` dispatches by the tensor's device: the CPU takes the plain
scan, a CUDA tensor takes the kernel or raises. Both start at index 0 and resolve ties
to the lowest index, and compute the squared distance as (dx^2 + dy^2) + dz^2, so
their indices are identical.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .. import kernels

__all__ = ["furthest_point_sampling", "fps_cuda", "cluster_size", "gather_points", "downsample_point_clouds"]


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


# csrc/fps.cu's one-block kernel keeps each cloud's running minimum in registers: 1024
# threads x 32
MAX_POINTS = 32 * 1024
# its cluster kernel: clusters of up to 16 blocks (a power of two), a block's share of
# the cloud in shared memory as three float arrays, at most 16 points a thread (so any
# cluster of 2 or more holds a cloud of MAX_POINTS)
MAX_CLUSTER = 16
MAX_CLUSTER_SHARE = 16 * 1024
# the largest cluster cluster_size picks: at 8 x 32768 -> 2048 on an H100 a step took
# 1.9 us with 8 blocks a cloud and 2.9 us with 16 (one call, chip_smoke.py logs both)
CLUSTER_CAP = 8
H100_SMS = 132
_C_ARGS = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
]


def cluster_size(B: int, N: int, sm_count: int = H100_SMS) -> int:
    """The largest cluster the cluster kernel may take for B clouds of N points: a power
    of two CS <= CLUSTER_CAP with B * CS <= sm_count (all clusters in one wave, a block an SM),
    ceil(N / CS) <= MAX_CLUSTER_SHARE (the share fits shared memory) and N >= 1024 * CS
    (every thread of a block owns a point). 1, the one-block kernel, where even CS = 2
    fails. On the card, csrc/fps.cu halves it further until the B clusters are resident
    at once (cudaOccupancyMaxActiveClusters)."""
    cs = CLUSTER_CAP
    while cs >= 2:
        if B * cs <= sm_count and -(-N // cs) <= MAX_CLUSTER_SHARE and N >= 1024 * cs:
            return cs
        cs //= 2
    return 1


@functools.lru_cache(maxsize=None)
def _fit_cluster(device_index: int, B: int, N: int) -> int:
    """cluster_size refined by the card's occupancy query (csrc/fps.cu::fps_fit_cluster)."""
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    lib = kernels.library("fps")
    lib.fps_fit_cluster.argtypes, lib.fps_fit_cluster.restype = [ctypes.c_int] * 3, ctypes.c_int
    with torch.cuda.device(device_index):
        cs = lib.fps_fit_cluster(B, N, cluster_size(B, N, sms))
    if cs < 0:
        kernels.check("fps", -cs)
    return cs


def fps_cuda(xyz: torch.Tensor, k: int, cluster: int | None = None) -> torch.Tensor:
    """Launch the CUDA kernel on xyz's current stream; counts its launches.

    xyz: float32 (B, N, 3) on a CUDA device, any strides (no copy is made). `cluster`
    (1 or a power of two up to 16) forces the cluster size, for timing one against
    another; by default `_fit_cluster` chooses it."""
    if xyz.ndim != 3 or xyz.shape[-1] != 3 or xyz.dtype != torch.float32:
        raise ValueError(f"fps_cuda takes float32 (B, N, 3), got {xyz.dtype} {tuple(xyz.shape)}")
    B, N, _ = xyz.shape
    if not 1 <= N <= MAX_POINTS or k < 1:
        raise ValueError(f"fps_cuda takes 1 <= N <= {MAX_POINTS} and k >= 1, got N={N} k={k}")
    if cluster is not None and not (1 <= cluster <= MAX_CLUSTER and cluster & (cluster - 1) == 0):
        raise ValueError(f"fps_cuda takes a cluster of 1 or a power of two up to {MAX_CLUSTER}, got {cluster}")
    if not xyz.is_cuda:
        raise ValueError("fps_cuda needs a CUDA tensor")
    lib = kernels.library("fps")
    lib.fps_f32.argtypes, lib.fps_f32.restype = _C_ARGS, ctypes.c_int
    cs = _fit_cluster(xyz.device.index, B, N) if cluster is None else cluster
    idx = torch.empty((B, k), dtype=torch.int32, device=xyz.device)
    sb, sn, sc = xyz.stride()
    with torch.cuda.device(xyz.device):
        err = lib.fps_f32(
            xyz.data_ptr(), idx.data_ptr(), B, N, int(k), sb, sn, sc, cs,
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
