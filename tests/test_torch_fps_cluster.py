"""The CPU-side parts of the FPS and EMD kernels' wrappers.

- metrics/fps.py::cluster_size, the pure part of the FPS kernel's choice of cluster size
  (csrc/fps.cu refines it on the card with its occupancy query);
- fps_cuda and emd_cuda reject what their kernels do not take with ValueError, before
  any build or launch (each check is reached here with a CPU tensor: the device check
  comes last);
- downsample_point_clouds on the CPU against the JAX scan on the (B, 3, N)-backed view
  that CoordBridge returns, with origin ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dusty_gan_v2_tpu.metrics.fps import furthest_point_sampling as j_fps
from dusty_gan_v2_tpu.metrics.fps import gather_points as j_gather
from dusty_gan_v2_tpu_torch.metrics import downsample_point_clouds, emd_cuda, fps_cuda
from dusty_gan_v2_tpu_torch.metrics.fps import CLUSTER_CAP, H100_SMS, MAX_CLUSTER, MAX_CLUSTER_SHARE, cluster_size

# ------------------------------------------------------------------ cluster size


@pytest.mark.parametrize(
    "B,N,cs",
    [
        (8, 32768, 8),  # the sample + FPS slice: 64 blocks of 4096 points
        (64, 32768, 2),  # the evaluation's batch: 128 blocks of 16384 points
        (66, 32768, 2),  # the largest batch of one wave at CS = 2
        (67, 32768, 1),  # CS = 2 would take 134 > 132 SMs
        (128, 32768, 1),  # the rates phase's batch: the one-block kernel
        (1, 32768, 8),
        (16, 32768, 8),
        (17, 32768, 4),
        (32, 32768, 4),
        (8, 4096, 4),  # every thread of a block owns a point: N >= 1024 CS
        (8, 1024, 1),
    ],
)
def test_cluster_size(B, N, cs):
    assert cluster_size(B, N) == cs


@pytest.mark.parametrize("B", [1, 2, 3, 5, 8, 16, 33, 64, 66, 67, 100, 128, 512])
@pytest.mark.parametrize("N", [1, 1000, 2048, 5000, 32768])
def test_cluster_size_keeps_its_rules(B, N):
    cs = cluster_size(B, N)
    assert cs & (cs - 1) == 0 and 1 <= cs <= CLUSTER_CAP <= MAX_CLUSTER
    if cs > 1:
        assert B * cs <= H100_SMS
        assert -(-N // cs) <= MAX_CLUSTER_SHARE and 3 * 4 * -(-N // cs) <= 227 * 1024
        assert N >= 1024 * cs
        # the largest that keeps them
        bigger = 2 * cs
        assert bigger > CLUSTER_CAP or B * bigger > H100_SMS or N < 1024 * bigger


def test_cluster_size_follows_the_sm_count():
    assert cluster_size(8, 32768, sm_count=64) == 8
    assert cluster_size(64, 32768, sm_count=64) == 1


def test_shares_fit_shared_memory_at_32768_points():
    """A block of the cluster kernel holds its share as three float arrays in shared
    memory (227 KB a block); a whole 32768-point cloud does not fit one block, so the
    one-block kernel reads its points from L2."""
    assert 12 * 32768 > 227 * 1024
    for B in range(1, 67):
        cs = cluster_size(B, 32768)
        assert cs >= 2 and 12 * -(-32768 // cs) <= 227 * 1024 - 1024


# ------------------------------------------------------------------ argument checks


@pytest.mark.parametrize(
    "xyz,k,kwargs,match",
    [
        (torch.zeros(2, 64, 3), 8, {}, "CUDA"),
        (torch.zeros(2, 64, 3, dtype=torch.float64), 8, {}, "float32"),
        (torch.zeros(2, 64, 3, dtype=torch.float16), 8, {}, "float32"),
        (torch.zeros(2, 64, 2), 8, {}, r"\(B, N, 3\)"),
        (torch.zeros(64, 3), 8, {}, r"\(B, N, 3\)"),
        (torch.zeros(2, 32 * 1024 + 1, 3), 8, {}, "N <="),
        (torch.zeros(2, 64, 3), 0, {}, "k >= 1"),
        (torch.zeros(2, 64, 3), 8, {"cluster": 3}, "cluster"),
        (torch.zeros(2, 64, 3), 8, {"cluster": 32}, "cluster"),
        (torch.zeros(2, 32768, 3), 8, {"cluster": 1}, "CUDA"),
    ],
)
def test_fps_cuda_rejects(xyz, k, kwargs, match):
    before = fps_cuda.launches
    with pytest.raises(ValueError, match=match):
        fps_cuda(xyz, k, **kwargs)
    assert fps_cuda.launches == before


@pytest.mark.parametrize(
    "x,y,match",
    [
        (torch.zeros(2, 64, 3), torch.zeros(2, 64, 3), "CUDA"),
        (torch.zeros(2, 64, 3, dtype=torch.float64), torch.zeros(2, 64, 3), "float32"),
        (torch.zeros(2, 64, 3), torch.zeros(2, 64, 3, dtype=torch.bfloat16), "float32"),
        (torch.zeros(2, 64, 4), torch.zeros(2, 64, 3), r"\(B, N, 3\)"),
        (torch.zeros(2, 64, 3), torch.zeros(3, 64, 3), "batch sizes differ"),
        (torch.zeros(1, 4096, 3), torch.zeros(1, 4097, 3), "n \\+ m <="),
        (torch.zeros(1, 0, 3), torch.zeros(1, 64, 3), "n \\+ m <="),
    ],
)
def test_emd_cuda_rejects(x, y, match):
    before = emd_cuda.launches
    with pytest.raises(ValueError, match=match):
        emd_cuda(x, y)
    assert emd_cuda.launches == before


# ------------------------------------------------------------------ strided view


@pytest.mark.parametrize("B,N,k", [(2, 512, 64), (3, 1000, 37)])
def test_downsample_on_a_strided_view_matches_jax(B, N, k):
    """CoordBridge's point set is a (B, N, 3) view of a (B, 3, N) map; 30% of the points
    sit on the origin, as dropped rays do, so many distances tie exactly."""
    rng = np.random.RandomState(B * N)
    xyz = rng.randn(B, N, 3).astype(np.float32)
    xyz[rng.rand(B, N) < 0.3] = 0.0
    planes = torch.from_numpy(np.ascontiguousarray(xyz.transpose(0, 2, 1)))
    view = planes.transpose(1, 2)
    assert not view.is_contiguous() and view.stride() == (3 * N, 1, N)
    ref = j_gather(jnp.asarray(xyz), j_fps(jnp.asarray(xyz), k))
    np.testing.assert_array_equal(downsample_point_clouds(view, k).numpy(), np.asarray(ref))
