"""The port's plain furthest-point sampling against the JAX scan and the Pallas kernel
(interpret mode) on the CPU: the index arrays must be identical."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dusty_gan_v2_tpu.metrics.fps import downsample_point_clouds as j_downsample
from dusty_gan_v2_tpu.metrics.fps import furthest_point_sampling as j_fps
from dusty_gan_v2_tpu.metrics.fps import gather_points as j_gather
from dusty_gan_v2_tpu.metrics.pallas_fps import fps_pallas
from dusty_gan_v2_tpu_torch.metrics import downsample_point_clouds, furthest_point_sampling, gather_points


def points(kind, B=3, N=256, seed=0):
    rng = np.random.RandomState(seed)
    xyz = rng.randn(B, N, 3).astype(np.float32)
    if kind == "duplicates":  # exact duplicates -> distance ties
        xyz[:, N // 2 :] = xyz[:, : N // 2]
    elif kind == "dropped":  # dropped rays land on the origin, as in a range image
        xyz[rng.rand(B, N) < 0.3] = 0.0
    elif kind == "grid":  # many equal distances on a lattice
        xyz = np.round(xyz * 2) / 2
    return xyz


@pytest.mark.parametrize("kind", ["normal", "duplicates", "dropped", "grid"])
def test_plain_fps_equals_jax_scan_and_pallas(kind):
    xyz = points(kind)
    got = furthest_point_sampling(torch.from_numpy(xyz), 64)
    assert got.dtype == torch.int32 and tuple(got.shape) == (3, 64)
    np.testing.assert_array_equal(got.numpy(), np.asarray(j_fps(jnp.asarray(xyz), 64)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(fps_pallas(jnp.asarray(xyz), 64, interpret=True)))


def test_plain_fps_on_a_strided_point_set():
    """CoordBridge returns a (B, N, 3) view of a (B, 3, N) map: same indices."""
    xyz = points("dropped", B=2, N=128, seed=1)
    planes = torch.from_numpy(np.ascontiguousarray(xyz.transpose(0, 2, 1)))
    view = planes.transpose(1, 2)
    assert not view.is_contiguous()
    np.testing.assert_array_equal(
        furthest_point_sampling(view, 32).numpy(), np.asarray(j_fps(jnp.asarray(xyz), 32))
    )


def test_gather_and_downsample_match_jax():
    xyz = points("dropped", seed=2)
    idx = np.array(j_fps(jnp.asarray(xyz), 16))
    np.testing.assert_array_equal(
        gather_points(torch.from_numpy(xyz), torch.from_numpy(idx)).numpy(),
        np.asarray(j_gather(jnp.asarray(xyz), jnp.asarray(idx))),
    )
    np.testing.assert_array_equal(
        downsample_point_clouds(torch.from_numpy(xyz), 16).numpy(),
        np.asarray(j_downsample(jnp.asarray(xyz), 16)),
    )
