"""Metrics of the PyTorch port (counterparts of dusty_gan_v2_tpu/metrics)."""

from .fps import downsample_point_clouds, fps_cuda, furthest_point_sampling, gather_points

__all__ = ["downsample_point_clouds", "fps_cuda", "furthest_point_sampling", "gather_points"]
