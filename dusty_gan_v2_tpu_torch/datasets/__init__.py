"""Datasets of the port (counterpart of dusty_gan_v2_tpu/datasets)."""

from .kitti import DevicePrefetcher, InfiniteSampler, KITTIRaw, Prefetcher, project_points_to_image, to_device

__all__ = ["KITTIRaw", "InfiniteSampler", "Prefetcher", "DevicePrefetcher", "to_device", "project_points_to_image"]
