"""Metrics of the PyTorch port (counterparts of dusty_gan_v2_tpu/metrics)."""

from .cov_mmd_1nna import compute_cd, compute_cov_mmd_1nna, compute_dcd, compute_emd
from .depth import compute_depth_accuracy, compute_depth_error
from .distance import (
    approx_match,
    chamfer_distance,
    density_aware_chamfer_distance,
    earth_mover_distance,
    fscore,
    match_cost,
    pairwise_sqdist,
)
from .emd import emd_cost, emd_cuda, emd_cuda_available
from .fpd_kpd import compute_frechet_distance, compute_squared_mmd
from .fps import downsample_point_clouds, fps_cuda, furthest_point_sampling, gather_points
from .jsd import compute_jsd
from .pointnet import PointNetFeatures, build_pointnet, load_torch_state_dict
from .swd import compute_swd

__all__ = [
    "compute_cd", "compute_cov_mmd_1nna", "compute_dcd", "compute_emd",
    "compute_depth_accuracy", "compute_depth_error",
    "approx_match", "chamfer_distance", "density_aware_chamfer_distance", "earth_mover_distance",
    "fscore", "match_cost", "pairwise_sqdist",
    "emd_cost", "emd_cuda", "emd_cuda_available",
    "compute_frechet_distance", "compute_squared_mmd",
    "downsample_point_clouds", "fps_cuda", "furthest_point_sampling", "gather_points",
    "compute_jsd", "PointNetFeatures", "build_pointnet", "load_torch_state_dict", "compute_swd",
]
