"""Range-image geometry of the PyTorch port (counterpart of dusty_gan_v2_tpu/geometry)."""

from .coords import COORD_TYPES, CoordBridge, bilinear_resize, resize_angle_lut
from .normals import estimate_surface_normal, euler_rotation_matrix
from .render import bilinear_rasterizer, make_Rt, render_point_clouds

__all__ = [
    "COORD_TYPES", "CoordBridge", "bilinear_resize", "resize_angle_lut", "estimate_surface_normal",
    "euler_rotation_matrix", "bilinear_rasterizer", "make_Rt", "render_point_clouds",
]
