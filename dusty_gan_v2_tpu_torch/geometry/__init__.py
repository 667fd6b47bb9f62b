"""Range-image geometry of the PyTorch port (counterpart of dusty_gan_v2_tpu/geometry)."""

from .coords import COORD_TYPES, CoordBridge, bilinear_resize, resize_angle_lut

__all__ = ["COORD_TYPES", "CoordBridge", "bilinear_resize", "resize_angle_lut"]
