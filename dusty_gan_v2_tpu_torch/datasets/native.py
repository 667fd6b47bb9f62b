"""The KITTI loader's host kernels in C++ (csrc/projection.cpp), built with g++ and loaded
with ctypes.

Counterpart of dusty_gan_v2_tpu/datasets/native.py: `project_points_to_image_native`
(scan unfolding or pitch binning, then the z-buffer: the nearest point of each cell wins)
and `nearest_resize_native`, on float32 numpy arrays. The source is compiled at first use
by utils/hostbuild.py into dusty_gan_v2_tpu_torch/_build/ (git-ignored) under a name that
hashes the source, the compiler, its flags and the host CPU. There is no fallback: where
g++ is missing or the build fails, the call raises with the compiler's output (the JAX
module returns None and its loader takes numpy). The numpy versions in datasets/kitti.py
are these functions' test oracle.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import numpy as np

from ..utils import hostbuild

__all__ = ["CXX_FLAGS", "library_path", "build", "library", "project_points_to_image_native", "nearest_resize_native"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "projection.cpp"
BUILD_DIR = _PKG / "_build"
STEM = "libdusty_native"
CXX_FLAGS = hostbuild.CXX_FLAGS
_F32P = ctypes.POINTER(ctypes.c_float)


def library_path() -> Path:
    """Where the library of the current source, compiler, flags and host CPU lives."""
    return hostbuild.library_path(SOURCE, BUILD_DIR, STEM)


def build() -> Path:
    """Compile the library unless it exists; raise with the compiler's output on failure."""
    return hostbuild.build(SOURCE, BUILD_DIR, STEM)


def _declare(lib: ctypes.CDLL) -> None:
    lib.project_points_to_image.argtypes = [
        _F32P, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int, _F32P,
    ]
    lib.project_points_to_image.restype = ctypes.c_int
    lib.nearest_resize.argtypes = [_F32P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _F32P]
    lib.nearest_resize.restype = ctypes.c_int


def library() -> ctypes.CDLL:
    """The loaded library, built first if needed (once per process)."""
    return hostbuild.load(SOURCE, BUILD_DIR, STEM, _declare)


def project_points_to_image_native(
    points: np.ndarray, H: int, W: int, min_depth: float, max_depth: float, scan_unfolding: bool = True,
) -> np.ndarray:
    """(N, 4) xyzi -> (H, W, 6) float32 [x, y, z, intensity, depth, mask], the nearest
    point of each cell winning: kitti.py::project_points_to_image's function."""
    lib = library()
    pts = np.ascontiguousarray(points, np.float32)
    if pts.ndim != 2 or pts.shape[1] != 4:
        raise ValueError(f"points must be (N, 4), got {pts.shape}")
    out = np.zeros((H, W, 6), np.float32)
    rc = lib.project_points_to_image(
        pts.ctypes.data_as(_F32P), ctypes.c_int64(pts.shape[0]), int(H), int(W), ctypes.c_float(min_depth),
        ctypes.c_float(max_depth), int(bool(scan_unfolding)), out.ctypes.data_as(_F32P),
    )
    if rc != 0:
        raise RuntimeError(f"project_points_to_image returned {rc}")
    return out


def nearest_resize_native(img: np.ndarray, shape: Tuple[int, int]) -> np.ndarray:
    """(H, W, C) -> (OH, OW, C) float32, source index floor(dst * in / out):
    kitti.py::nearest_resize_hw's function."""
    lib = library()
    img = np.ascontiguousarray(img, np.float32)
    H, W, C = img.shape
    OH, OW = (int(s) for s in shape)
    out = np.zeros((OH, OW, C), np.float32)
    rc = lib.nearest_resize(img.ctypes.data_as(_F32P), H, W, C, OH, OW, out.ctypes.data_as(_F32P))
    if rc != 0:
        raise RuntimeError(f"nearest_resize returned {rc}")
    return out
