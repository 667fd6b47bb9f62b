"""The KITTI loader's host kernels in C++ (csrc/projection.cpp), built with g++ and loaded
with ctypes.

Counterpart of dusty_gan_v2_tpu/datasets/native.py: `project_points_to_image_native`
(scan unfolding or pitch binning, then the z-buffer: the nearest point of each cell wins)
and `nearest_resize_native`, on float32 numpy arrays. The source is compiled at first use
by one g++ process into dusty_gan_v2_tpu_torch/_build/ (git-ignored), under a name that
hashes the source, the compiler, its flags and the CPU that -march=native resolves to (a
library built for one host's CPU may not run on another's), through a temporary file and
an atomic rename, so that processes and threads that build at once never load a half-written
library. There is no fallback: where g++ is missing or the build fails, the call raises
with the compiler's output (the JAX module returns None and its loader takes numpy).
The numpy versions in datasets/kitti.py are these functions' test oracle.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

__all__ = ["CXX_FLAGS", "library_path", "build", "library", "project_points_to_image_native", "nearest_resize_native"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "projection.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")
_F32P = ctypes.POINTER(ctypes.c_float)
_lock = threading.Lock()


def _cxx() -> str:
    path = os.environ.get("CXX") or shutil.which("g++")
    if not path:
        raise RuntimeError("g++ not found: the KITTI loader's projection (csrc/projection.cpp) needs a C++ compiler")
    return path


@functools.lru_cache(maxsize=None)
def _target_cpu(cxx: str) -> str:
    """The -march / -mtune values that -march=native means to this compiler on this host."""
    out = subprocess.run([cxx, "-march=native", "-Q", "--help=target"], capture_output=True, text=True).stdout
    return " ".join(line.split()[-1] for line in out.splitlines() if line.strip().startswith(("-march=", "-mtune=")))


def library_path() -> Path:
    """Where the library of the current source, compiler, flags and host CPU lives."""
    cxx = _cxx()
    key = " ".join((cxx, *CXX_FLAGS, _target_cpu(cxx)))
    digest = hashlib.sha256(SOURCE.read_bytes() + key.encode()).hexdigest()[:16]
    return BUILD_DIR / f"libdusty_native-{digest}.so"


def build() -> Path:
    """Compile the library unless it exists; raise with the compiler's output on failure."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [_cxx(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {SOURCE.name} failed (g++ exit {proc.returncode}): {' '.join(cmd)}\n{proc.stdout}")
    os.replace(tmp, target)
    return target


@functools.lru_cache(maxsize=None)
def _load() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    lib.project_points_to_image.argtypes = [
        _F32P, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float, ctypes.c_int, _F32P,
    ]
    lib.project_points_to_image.restype = ctypes.c_int
    lib.nearest_resize.argtypes = [_F32P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, _F32P]
    lib.nearest_resize.restype = ctypes.c_int
    return lib


def library() -> ctypes.CDLL:
    """The loaded library, built first if needed (once per process, under a lock: the
    loader's threads ask for it together)."""
    with _lock:
        return _load()


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
