"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every source under ``csrc/`` is compiled by its own ``nvcc`` process into its own
shared library with a plain C interface; all compilers start together and the build
waits for every one. Libraries go to ``dusty_gan_v2_tpu_torch/_build/`` (git-ignored)
under a name that hashes the source and its flags, so an edited source is rebuilt and
an unchanged one is reused. Each source has its own flags (NVCC_FLAGS): fps.cu must not
contract a*b+c to FMA or its indices drift from the plain scan's, emd.cu pins the
rounding of its distance with intrinsics and lets the compiler fuse the rest. Nothing
is built at import: the first kernel launch (or an explicit ``build_all()``) triggers
the build.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "SOURCES", "NVCC_FLAGS", "build_all", "library", "check"]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_TARGET = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3")
_OUTPUT = ("-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_FLAGS = {
    "fused_bias_act": (*_TARGET, "--fmad=false", *_OUTPUT),
    "fps": (*_TARGET, "--fmad=false", *_OUTPUT),
    "emd": (*_TARGET, *_OUTPUT),
}
SOURCES = tuple(NVCC_FLAGS)


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS[name]).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


@functools.lru_cache(maxsize=None)
def build_all() -> dict:
    """Compile every missing library, all nvcc processes at once.

    Returns {source name: ptxas report} (empty for a library already built)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in SOURCES:
        target = _target(name)
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS[name], "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            target,
        )
    reports, failed = {name: "" for name in SOURCES}, []
    for name, (proc, tmp, target) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
            continue
        os.replace(tmp, target)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building every kernel first if needed."""
    build_all()
    lib = ctypes.CDLL(str(_target(name)))
    err_fn = getattr(lib, f"{name}_error_string")
    err_fn.argtypes = [ctypes.c_int]
    err_fn.restype = ctypes.c_char_p
    return lib


def check(name: str, err: int) -> None:
    """Raise if a C entry of csrc/<name>.cu returned a CUDA error."""
    if err != 0:
        msg = getattr(library(name), f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}: {msg}")
