"""Host libraries in C++, built with g++ at first use and loaded with ctypes.

The port's C++ sources (csrc/projection.cpp for the KITTI loader, csrc/zstd_decode.cpp
for orbax checkpoints) are compiled by one g++ process into dusty_gan_v2_tpu_torch/_build/
(git-ignored), under a name that hashes the source, the compiler, its flags and the CPU
that -march=native resolves to (a library built for one host's CPU may not run on
another's), through a temporary file and an atomic rename, so that processes and threads
that build at once never load a half-written library. There is no fallback: where g++ is
missing or the build fails, the call raises with the compiler's output.
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
from typing import Callable, Dict, Tuple

__all__ = ["CXX_FLAGS", "compiler", "library_path", "build", "load"]

CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")
_lock = threading.Lock()
_loaded: Dict[Tuple[Path, Path, str], ctypes.CDLL] = {}


def compiler(source: Path) -> str:
    """$CXX, else g++ on the PATH; RuntimeError naming `source` if there is neither."""
    path = os.environ.get("CXX") or shutil.which("g++")
    if not path:
        raise RuntimeError(f"g++ not found: {source.name} needs a C++ compiler")
    return path


@functools.lru_cache(maxsize=None)
def _target_cpu(cxx: str) -> str:
    """The -march / -mtune values that -march=native means to this compiler on this host."""
    out = subprocess.run([cxx, "-march=native", "-Q", "--help=target"], capture_output=True, text=True).stdout
    return " ".join(line.split()[-1] for line in out.splitlines() if line.strip().startswith(("-march=", "-mtune=")))


def library_path(source: Path, build_dir: Path, stem: str) -> Path:
    """Where the library of `source` for the current compiler, flags and host CPU lives."""
    cxx = compiler(source)
    key = " ".join((cxx, *CXX_FLAGS, _target_cpu(cxx)))
    digest = hashlib.sha256(Path(source).read_bytes() + key.encode()).hexdigest()[:16]
    return Path(build_dir) / f"{stem}-{digest}.so"


def build(source: Path, build_dir: Path, stem: str) -> Path:
    """Compile `source` unless its library exists; raise with the compiler's output on failure."""
    target = library_path(source, build_dir, stem)
    if target.exists():
        return target
    target.parent.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [compiler(source), *CXX_FLAGS, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building {Path(source).name} failed (g++ exit {proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stdout}")
    os.replace(tmp, target)
    return target


def load(source: Path, build_dir: Path, stem: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The library of `source`, built first if needed and loaded once per process under a
    lock (a loader's threads ask for it together); `declare` sets its functions' types."""
    key = (Path(source), Path(build_dir), stem)
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build(source, build_dir, stem)))
            declare(lib)
            _loaded[key] = lib
        return lib
