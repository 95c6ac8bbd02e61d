"""Build, load and launch count of the port's hand-written CUDA kernels.

Each kernel source under ``csrc/`` is compiled with ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes``. The build runs
at first use, never at import (the CPU test machines have no ``nvcc``),
into ``_build/`` inside the package (listed in ``.gitignore``). The library
name carries a hash of the source and the flags, so an edited source is
rebuilt rather than reused.

``LAUNCHES`` counts launches per kernel: each wrapper adds one where it
launches its kernel, and nowhere else, so a run can show that its main
path went through the kernels.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# IEEE division and square root (the nvcc defaults, spelled out) and no
# contracted multiply-adds: see the note at the top of each source.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-prec-div=true",
              "-prec-sqrt=true", "-fmad=false")

LAUNCHES: collections.Counter = collections.Counter()

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launch_counts() -> None:
    LAUNCHES.clear()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` into ``_build/`` (if not already built)
    and return the library path."""
    src = SRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(
        NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {src.name} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)   # atomic: a concurrent build sees all or none
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            _LIBS[name] = lib
        return lib


def fused_sma_lib() -> ctypes.CDLL:
    """K1's library with its C signature declared."""
    lib = load("fused_sma")
    fn = lib.dbx_fused_sma
    if fn.argtypes is None:
        vp, ci = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [vp, vp, vp, vp, vp, vp, vp, ci, ci, ci,
                       ctypes.c_float, ci, vp]
        fn.restype = ci
    return lib
