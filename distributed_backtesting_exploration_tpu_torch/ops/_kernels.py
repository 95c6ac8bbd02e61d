"""Build, load and launch count of the port's hand-written CUDA kernels.

Each kernel source under ``csrc/`` is compiled with ``nvcc`` into a shared
library with a plain C interface and loaded with ``ctypes``. The build runs
at first use, never at import (the CPU test machines have no ``nvcc``),
into ``_build/`` inside the package (listed in ``.gitignore``). The library
name carries a hash of the source, the shared headers (``csrc/*.cuh``) and
the flags, so an edited source or header is rebuilt rather than reused.

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


def build(name: str, defines: tuple[str, ...] = ()) -> Path:
    """Compile ``csrc/<name>.cu`` into ``_build/`` (if not already built)
    and return the library path. ``defines`` (``"NAME=VALUE"``) go to nvcc
    as ``-D`` flags: a source's build-time settings, which only a sweep
    over them sets."""
    src = SRC_DIR / f"{name}.cu"
    flags = (*NVCC_FLAGS, *(f"-D{d}" for d in defines))
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(flags).encode())
    digest = h.hexdigest()[:16]
    lib = BUILD_DIR / f"lib{name}-{digest}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *flags, "-o", tmp, str(src)],
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


_VP, _CI, _CF = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_PI = ctypes.POINTER(ctypes.c_int)

# C signature of every entry point, by library: pointers as c_void_p (a
# plain int would cut them to 32 bits), then the sizes and scalars.
_SIGNATURES = {
    "fused_sma": {
        "dbx_fused_sma": [_VP] * 9 + [_CI] * 5 + [_CF, _CI, _VP],
        "dbx_fused_sma_occupancy": [_CI, _CI, _PI],
        "dbx_obv": [_VP] * 9 + [_CI] * 5 + [_CF, _CI, _VP],
        "dbx_obv_occupancy": [_CI, _CI, _PI],
    },
    "band_machine": {
        "dbx_band_inline": [_VP] * 12 + [_CI] * 6 + [_CF, _CF, _CI, _VP],
        "dbx_band_inline_occupancy": [_CI, _CI, _PI],
        "dbx_band_table": [_VP] * 8 + [_CI] * 5 + [_CF, _CF, _CI, _VP],
        "dbx_band_stoch": [_VP] * 12 + [_CI] * 4 + [_CF, _CF, _CI, _VP],
        "dbx_pairs": [_VP] * 10 + [_CI] * 6 + [_CF, _CI, _VP],
        "dbx_pairs_occupancy": [_CI, _CI, _PI],
        "dbx_channel_levels": [_CI],
        "dbx_band_occupancy": [_CI, _CI, _PI],
    },
    "single_window": {
        "dbx_momentum": [_VP] * 6 + [_CI] * 3 + [_CF, _CI, _VP],
        "dbx_donchian": [_VP] * 11 + [_CI] * 3 + [_CF, _CI, _VP],
        "dbx_channel_levels": [_CI],
        "dbx_donchian_occupancy": [_CI, _PI],
    },
    "ema_cross": {
        "dbx_macd": [_VP] * 9 + [_CI] * 6 + [_CF, _CI, _VP],
        "dbx_macd_occupancy": [_CI, _CI, _PI],
        "dbx_trix": [_VP] * 9 + [_CI] * 6 + [_CF, _CI, _VP],
        "dbx_trix_occupancy": [_CI, _CI, _PI],
    },
    "ema_rows": {
        "dbx_ema_rows": [_VP] * 4 + [_CI] * 4 + [_VP],
        "dbx_ema_rows_scratch": [_CI],
        "dbx_ema_rows_registers": [_CI],
    },
    "pairs_tables": {
        "dbx_pairs_tables": [_VP] * 8 + [_CI] * 4 + [_VP],
        "dbx_pairs_tables_plan": [_CI] * 4 + [_PI],
    },
    "stages": {
        "dbx_sma_stage": [_VP] * 6 + [_CI] * 7 + [_CF, _CI, _VP],
        "dbx_boll_stage": [_VP] * 6 + [_CI] * 7 + [_CF, _CI, _VP],
        "dbx_stage_occupancy": [_CI] * 6 + [_PI],
    },
}


def _typed(name: str) -> ctypes.CDLL:
    lib = load(name)
    for entry, argtypes in _SIGNATURES[name].items():
        fn = getattr(lib, entry)
        if fn.argtypes is None:
            fn.argtypes = argtypes
            fn.restype = _CI
    return lib


def fused_sma_lib() -> ctypes.CDLL:
    """K1's and K6's library (``csrc/fused_sma.cu``): ``dbx_fused_sma`` and
    ``dbx_obv``."""
    return _typed("fused_sma")


def band_machine_lib() -> ctypes.CDLL:
    """K2's and K7's library (``csrc/band_machine.cu``):
    ``dbx_band_inline``, ``dbx_band_table``, ``dbx_band_stoch`` and
    ``dbx_pairs``."""
    return _typed("band_machine")


def single_window_lib() -> ctypes.CDLL:
    """K3's library (``csrc/single_window.cu``): ``dbx_momentum`` and
    ``dbx_donchian``."""
    return _typed("single_window")


def ema_cross_lib() -> ctypes.CDLL:
    """K4's and K5's library (``csrc/ema_cross.cu``): ``dbx_macd`` and
    ``dbx_trix``."""
    return _typed("ema_cross")


def ema_rows_lib() -> ctypes.CDLL:
    """The EMA-table library (``csrc/ema_rows.cu``): ``dbx_ema_rows``, the
    EMA table K4 reads and the triple-EMA table K5 reads."""
    return _typed("ema_rows")


def pairs_tables_lib() -> ctypes.CDLL:
    """K7's table library (``csrc/pairs_tables.cu``): ``dbx_pairs_tables``,
    the spread z-table and hedged-return table."""
    return _typed("pairs_tables")


def stages_lib() -> ctypes.CDLL:
    """K8's library (``csrc/stages.cu``), the roofline stage scaffolds:
    ``dbx_sma_stage`` and ``dbx_boll_stage``."""
    return _typed("stages")
