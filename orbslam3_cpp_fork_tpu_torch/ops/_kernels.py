"""Build and load the package's CUDA kernels (plain C entry points, ctypes).

Each `csrc/*.cu` file is compiled with nvcc for Hopper (sm_90a) into a
shared library under the package's `build/` directory the first time a
kernel is launched, and loaded with ctypes. The library's name carries a
hash of its source, so an edited kernel is rebuilt and a stale one is
never loaded. Nothing here runs at import time: machines without nvcc
(and the CPU tests) import this module freely.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_libs: dict[str, ctypes.CDLL] = {}
# name -> (seconds spent compiling, compiler's stderr: ptxas register and
# shared-memory report); empty for a library found already built.
build_info: dict[str, tuple[float, str]] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def build(name: str) -> Path:
    """Compile csrc/<name>.cu (if not built yet) and return the .so path."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"lib{name}_{digest}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(src)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stderr}")
        os.replace(tmp, so)  # atomic: concurrent builders never see half a file
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    build_info[name] = (time.perf_counter() - t0, proc.stderr)
    return so


def build_all() -> list[str]:
    """Compile every csrc/*.cu, one nvcc each, all started together."""
    names = sorted(src.stem for src in CSRC.glob("*.cu"))
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(build, names))
    return names


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built on first use."""
    lib = _libs.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _libs[name] = lib
    return lib


def patch_gather_fn():
    """ctypes handle of `patch_gather` (csrc/patch_gather.cu)."""
    fn = load("patch_gather").patch_gather
    fn.argtypes = [ctypes.POINTER(LevelTable)] + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


MAX_LEVELS = 8


class LevelTable(ctypes.Structure):
    """Per-level pointers, shapes and keypoint start offsets of one
    `orb_describe` or `patch_gather` launch; mirrors `struct LevelTable` of
    csrc/orb_describe.cu and csrc/patch_gather.cu field for field. It is a
    launch argument, so nothing is uploaded when the level buffers change
    from frame to frame."""

    _fields_ = [
        ("raw", ctypes.c_void_p * MAX_LEVELS),
        ("blur", ctypes.c_void_p * MAX_LEVELS),
        ("h", ctypes.c_int * MAX_LEVELS),
        ("w", ctypes.c_int * MAX_LEVELS),
        ("start", ctypes.c_int * (MAX_LEVELS + 1)),
        ("n_levels", ctypes.c_int),
    ]


def orb_describe_fn():
    """ctypes handle of `orb_describe` (csrc/orb_describe.cu)."""
    fn = load("orb_describe").orb_describe
    fn.argtypes = [ctypes.POINTER(LevelTable)] + [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn
