"""Native (C++) runtime components, loaded via ctypes.

`mapgraph.cpp` is compiled at first use with the system g++ into a shared
library under the package's `build/` directory (never next to the
sources). If no compiler is available `load()` returns None and callers
use the pure-numpy paths (models/map_state.py): the native core speeds up
the host-side graph bookkeeping and is not a correctness dependency.
`backend()` says which of the two is in use.
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading

import numpy as np

log = logging.getLogger("orbslam3_torch.native")

_HERE = os.path.dirname(__file__)
_SRC = os.path.join(_HERE, "mapgraph.cpp")
_BUILD = os.path.join(os.path.dirname(_HERE), "build")
_SO = os.path.join(_BUILD, "_mapgraph.so")
_lock = threading.Lock()
_lib = None
_tried = False


def _build() -> str | None:
    if os.path.exists(_SO) and os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
        return _SO
    # Compile to a private name, then rename: a concurrent process never
    # loads a half-written library.
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp]
    try:
        os.makedirs(_BUILD, exist_ok=True)
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return _SO
    except Exception as e:  # pragma: no cover - depends on toolchain
        log.warning("native mapgraph build failed: %s", e)
        return None


def load():
    """Returns the ctypes library or None."""
    global _lib, _tried
    with _lock:
        if _tried:
            return _lib
        _tried = True
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(so)
        i32 = ctypes.c_int32
        p = ctypes.c_void_p
        ip = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        lib.mg_create.restype = p
        lib.mg_create.argtypes = [i32, i32]
        lib.mg_destroy.argtypes = [p]
        lib.mg_add_keyframe.argtypes = [p, i32]
        lib.mg_add_observations.argtypes = [p, i32, ip, i32]
        lib.mg_remove_observations.argtypes = [p, i32, ip, i32]
        lib.mg_remove_landmark.argtypes = [p, i32]
        lib.mg_remove_keyframe.argtypes = [p, i32]
        lib.mg_covis_weight.restype = i32
        lib.mg_covis_weight.argtypes = [p, i32, i32]
        lib.mg_covis_row.argtypes = [p, i32, ip]
        lib.mg_covis_neighbors.restype = i32
        lib.mg_covis_neighbors.argtypes = [p, i32, i32, i32, ip]
        lib.mg_parent.restype = i32
        lib.mg_parent.argtypes = [p, i32]
        lib.mg_set_parent.argtypes = [p, i32, i32]
        lib.mg_add_loop_edge.argtypes = [p, i32, i32]
        lib.mg_essential_edges.restype = i32
        lib.mg_essential_edges.argtypes = [p, i32, i32, ip]
        lib.mg_lm_observers.restype = i32
        lib.mg_lm_observers.argtypes = [p, i32, i32, ip]
        lib.mg_kf_landmarks.restype = i32
        lib.mg_kf_landmarks.argtypes = [p, i32, i32, ip]
        lib.mg_n_obs.restype = i32
        lib.mg_n_obs.argtypes = [p, i32]
        _lib = lib
        return _lib


def backend() -> str:
    """"native" when the C++ map graph is built and loaded, else "numpy"."""
    return "native" if load() is not None else "numpy"


class MapGraph:
    """ctypes wrapper over the native covisibility/spanning-tree core.

    API mirrors the reference KeyFrame graph duties: incremental
    covisibility (UpdateConnections), ordered neighbor queries
    (GetBestCovisibilityKeyFrames), spanning tree with cull re-parenting
    (SetBadFlag), loop edges, essential-graph edge enumeration."""

    def __init__(self, max_kf: int, max_lm: int):
        lib = load()
        if lib is None:
            raise RuntimeError("native mapgraph unavailable")
        self._lib = lib
        self._h = lib.mg_create(max_kf, max_lm)
        self.max_kf = max_kf
        self.max_lm = max_lm

    def __del__(self):
        try:
            self._lib.mg_destroy(self._h)
        except Exception:
            pass

    def add_keyframe(self, kf: int):
        self._lib.mg_add_keyframe(self._h, kf)

    def add_observations(self, kf: int, lm_ids: np.ndarray):
        a = np.ascontiguousarray(lm_ids, np.int32)
        self._lib.mg_add_observations(self._h, kf, a, len(a))

    def remove_observations(self, kf: int, lm_ids: np.ndarray):
        a = np.ascontiguousarray(lm_ids, np.int32)
        self._lib.mg_remove_observations(self._h, kf, a, len(a))

    def remove_landmark(self, lm: int):
        self._lib.mg_remove_landmark(self._h, lm)

    def remove_keyframe(self, kf: int):
        self._lib.mg_remove_keyframe(self._h, kf)

    def covis_weight(self, a: int, b: int) -> int:
        return int(self._lib.mg_covis_weight(self._h, a, b))

    def covis_row(self, kf: int) -> np.ndarray:
        out = np.zeros(self.max_kf, np.int32)
        self._lib.mg_covis_row(self._h, kf, out)
        return out

    def covis_neighbors(self, kf: int, min_w: int = 15, cap: int = 256):
        out = np.zeros(cap, np.int32)
        n = self._lib.mg_covis_neighbors(self._h, kf, min_w, cap, out)
        return out[:n].copy()

    def parent(self, kf: int) -> int:
        return int(self._lib.mg_parent(self._h, kf))

    def set_parent(self, kf: int, p: int):
        self._lib.mg_set_parent(self._h, kf, p)

    def add_loop_edge(self, a: int, b: int):
        self._lib.mg_add_loop_edge(self._h, a, b)

    def essential_edges(self, min_w: int = 100, cap: int = 4096) -> np.ndarray:
        out = np.zeros(2 * cap, np.int32)
        n = self._lib.mg_essential_edges(self._h, min_w, cap, out)
        return out[: 2 * n].reshape(n, 2).copy()

    def lm_observers(self, lm: int, cap: int = 256) -> np.ndarray:
        out = np.zeros(cap, np.int32)
        n = self._lib.mg_lm_observers(self._h, lm, cap, out)
        return out[:n].copy()

    def kf_landmarks(self, kf: int, cap: int = 8192) -> np.ndarray:
        out = np.zeros(cap, np.int32)
        n = self._lib.mg_kf_landmarks(self._h, kf, cap, out)
        return out[:n].copy()

    def n_obs(self, lm: int) -> int:
        return int(self._lib.mg_n_obs(self._h, lm))
