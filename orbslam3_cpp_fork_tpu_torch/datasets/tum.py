"""TUM RGB-D dataset loader.

Replaces src/Common/TUM.cc: the TUM RGB-D layout is

  <root>/<seq>/rgb.txt        # "timestamp rgb/<t>.png" lines
  <root>/<seq>/depth.txt      # "timestamp depth/<t>.png"
  <root>/<seq>/groundtruth.txt

RGB and depth run on separate clocks; `associate` pairs them by nearest
timestamp within max_dt (evaluation/associate.py semantics). Depth PNGs
are 16-bit with factor 5000 (the reference's DepthMapFactor).

(Copy of datasets/tum.py: numpy only.)
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from .euroc import load_gray

DEPTH_FACTOR = 5000.0


@dataclasses.dataclass
class TumSequence:
    rgb_paths: list
    depth_paths: list
    timestamps: np.ndarray  # seconds (rgb clock)


def _read_list(path: str) -> tuple[np.ndarray, list]:
    ts, files = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t, rel = line.split()[:2]
            ts.append(float(t))
            files.append(rel)
    return np.asarray(ts), files


def associate(ts_a: np.ndarray, ts_b: np.ndarray, max_dt: float = 0.02):
    """Nearest-timestamp pairing (evaluation/associate.py)."""
    ia, ib = [], []
    j = 0
    for i, t in enumerate(ts_a):
        j = int(np.argmin(np.abs(ts_b - t)))
        if abs(ts_b[j] - t) <= max_dt:
            ia.append(i)
            ib.append(j)
    return np.asarray(ia, np.int64), np.asarray(ib, np.int64)


def load_sequence(root: str, seq: str, max_dt: float = 0.02) -> TumSequence:
    base = os.path.join(root, seq)
    ts_rgb, rgb = _read_list(os.path.join(base, "rgb.txt"))
    ts_d, dep = _read_list(os.path.join(base, "depth.txt"))
    ia, ib = associate(ts_rgb, ts_d, max_dt)
    return TumSequence(
        rgb_paths=[os.path.join(base, rgb[i]) for i in ia],
        depth_paths=[os.path.join(base, dep[j]) for j in ib],
        timestamps=ts_rgb[ia],
    )


def load_depth(path: str, factor: float = DEPTH_FACTOR) -> np.ndarray:
    """16-bit depth PNG -> meters (0 = no reading)."""
    from PIL import Image

    d = np.asarray(Image.open(path), np.float32)
    return d / factor


__all__ = ["TumSequence", "load_sequence", "load_depth", "load_gray", "associate"]
