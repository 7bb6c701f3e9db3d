"""KITTI odometry dataset loader.

Replaces src/Common/KITTI.cc: grayscale stereo layout

  <root>/sequences/<seq>/image_0/%06d.png   # left
  <root>/sequences/<seq>/image_1/%06d.png   # right
  <root>/sequences/<seq>/times.txt          # seconds per frame

(Copy of datasets/kitti.py: numpy only.)
"""

from __future__ import annotations

import dataclasses
import glob
import os

import numpy as np

from .euroc import load_gray  # noqa: F401  (re-export for drivers)


@dataclasses.dataclass
class KittiSequence:
    image_paths: list  # image_0
    image_paths_right: list  # image_1
    timestamps: np.ndarray


def load_sequence(root: str, seq: str, stereo: bool = True) -> KittiSequence:
    base = os.path.join(root, "sequences", seq)
    with open(os.path.join(base, "times.txt")) as f:
        ts = np.asarray([float(x) for x in f.read().split()], np.float64)
    left = sorted(glob.glob(os.path.join(base, "image_0", "*.png")))[: len(ts)]
    right = (
        sorted(glob.glob(os.path.join(base, "image_1", "*.png")))[: len(ts)]
        if stereo
        else []
    )
    return KittiSequence(image_paths=left, image_paths_right=right, timestamps=ts)
