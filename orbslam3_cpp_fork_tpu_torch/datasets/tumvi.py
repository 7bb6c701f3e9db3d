"""TUM-VI dataset loader.

Replaces src/Common/TUMVI.cc: TUM-VI ships in the same ASL/EuRoC folder
layout (`dataset-<seq>_512_16/mav0/{cam0,cam1,imu0}`), 512x512 fisheye
(Kannala-Brandt) stereo at 20 Hz with a 200 Hz IMU, so the directory
walking and CSV parsing are shared with the EuRoC loader.

`default_settings()` provides the reference's TUM-VI calibration
(Examples/Stereo-Inertial/TUM-VI.yaml) for driving sequences without a
YAML file.

(Copy of datasets/tumvi.py: numpy only.)
"""

from __future__ import annotations

import os

import numpy as np

from . import euroc
from ..ops.camera import Camera

EurocSequence = euroc.EurocSequence
load_gray = euroc.load_gray
imu_between = euroc.imu_between


def load_sequence(
    root: str, seq: str, timestamp_file: str | None = None, stereo: bool = False
) -> EurocSequence:
    """seq may be the plain name ("room1") or the on-disk folder
    ("dataset-room1_512_16")."""
    candidates = [seq, f"dataset-{seq}_512_16", f"dataset-{seq}"]
    for c in candidates:
        if os.path.isdir(os.path.join(root, c, "mav0")):
            return euroc.load_sequence(root, c, timestamp_file, stereo)
    raise FileNotFoundError(
        f"TUM-VI sequence {seq!r} not found under {root!r} (tried {candidates})"
    )


def default_cameras() -> tuple[Camera, Camera, np.ndarray]:
    """(cam_left, cam_right, T_c1_c2) from the reference TUM-VI YAML
    (Examples/Stereo-Inertial/TUM-VI.yaml)."""
    cam1 = Camera.kb8(
        190.97847715128717, 190.9733070521226,
        254.93170605935475, 256.8974428996504,
        k1=0.0034823894022493434, k2=0.0007150348452162257,
        k3=-0.0020532361418706202, k4=0.00020293673591811182,
    )
    cam2 = Camera.kb8(
        190.44236969414825, 190.4344384721956,
        252.59949716835982, 254.91723064636983,
        k1=0.0034003170790442797, k2=0.001766278153469831,
        k3=-0.00266312569781606, k4=0.0003299517423931039,
    )
    T12 = np.array(
        [
            [0.999999445773493, 0.000791687752817, 0.000694034010224, 0.101063427414194],
            [-0.000823363992158, 0.998899461915674, 0.046895490788700, 0.001946204678584],
            [-0.000656143613644, -0.046896036240590, 0.998899560146304, 0.001015350132563],
            [0.0, 0.0, 0.0, 1.0],
        ],
        np.float64,
    )
    return cam1, cam2, T12
