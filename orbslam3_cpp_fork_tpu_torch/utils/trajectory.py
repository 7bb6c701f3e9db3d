"""Trajectory import/export in TUM / EuRoC / KITTI formats (copy of
utils/trajectory.py; the quaternions come from the port's utils/lie.py).

Replaces System::SaveTrajectoryTUM, SaveTrajectoryEuRoC,
SaveKeyFrameTrajectoryEuRoC and SaveTrajectoryKITTI. Poses here are
camera-to-world 4x4 (Twc); TUM lines are `timestamp tx ty tz qx qy qz qw`.
Host-side file code: the conversions run on the CPU in float32, as the
reference's do.
"""

from __future__ import annotations

import numpy as np

import torch

from . import lie


def write_tum(path: str, timestamps: np.ndarray, Twc: np.ndarray, scale_ts: float = 1.0):
    """Write TUM-format trajectory. `Twc` is (N,4,4)."""
    q = lie.rot_to_quat_files(torch.from_numpy(np.asarray(Twc[:, :3, :3], np.float32))).numpy()
    t = Twc[:, :3, 3]
    with open(path, "w") as f:
        for i in range(len(timestamps)):
            f.write(
                "%.9f %.7f %.7f %.7f %.7f %.7f %.7f %.7f\n"
                % (
                    timestamps[i] * scale_ts,
                    t[i, 0], t[i, 1], t[i, 2],
                    q[i, 0], q[i, 1], q[i, 2], q[i, 3],
                )
            )


def read_tum(path: str):
    """Read TUM-format trajectory -> (timestamps, Twc (N,4,4))."""
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = [float(x) for x in line.replace(",", " ").split()]
            if len(vals) >= 8:
                rows.append(vals[:8])
    arr = np.asarray(rows)
    if len(arr) == 0:
        return np.zeros(0), np.zeros((0, 4, 4))
    ts = arr[:, 0]
    t = arr[:, 1:4]
    q = arr[:, 4:8]  # qx qy qz qw
    R = lie.quat_to_rot(torch.from_numpy(q.astype(np.float32))).numpy()
    T = np.tile(np.eye(4), (len(arr), 1, 1))
    T[:, :3, :3] = R
    T[:, :3, 3] = t
    return ts, T


def write_kitti(path: str, Twc: np.ndarray):
    """KITTI format: 12 numbers per line, row-major 3x4 of Twc."""
    with open(path, "w") as f:
        for T in Twc:
            f.write(" ".join("%.9e" % x for x in T[:3, :4].reshape(-1)) + "\n")


def read_euroc_gt(path: str):
    """EuRoC ground-truth CSV (state_groundtruth_estimate0/data.csv):
    timestamp_ns, p_xyz, q_wxyz, ... -> (timestamps_s, positions)."""
    ts, pos = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            v = line.strip().split(",")
            if len(v) >= 8:
                ts.append(float(v[0]) * 1e-9)
                pos.append([float(v[1]), float(v[2]), float(v[3])])
    return np.asarray(ts), np.asarray(pos)
