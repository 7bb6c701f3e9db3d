"""RGB-D-inertial driver (reference Examples/RGB-D-Inertial/
rgbd_inertial_realsense_D435i.cc is live-camera only; this file-based
driver covers the same sensor config from a TUM-RGBD-layout sequence
with an added accelerometer.txt/gyroscope.txt or EuRoC-style imu csv).

Usage: python -m orbslam3_cpp_fork_tpu_torch.examples.rgbd_inertial RealSense.yaml /data/seqroot seq
"""

import os

import numpy as np

from .common import base_parser, finish, pace, setup_logging, viewer_kwargs
from ..datasets import tum
from ..datasets.euroc import ImuRecord, imu_between
from ..runtime.system import System
from ..runtime.tracker import Sensor


def _load_imu(base: str) -> ImuRecord | None:
    """EuRoC-style csv (t_ns, gx, gy, gz, ax, ay, az) at <seq>/imu.csv."""
    path = os.path.join(base, "imu.csv")
    if not os.path.exists(path):
        return None
    rows = np.loadtxt(path, delimiter=",", comments="#")
    return ImuRecord(
        rows[:, 0] * 1e-9,
        rows[:, 1:4].astype(np.float32),
        rows[:, 4:7].astype(np.float32),
    )


def main(argv=None):
    args = base_parser(__doc__).parse_args(argv)
    setup_logging(args.log_level)
    slam = System(args.settings, Sensor.IMU_RGBD, load_atlas=args.load_atlas,
                  device=args.device, **viewer_kwargs(args))
    for si, seq_name in enumerate(args.sequence):
        if si:
            slam.change_dataset()
        seq = tum.load_sequence(args.dataset_root, seq_name)
        imu = _load_imu(os.path.join(args.dataset_root, seq_name))
        assert imu is not None, "sequence has no imu.csv"
        wall = t_prev = None
        n = len(seq.rgb_paths) if args.max_frames is None else args.max_frames
        for i in range(n):
            t = float(seq.timestamps[i])
            img = tum.load_gray(seq.rgb_paths[i])
            depth = tum.load_depth(seq.depth_paths[i])
            rows = None
            if t_prev is not None:
                acc, gyro, _ = imu_between(imu, t_prev, t)
                sel = (imu.timestamps > t_prev) & (imu.timestamps <= t)
                ts_sel = imu.timestamps[sel]
                rows = np.concatenate(
                    [ts_sel[:, None], acc, gyro], axis=1
                ).astype(np.float32)
            if args.realtime:
                wall = pace(t_prev, t, wall)
            slam.track_rgbd(img, depth, t, imu=rows)
            t_prev = t
    finish(slam, args)


if __name__ == "__main__":
    main()
