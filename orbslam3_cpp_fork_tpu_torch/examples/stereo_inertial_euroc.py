"""Stereo-inertial EuRoC driver
(reference Examples/Stereo-Inertial/stereo_inertial_euroc.cc).

Usage: python -m orbslam3_cpp_fork_tpu_torch.examples.stereo_inertial_euroc EuRoC.yaml /data/euroc MH01
"""

import numpy as np

from .common import base_parser, finish, pace, setup_logging, viewer_kwargs
from ..datasets import euroc
from ..runtime.system import System
from ..runtime.tracker import Sensor


def main(argv=None):
    args = base_parser(__doc__).parse_args(argv)
    setup_logging(args.log_level)
    slam = System(args.settings, Sensor.IMU_STEREO, load_atlas=args.load_atlas,
                  device=args.device, **viewer_kwargs(args))
    for si, seq_name in enumerate(args.sequence):
        if si:
            slam.change_dataset()
        seq = euroc.load_sequence(
            args.dataset_root, seq_name, args.timestamps, stereo=True
        )
        assert seq.imu is not None, "sequence has no imu0/data.csv"
        wall = t_prev = None
        n = len(seq.image_paths) if args.max_frames is None else args.max_frames
        for i in range(n):
            t = float(seq.timestamps[i])
            left = euroc.load_gray(seq.image_paths[i])
            right = euroc.load_gray(seq.image_paths_right[i])
            rows = None
            if t_prev is not None:
                acc, gyro, _ = euroc.imu_between(seq.imu, t_prev, t)
                sel = (seq.imu.timestamps > t_prev) & (seq.imu.timestamps <= t)
                ts_sel = seq.imu.timestamps[sel]
                rows = np.concatenate(
                    [ts_sel[:, None], acc, gyro], axis=1
                ).astype(np.float32)
            if args.realtime:
                wall = pace(t_prev, t, wall)
            slam.track_stereo(left, right, t, imu=rows)
            t_prev = t
    finish(slam, args)


if __name__ == "__main__":
    main()
