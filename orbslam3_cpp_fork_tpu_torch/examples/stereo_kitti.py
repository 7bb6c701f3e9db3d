"""Stereo KITTI odometry driver (reference Examples/Stereo/stereo_kitti.cc).

Usage: python -m orbslam3_cpp_fork_tpu_torch.examples.stereo_kitti KITTI00-02.yaml /data/kitti 00
"""

from .common import base_parser, finish, pace, setup_logging, viewer_kwargs
from ..datasets import kitti
from ..runtime.system import System
from ..runtime.tracker import Sensor


def main(argv=None):
    args = base_parser(__doc__).parse_args(argv)
    setup_logging(args.log_level)
    slam = System(args.settings, Sensor.STEREO, load_atlas=args.load_atlas,
                  device=args.device, **viewer_kwargs(args))
    if args.localization:
        slam.activate_localization_mode()
    for si, seq_name in enumerate(args.sequence):
        if si:
            slam.change_dataset()
        seq = kitti.load_sequence(args.dataset_root, seq_name, stereo=True)
        wall = t_prev = None
        n = len(seq.image_paths) if args.max_frames is None else args.max_frames
        for i in range(n):
            t = float(seq.timestamps[i])
            left = kitti.load_gray(seq.image_paths[i])
            right = kitti.load_gray(seq.image_paths_right[i])
            if args.realtime:
                wall = pace(t_prev, t, wall)
            slam.track_stereo(left, right, t)
            t_prev = t
        # KITTI evaluation wants the 12-float matrix format too.
        slam.save_trajectory_kitti(args.traj.rsplit(".", 1)[0] + "_kitti.txt")
    finish(slam, args)


if __name__ == "__main__":
    main()
