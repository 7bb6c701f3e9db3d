"""Monocular KITTI driver (reference Examples/Monocular/mono_kitti.cc).

Usage: python -m orbslam3_cpp_fork_tpu_torch.examples.mono_kitti KITTI00-02.yaml /data/kitti 00
"""

from .common import base_parser, finish, pace, setup_logging, viewer_kwargs
from ..datasets import kitti
from ..runtime.system import System
from ..runtime.tracker import Sensor


def main(argv=None):
    args = base_parser(__doc__).parse_args(argv)
    setup_logging(args.log_level)
    slam = System(args.settings, Sensor.MONOCULAR, load_atlas=args.load_atlas,
                  device=args.device, **viewer_kwargs(args))
    if args.localization:
        slam.activate_localization_mode()
    for si, seq_name in enumerate(args.sequence):
        if si:
            slam.change_dataset()
        seq = kitti.load_sequence(args.dataset_root, seq_name, stereo=False)
        wall = t_prev = None
        n = len(seq.image_paths) if args.max_frames is None else args.max_frames
        for i in range(n):
            t = float(seq.timestamps[i])
            img = kitti.load_gray(seq.image_paths[i])
            if args.realtime:
                wall = pace(t_prev, t, wall)
            slam.track_monocular(img, t)
            t_prev = t
    finish(slam, args)


if __name__ == "__main__":
    main()
