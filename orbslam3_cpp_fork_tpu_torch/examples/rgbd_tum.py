"""RGB-D TUM driver (reference Examples/RGB-D/rgbd_tum.cc).

Usage: python -m orbslam3_cpp_fork_tpu_torch.examples.rgbd_tum TUM1.yaml /data/tum rgbd_dataset_freiburg1_desk
"""

from .common import base_parser, finish, pace, setup_logging, viewer_kwargs
from ..datasets import tum
from ..runtime.system import System
from ..runtime.tracker import Sensor


def main(argv=None):
    args = base_parser(__doc__).parse_args(argv)
    setup_logging(args.log_level)
    slam = System(args.settings, Sensor.RGBD, load_atlas=args.load_atlas,
                  device=args.device, **viewer_kwargs(args))
    if args.localization:
        slam.activate_localization_mode()
    for si, seq_name in enumerate(args.sequence):
        if si:
            slam.change_dataset()
        seq = tum.load_sequence(args.dataset_root, seq_name)
        wall = t_prev = None
        n = len(seq.rgb_paths) if args.max_frames is None else args.max_frames
        for i in range(n):
            t = float(seq.timestamps[i])
            img = tum.load_gray(seq.rgb_paths[i])
            depth = tum.load_depth(seq.depth_paths[i])
            if args.realtime:
                wall = pace(t_prev, t, wall)
            slam.track_rgbd(img, depth, t)
            t_prev = t
    finish(slam, args)


if __name__ == "__main__":
    main()
