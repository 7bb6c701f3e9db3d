"""Stereo TUM-VI driver (reference Examples/Stereo/stereo_tum_vi.cc):
512x512 Kannala-Brandt fisheye stereo, vision only. The unrectified rig
goes through the fisheye stereo path (descriptor match in the lapping
area + batched triangulation, ops/stereo.match_stereo_fisheye).

Usage: python -m orbslam3_cpp_fork_tpu_torch.examples.stereo_tumvi TUM-VI.yaml /data/tumvi room1
"""

from .common import base_parser, finish, pace, setup_logging, viewer_kwargs
from ..datasets import tumvi
from ..runtime.system import System
from ..runtime.tracker import Sensor


def main(argv=None):
    args = base_parser(__doc__).parse_args(argv)
    setup_logging(args.log_level)
    slam = System(args.settings, Sensor.STEREO, load_atlas=args.load_atlas,
                  device=args.device, **viewer_kwargs(args))
    for si, seq_name in enumerate(args.sequence):
        if si:
            slam.change_dataset()
        seq = tumvi.load_sequence(
            args.dataset_root, seq_name, args.timestamps, stereo=True
        )
        wall = t_prev = None
        n = len(seq.image_paths) if args.max_frames is None else args.max_frames
        for i in range(n):
            t = float(seq.timestamps[i])
            left = tumvi.load_gray(seq.image_paths[i])
            right = tumvi.load_gray(seq.image_paths_right[i])
            if args.realtime:
                wall = pace(t_prev, t, wall)
            slam.track_stereo(left, right, t)
            t_prev = t
    finish(slam, args)


if __name__ == "__main__":
    main()
