"""Shared CLI driver scaffolding for the example mains.

Replaces the per-dataset boost::program_options parsing + frame loop of
the reference's Examples/*/*.cc (e.g. Examples/Monocular/mono_euroc.cc):
load sequence -> construct System -> feed frames (with synced IMU
batches for inertial configs) -> Shutdown -> save trajectories.

No vocabulary argument: the retrieval codebook is trained online from the
session's own descriptors (runtime/keyframe_database.py), replacing the
145 MB ORBvoc.txt artifact. `--device` picks where the System runs: the
card unless it says "cpu".
"""

from __future__ import annotations

import argparse
import logging
import sys
import time


def base_parser(desc: str) -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("settings", help="File.version 1.0 YAML settings")
    p.add_argument("dataset_root", help="dataset root directory")
    p.add_argument(
        "sequence", nargs="+",
        help="sequence name(s); multiple run back-to-back with "
        "System.change_dataset() between them (reference multi-session "
        "runs, Examples/Monocular/mono_euroc.cc num_seq)",
    )
    p.add_argument("--timestamps", default=None, help="timestamp list file")
    p.add_argument("--traj", default="CameraTrajectory.txt")
    p.add_argument("--kf-traj", default="KeyFrameTrajectory.txt")
    p.add_argument("--save-atlas", default=None)
    p.add_argument("--load-atlas", default=None)
    p.add_argument("--localization", action="store_true",
                   help="localization-only mode (no mapping)")
    p.add_argument("--realtime", action="store_true",
                   help="sleep to dataset timestamps like the reference")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--log-level", default="INFO")
    p.add_argument("--viewer", action="store_true",
                   help="offline viewer snapshots/exports (viewer_out/)")
    p.add_argument("--live-viewer", action="store_true",
                   help="serve the live map/frame viewer over HTTP "
                   "(Pangolin viewer analog; URL logged at startup)")
    p.add_argument("--live-viewer-port", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device of the System (default: the card; \"cpu\" for the CPU)")
    return p


def viewer_kwargs(args) -> dict:
    """System(...) kwargs for the viewer flags of `base_parser`."""
    return dict(
        use_viewer=getattr(args, "viewer", False),
        live_viewer=getattr(args, "live_viewer", False),
        live_viewer_port=getattr(args, "live_viewer_port", 0),
    )


def setup_logging(level: str):
    logging.basicConfig(
        level=getattr(logging, level.upper()),
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
        stream=sys.stderr,
    )


def pace(t_prev: float | None, t_now: float, wall_prev: float | None):
    """Sleep so frames are delivered at dataset rate
    (Examples/Monocular/mono_euroc.cc:168-176)."""
    wall_now = time.monotonic()
    if t_prev is not None and wall_prev is not None:
        dt_data = t_now - t_prev
        dt_wall = wall_now - wall_prev
        if dt_wall < dt_data:
            time.sleep(dt_data - dt_wall)
    return time.monotonic()


def finish(slam, args, stamps=None):
    slam.save_trajectory_tum(args.traj)
    slam.save_keyframe_trajectory_tum(args.kf_traj)
    stats = slam.shutdown(save_atlas_path=args.save_atlas)
    tt = stats.get("track_total")
    if tt:
        print(
            f"frames: {tt['count']}  mean track: {tt['mean_ms']:.1f} ms "
            f"({1000.0 / max(tt['mean_ms'], 1e-9):.1f} fps)"
        )
