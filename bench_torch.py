#!/usr/bin/env python3
"""The PyTorch port's lane of bench.py's ring, on one CUDA card.

Run from the root of a checkout:  python3 bench_torch.py

Same scene and trajectory as bench.py (the 300-frame synthetic ring at
752x480, 1000 features; `BENCH_FRAMES` shortens it), through the port's
`System` facade with loop closing and the global BA on, as bench.py runs
(the ring's loop comes at about frame 261). Three runs:
an untimed free-running warm-up, the frame-synchronous control (its ATE is
the accuracy of the algorithms with the concurrency layer removed), then the
timed run in the shipping mode (mapping worker, loop worker, pipelined
tracking) with frames delivered at the 20 fps camera rate. Then the stereo
lane, which bench.py never had: chip_smoke.py's stereo scene (the ring of
tests/test_stereo_loop_e2e.py, a 0.2 m rig, 752x480, uint8 pairs) over a
300-frame circle, through `System(..., Sensor.STEREO)` in the shipping
mode, paced at 20 fps. Prints one JSON object, as its last line, with those
of bench.py's keys that exist without the Atlas, the stereo lane's under
"stereo", and the card's name and power limit. Needs a CUDA card and says
so when there is none.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

STEREO_FRAMES = 300  # the stereo lane's circle, as long as the mono lanes' ring


def _render_sequence(n_frames):
    from orbslam3_cpp_fork_tpu_torch.datasets import synthetic

    H, W = 480, 752
    scene = synthetic.make_ring_scene(seed=7, n_points=1200, size_range=(9, 15), width=W, height=H)
    Rs, ts = synthetic.circle_trajectory(n_frames=n_frames, radius=2.5, total_angle=2.3 * np.pi)
    frames = [synthetic.render_frame(scene, Rs[i], ts[i]) for i in range(n_frames)]
    return scene, frames, Rs, ts


def _run_slam(scene, frames, async_mapping=True, paced=False):
    """Run the full pipeline over the sequence. paced=True delivers frames
    at the camera rate (a system that fell behind gets no sleep and the
    lateness shows in the latency distribution); paced=False free-runs."""
    from orbslam3_cpp_fork_tpu_torch.ops.camera import Camera
    from orbslam3_cpp_fork_tpu_torch.runtime.system import System
    from orbslam3_cpp_fork_tpu_torch.utils.settings import Settings

    K = scene.K
    settings = Settings(
        camera_type="PinHole", camera=Camera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2]),
        width=scene.width, height=scene.height, fps=30.0, rgb=False,
        n_features=1000, scale_factor=1.2, n_levels=8, ini_th_fast=20, min_th_fast=7,
    )
    system = System(settings, async_mapping=async_mapping, enable_loop_closing=True)
    stamps = np.arange(len(frames)) * 0.05
    lat = np.zeros(len(frames))
    t_start = time.perf_counter()
    for i, img in enumerate(frames):
        if paced:
            dt = float(stamps[i]) - (time.perf_counter() - t_start)
            if dt > 0:
                time.sleep(dt)
        t0 = time.perf_counter()
        system.track_monocular(img, float(stamps[i]))
        lat[i] = time.perf_counter() - t0
    t_track = time.perf_counter() - t_start
    system.tracker.flush_mapping()  # pipeline + mapping drain
    wall = time.perf_counter() - t_start
    return system, lat, stamps, t_track, wall


def _run_stereo(n_frames):
    """The stereo lane: System(STEREO) in the shipping mode, paced at 20 fps;
    fps, latency, unscaled and scale-aligned ATE, loops."""
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import chip_smoke
    from orbslam3_cpp_fork_tpu_torch.ops.orb import OrbParams
    from orbslam3_cpp_fork_tpu_torch.runtime.tracker import Sensor

    scene, Rs, ts, pairs = chip_smoke.render_stereo_loop(n_frames)
    K = scene.K
    system = chip_smoke.make_system(
        "cuda", scene, OrbParams(n_features=1000), enable_loop_closing=True, sensor=Sensor.STEREO,
        bf=chip_smoke.STEREO_BASELINE * float(K[0, 0]), stereo_th_depth=40.0,
    )
    stamps = np.arange(n_frames) * 0.05
    lat = np.zeros(n_frames)
    t_start = time.perf_counter()
    for i, (l, r) in enumerate(pairs):
        dt = float(stamps[i]) - (time.perf_counter() - t_start)
        if dt > 0:
            time.sleep(dt)
        t0 = time.perf_counter()
        system.track_stereo(l, r, float(stamps[i]))
        lat[i] = time.perf_counter() - t0
    t_track = time.perf_counter() - t_start
    tracker = system.tracker
    ate, coverage = _traj_ate(tracker, stamps, ts, n_frames)
    system.shutdown()
    med, p99 = float(np.median(lat)), float(np.quantile(lat, 0.99))
    return {
        "fps": round(n_frames / t_track, 2), "track_ms_median": round(med * 1e3, 2),
        "track_ms_p99": round(p99 * 1e3, 2), "ate_unit_m": round(float(ate.rmse), 4) if ate else float("nan"),
        "ate_scale": round(float(ate.scale), 4) if ate else float("nan"),
        "ate_scaled_m": round(float(ate.rmse_scaled), 4) if ate else float("nan"),
        "coverage": round(float(coverage), 3), "n_lost_events": int(tracker.n_lost_events),
        "n_loops_closed": int(system.n_loops_closed), "n_keyframes": int(tracker.map.n_keyframes()),
        "n_frames": n_frames,
    }


def _traj_ate(tracker, stamps, ts, n_frames):
    """Exported-trajectory ATE + coverage for one finished run."""
    from orbslam3_cpp_fork_tpu_torch.utils.evaluation import ate_rmse

    ts_est, Twc = tracker.export_trajectory()
    coverage = len(ts_est) / n_frames
    ate = ate_rmse(ts_est, Twc[:, :3, 3], stamps, ts) if len(ts_est) >= 3 else None
    return ate, coverage


def _kf_ate(tracker, ts, n_frames) -> float:
    """Scale-aligned ATE of the keyframe poses themselves: isolates the
    optimized map from the trajectory export path."""
    from orbslam3_cpp_fork_tpu_torch.utils.evaluation import align_umeyama

    m = tracker.map
    valid = np.nonzero(m.kf_valid)[0]
    if len(valid) < 4:
        return float("nan")
    centers = -np.einsum("kji,kj->ki", m.kf_R[valid], m.kf_t[valid])
    gt_kf = ts[np.clip(m.kf_frame_id[valid], 0, n_frames - 1)]
    s_a, R_a, t_a = align_umeyama(centers, gt_kf, with_scale=True)
    resid = np.linalg.norm((s_a * centers @ R_a.T + t_a) - gt_kf, axis=1)
    return float(np.sqrt((resid**2).mean()))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bench_torch: needs a CUDA card (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    n_frames = int(os.environ.get("BENCH_FRAMES", "300"))
    scene, frames, Rs, ts = _render_sequence(n_frames)

    # Warm pass (free-run): builds the kernels, loads every library handle.
    warm, _, _, fr_track, _ = _run_slam(scene, frames)
    warm.shutdown()
    freerun_fps = len(frames) / fr_track

    # Sync-mode control on the same frames, unpaced.
    sync_sys, sync_lat, sync_stamps, sync_t, _ = _run_slam(scene, frames, async_mapping=False)
    sync_ate, sync_cov = _traj_ate(sync_sys.tracker, sync_stamps, ts, len(frames))
    sync_lost = int(sync_sys.tracker.n_lost_events)
    sync_loops = sync_sys.n_loops_closed
    sync_sys.shutdown()

    # Timed pass: frames delivered at the 20 fps camera rate.
    system, lat, stamps, t_track, wall = _run_slam(scene, frames, paced=True)
    tracker = system.tracker
    ate, coverage = _traj_ate(tracker, stamps, ts, len(frames))
    kf_ate = _kf_ate(tracker, ts, len(frames))
    stages = {name: round(s["mean_ms"], 2) for name, s in tracker.timers.summary().items()}
    worker = tracker.worker
    system.shutdown()
    loop_frames = [e["kf_frame"] for e in tracker.loop_closer.events if e["kind"] == "loop"]

    stereo = _run_stereo(STEREO_FRAMES)

    med, p99 = float(np.median(lat)), float(np.quantile(lat, 0.99))
    slow_frames = [
        {"frame": int(i), "ms": round(float(lat[i]) * 1e3, 1), "causes": tracker.frame_causes.get(int(i), [])}
        for i in np.nonzero(lat > 0.15)[0]
    ][:40]
    e2e_fps = len(frames) / t_track
    print(json.dumps({
        "metric": "slam_e2e_fps_per_card",
        "value": round(float(e2e_fps), 2),
        "unit": "frames/s",
        "card": card,
        "device": torch.cuda.get_device_name(0),
        "vs_baseline": round(float(e2e_fps) / 20.0, 3),
        "fps_with_flush": round(len(frames) / wall, 2),
        "track_ms_median": round(med * 1e3, 2),
        "track_ms_p99": round(p99 * 1e3, 2),
        "p99_over_median": round(p99 / max(med, 1e-9), 2),
        "n_over_budget": int((lat > 0.05).sum()),
        "freerun_fps": round(float(freerun_fps), 2),
        "ate_scaled_m": round(float(ate.rmse_scaled), 4) if ate else float("nan"),
        "ate_unit_m": round(float(ate.rmse), 4) if ate else float("nan"),
        "ate_n_pairs": int(ate.n_pairs) if ate else 0,
        "coverage": round(float(coverage), 3),
        "n_lost_events": int(tracker.n_lost_events),
        "n_lost_frames": int(tracker.n_lost_frames),
        "n_frames_dropped": int(tracker.n_frames_dropped),
        "n_pipelined_frames": int(tracker.n_pipelined_frames),
        "n_sync_frames": int(tracker.n_sync_frames),
        "n_fused_declined": int(tracker.n_fused_declined),
        "n_keyframes": int(tracker.map.n_keyframes()),
        "n_loops_closed": int(system.n_loops_closed),
        "loop_kf_frames": loop_frames,
        "sync_n_loops_closed": int(sync_loops),
        "n_kf_skipped_backpressure": int(tracker.n_kf_skipped_backpressure),
        "n_catchup_batches": int(worker.n_batches) if worker else 0,
        "worker_busy_share": round(worker.busy_s / wall, 3) if worker else 0.0,
        "kf_ate_scaled_m": round(kf_ate, 4),
        "ate_sync_m": round(float(sync_ate.rmse_scaled), 4) if sync_ate else float("nan"),
        "sync_coverage": round(float(sync_cov), 3),
        "sync_n_lost_events": sync_lost,
        "sync_fps": round(len(frames) / sync_t, 2),
        "sync_track_ms_median": round(float(np.median(sync_lat)) * 1e3, 2),
        "n_frames": len(frames),
        "stage_ms_mean": stages,
        "slow_frames": slow_frames,
        "stereo": stereo,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
