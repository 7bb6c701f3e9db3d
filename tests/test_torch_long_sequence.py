"""tests/test_long_sequence.py on the port (slow): 560 noisy frames at
640x480, two laps of a 2.5 m circle, synchronous with loop closing, with
that test's four gates as they are: the run survives, the revisit closes a
loop, culling bounds the map, and the ATE holds. The scene, frames and
configuration are chip_smoke.py's long phase's (render_long, long_frames,
long_config), the reference test's own.

The reference test's ATE takes -(R^T t) of camera-to-world poses as the
ground-truth positions: on this circle that is (0, 0, -2.5) for every
frame, so its gate passes for any trajectory (ROADMAP R20). The port's gate
is the same bar on the true camera centres t_wc; both numbers are printed,
and `test_reference_on_the_same_frames` prints the reference tracker's on
the same frames.
"""

import numpy as np
import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.slow

N = chip_smoke.LONG_FRAMES


def _run(make_tracker):
    scene, stamps, Rs, ts = chip_smoke.render_long()
    tracker = make_tracker(scene)
    n_tracked = 0
    for i, img in enumerate(chip_smoke.long_frames(scene, Rs, ts)):
        if tracker.track(img, float(stamps[i])) is not None:
            n_tracked += 1
    return tracker, stamps, Rs, ts, n_tracked


def _ates(tracker, stamps, Rs, ts):
    from orbslam3_cpp_fork_tpu_torch.utils.evaluation import ate_rmse

    ts_est, Twc = tracker.export_trajectory()
    true = ate_rmse(ts_est, Twc[:, :3, 3], stamps, ts)
    constant = ate_rmse(ts_est, Twc[:, :3, 3], stamps, np.stack([-(R.T @ t) for R, t in zip(Rs, ts)]))
    return ts_est, true, constant


@pytest.fixture(scope="module")
def long_run():
    from orbslam3_cpp_fork_tpu_torch.runtime.tracker import Tracker

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield _run(lambda scene: Tracker(chip_smoke.long_config(scene), "cpu"))
    finally:
        torch.set_num_threads(n)


def test_long_sequence_survives(long_run):
    from orbslam3_cpp_fork_tpu_torch.runtime.tracker import TrackState

    tracker, stamps, Rs, ts, n_tracked = long_run
    assert tracker.state == TrackState.OK
    assert n_tracked > 0.88 * N, n_tracked


def test_long_sequence_revisit_closes_loop(long_run):
    tracker, *_ = long_run
    assert tracker.loop_closer.n_loops_closed >= 1


def test_long_sequence_culling_bounds_map(long_run):
    tracker, *_ = long_run
    n_kf = tracker.map.n_keyframes()
    assert n_kf < 0.45 * N, n_kf
    assert tracker.map.n_landmarks() < tracker.map.cfg.max_landmarks


def test_long_sequence_ate(long_run, capsys):
    tracker, stamps, Rs, ts, n_tracked = long_run
    ts_est, res, constant = _ates(tracker, stamps, Rs, ts)
    with capsys.disabled():
        print(f"\nlong sequence, port: {n_tracked} tracked, {len(ts_est)} exported, {tracker.map.n_keyframes()} "
              f"keyframes of {tracker.n_kf_inserted} inserted, {tracker.map.n_landmarks()} landmarks, "
              f"{tracker.loop_closer.n_loops_closed} loops; scale-aligned ATE {res.rmse_scaled!r} m against t_wc "
              f"(scale {res.scale:.4f}), {constant.rmse_scaled!r} m against the reference test's -(R^T t)")
    assert len(ts_est) > 0.85 * N
    assert res.rmse_scaled < 0.12, res


def test_reference_on_the_same_frames(capsys):
    """The reference tracker on the same frames and configuration: its four
    gates' numbers, printed beside the port's (PERF.md)."""
    from orbslam3_cpp_fork_tpu.ops.camera import Camera
    from orbslam3_cpp_fork_tpu.ops.orb import OrbParams
    from orbslam3_cpp_fork_tpu.runtime.tracker import Tracker, TrackerConfig, TrackState

    def make(scene):
        K = scene.K
        return Tracker(TrackerConfig(async_mapping=False, camera=Camera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2]),
                                     width=scene.width, height=scene.height,
                                     orb=OrbParams(n_features=chip_smoke.LONG_FEATURES), enable_loop_closing=True))

    tracker, stamps, Rs, ts, n_tracked = _run(make)
    ts_est, res, constant = _ates(tracker, stamps, Rs, ts)
    with capsys.disabled():
        print(f"\nlong sequence, reference: state {tracker.state.name}, {n_tracked} tracked, {len(ts_est)} exported, "
              f"{tracker.map.n_keyframes()} keyframes, {tracker.map.n_landmarks()} landmarks, "
              f"{tracker.loop_closer.n_loops_closed} loops; scale-aligned ATE {res.rmse_scaled!r} m against t_wc "
              f"(scale {res.scale:.4f}), {constant.rmse_scaled!r} m against its test's -(R^T t)")
    assert tracker.state == TrackState.OK and np.isfinite(res.rmse_scaled)
