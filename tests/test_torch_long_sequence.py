"""tests/test_long_sequence.py on the port (slow): 560 noisy frames at
640x480, two laps of a 2.5 m circle, synchronous with loop closing, with
that test's four gates as they are: the run survives, the revisit closes a
loop, culling bounds the map, and the ATE holds. The scene, frames and
configuration are chip_smoke.py's long phase's (render_long, long_frames,
long_config), the reference test's own.

After every closed loop the tests print its ground truth (the two
frames' centre distance and the angle of their optical axes, beside the
loop phase's 30-degree bar of a true revisit) and the keyframe ATE after
each stage of its correction (chip_smoke.record_loop_stages), for the port
and for the reference, the reference also in a plain process (ROADMAP C4).

The reference test's ATE takes -(R^T t) of camera-to-world poses as the
ground-truth positions: on this circle that is (0, 0, -2.5) for every
frame, so its gate passes for any trajectory (ROADMAP R20). The port's gate
is the same bar on the true camera centres t_wc; both numbers are printed,
and `test_reference_on_the_same_frames` prints the reference tracker's on
the same frames.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke

pytestmark = pytest.mark.slow

N = chip_smoke.LONG_FRAMES


def _run(make_tracker):
    scene, stamps, Rs, ts = chip_smoke.render_long()
    tracker = make_tracker(scene)
    n_tracked, _, tracker.after_loop, _, tracker.stage_ms = chip_smoke.drive_long(tracker, scene, stamps, Rs, ts)
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
        scene, stamps, Rs, ts = chip_smoke.render_long()
        tracker = Tracker(chip_smoke.long_config(scene), "cpu")
        n_tracked, _, tracker.after_loop, tracker.rows_differ, tracker.stage_ms = chip_smoke.drive_long(
            tracker, scene, stamps, Rs, ts)
        yield tracker, stamps, Rs, ts, n_tracked
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


def test_long_sequence_culls_and_loops_are_counted(long_run, capsys):
    """Keyframe culling by candidate and reason, the covisibility route, and
    each loop's Sim(3) scale, ground truth and keyframe ATE after each stage
    of its correction, printed as the card's long phase prints them
    (ROADMAP C4, C5)."""
    tracker, *_ = long_run
    with capsys.disabled():
        print()
        rep = chip_smoke.cull_report("long sequence, port", tracker)
        chip_smoke.loop_stage_lines("long sequence, port", tracker.after_loop, tracker.stage_ms)
    st = tracker.cull_stats
    assert st.candidates == st.protected + st.inertial_gap + st.few_landmarks + st.below_redundancy + st.max_cull \
        + st.culled
    assert tracker.n_kf_inserted - tracker.map.n_keyframes() == st.culled
    assert rep["backend"] in ("native", "numpy") and len(tracker.after_loop) == tracker.loop_closer.n_loops_closed
    assert len(tracker.rows_differ) == st.calls and sum(tracker.rows_differ) == 0, "covisibility routes disagree"


def test_long_sequence_dense_route_decides_the_same(long_run, monkeypatch, capsys):
    """The same run with the native map graph unloaded, so that every
    covisibility query takes the dense `obs @ obs[k]` product: the same
    culls for the same reasons and the same trajectory, bit for bit."""
    import dataclasses

    from orbslam3_cpp_fork_tpu_torch import native
    from orbslam3_cpp_fork_tpu_torch.runtime.tracker import Tracker

    tracker, stamps, Rs, ts, n_tracked = long_run
    monkeypatch.setattr(native, "_tried", True)
    monkeypatch.setattr(native, "_lib", None)
    assert native.backend() == "numpy"
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        scene = chip_smoke.render_long()[0]
        dense = Tracker(chip_smoke.long_config(scene), "cpu")
        assert dense.map._native is None
        n_dense, _, after_loop, _, _ = chip_smoke.drive_long(dense, scene, stamps, Rs, ts)
    finally:
        torch.set_num_threads(n)
    with capsys.disabled():
        print()
        chip_smoke.cull_report("long sequence, port, dense route", dense)
    assert dataclasses.asdict(dense.cull_stats) == dataclasses.asdict(tracker.cull_stats)
    assert n_dense == n_tracked and after_loop == tracker.after_loop
    a, b = dense.export_trajectory(), tracker.export_trajectory()
    assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]), "tolerance: bitwise"


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


def _reference_tracker(scene):
    from orbslam3_cpp_fork_tpu.ops.camera import Camera
    from orbslam3_cpp_fork_tpu.ops.orb import OrbParams
    from orbslam3_cpp_fork_tpu.runtime.tracker import Tracker, TrackerConfig

    K = scene.K
    return Tracker(TrackerConfig(async_mapping=False, camera=Camera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2]),
                                 width=scene.width, height=scene.height,
                                 orb=OrbParams(n_features=chip_smoke.LONG_FEATURES), enable_loop_closing=True))


def _reference_report(name):
    """Run the reference on the long frames; print its gates' numbers and
    its loops' lines. Returns (tracker, scale-aligned ATE)."""
    tracker, stamps, Rs, ts, n_tracked = _run(_reference_tracker)
    ts_est, res, constant = _ates(tracker, stamps, Rs, ts)
    print(f"\n{name}: state {tracker.state.name}, {n_tracked} tracked, {len(ts_est)} exported, "
          f"{tracker.map.n_keyframes()} keyframes, {tracker.map.n_landmarks()} landmarks, "
          f"{tracker.loop_closer.n_loops_closed} loops; scale-aligned ATE {res.rmse_scaled!r} m against t_wc "
          f"(scale {res.scale:.4f}), {constant.rmse_scaled!r} m against its test's -(R^T t)", flush=True)
    chip_smoke.loop_stage_lines(name, tracker.after_loop, tracker.stage_ms)
    return tracker, res.rmse_scaled


def test_reference_on_the_same_frames(capsys):
    """The reference tracker on the same frames and configuration: its four
    gates' numbers and its loops, printed beside the port's (PERF.md)."""
    from orbslam3_cpp_fork_tpu.runtime.tracker import TrackState

    with capsys.disabled():
        tracker, ate = _reference_report("long sequence, reference")
    assert tracker.state == TrackState.OK and np.isfinite(ate)


def test_reference_in_a_plain_process(capsys):
    """The same reference run in a process of its own without pytest's
    XLA flags (tests/conftest.py's 8 host devices), where its loops and ATE
    differ (ROADMAP C4): its output, printed."""
    import os
    import subprocess
    import sys

    root = str(Path(__file__).resolve().parents[1])
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = os.pathsep.join([root, *filter(None, [env.get("PYTHONPATH")])])
    out = subprocess.run([sys.executable, __file__], env=env, cwd=root, capture_output=True, text=True, timeout=5400)
    with capsys.disabled():
        print("\n" + out.stdout)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "long sequence, reference in a plain process" in out.stdout


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    _reference_report("long sequence, reference in a plain process")
