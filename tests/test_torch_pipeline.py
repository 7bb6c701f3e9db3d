"""Pipelined tracking and the asynchronous runtime of the port's Tracker.

(a) `fetch_block_async` equals `fetch_block`; the snapshot-swap remap equals
    a brute-force search. (b) `pipeline_lag=2, async_mapping=False,
    pipeline_min_kfs=2` (deterministic) against the reference: both trackers
    start from the same map and live state and track the same images; same
    keyframe frame ids, snapshot swaps on the same frames with the port's
    remap equal to the reference's array on the reference's inputs, retired
    poses within 1e-4 while both track the shared start map and within 5e-2
    map units (the unit is the scene's median depth) after the four mapping
    steps that follow: which matches a step keeps hangs on the last bit of a
    float sum, so from there the two are two runs of one chaotic system. (c) The port's version of tests/test_async_pipeline.py: the
    default mode (mapping worker + pipelined tracking, no loop closing) on a
    ring sweep, its bindings, a blackout; the ATE is held against the port's
    own synchronous control on the same frames. The long sweeps are marked
    slow; a shorter case of each runs in the un-slow tier.

Cut to size for the CPU: 320x240, 400 features, caps of 1024.
"""

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU, configured by conftest)
import numpy as np
import pytest
import torch

from orbslam3_cpp_fork_tpu.runtime import device_step as jds
from orbslam3_cpp_fork_tpu.runtime import tracker as jt
from orbslam3_cpp_fork_tpu_torch import convert
from orbslam3_cpp_fork_tpu_torch import device as device_mod
from orbslam3_cpp_fork_tpu_torch.datasets import synthetic
from orbslam3_cpp_fork_tpu_torch.runtime import device_step as tds
from orbslam3_cpp_fork_tpu_torch.runtime import tracker as tt
from orbslam3_cpp_fork_tpu_torch.utils.evaluation import ate_rmse

from test_torch_slow_path import CAP, load_ref_state, port_tracker, ref_tracker

W, H = 320, 240
START = 20  # the port tracks this many frames synchronously to make the start state
PIPE_FRAMES = 16  # then both track these, pipelined


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The shapes here are small and two Python threads dispatch at once: with
    the default thread count every op wakes a team of OpenMP threads that spin
    against the other test workers. One intra-op thread is faster."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# --------------------------------------------------------------------- (a)


def test_async_fetch_equals_fetch_block():
    g = torch.Generator().manual_seed(0)
    src = [torch.rand((3, 5), generator=g), torch.randint(0, 2**40, (7,), generator=g), torch.rand(4, generator=g) < 0.5,
           torch.tensor(17, dtype=torch.int32), torch.randint(-5, 5, (2, 3), generator=g).to(torch.int32)]
    ref = device_mod.fetch_block(src)
    handle = device_mod.fetch_block_async(src)
    src[0].zero_()  # the block was copied at dispatch
    got = handle.get()
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b), "tolerance: exact"
    assert device_mod.fetch_block_async([]).get() == []
    assert device_mod.block_nbytes(src) == 15 * 4 + 7 * 8 + 4 + 4 + 6 * 4


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_snapshot_remap_matches_brute_force(seed):
    rng = np.random.default_rng(seed)
    scene = synthetic.make_ring_scene(seed=7, n_points=50, size_range=(5, 9), width=W, height=H)
    trk = port_tracker(scene)
    old_ids = rng.permutation(3000)[: rng.integers(200, CAP)]
    ids = np.concatenate([rng.permutation(old_ids)[: len(old_ids) // 2], 3000 + rng.permutation(500)[:150]])
    ids = rng.permutation(ids)
    rm = trk._snapshot_remap(old_ids, ids)
    assert rm.shape == (CAP,) and rm.dtype == np.int32
    where = {int(v): i for i, v in enumerate(old_ids)}
    want = np.full(CAP, -1, np.int32)
    want[: len(ids)] = [where.get(int(v), -1) for v in ids]
    assert np.array_equal(rm, want), "tolerance: exact"
    assert (rm[: len(ids)] >= 0).sum() == len(old_ids) // 2


# --------------------------------------------------------------------- (b)


def _ring(n, n_traj=None):
    n_traj = n_traj or n
    scene = synthetic.make_ring_scene(seed=7, n_points=900, size_range=(5, 9), width=W, height=H)
    Rs, ts = synthetic.circle_trajectory(n_frames=n_traj, radius=2.5, total_angle=0.8 * np.pi * n_traj / 120)
    frames = [synthetic.to_u8(synthetic.render_frame(scene, Rs[i], ts[i])) for i in range(n)]
    return scene, frames, ts


@pytest.fixture(scope="module")
def start_state():
    scene, frames, _ = _ring(START + PIPE_FRAMES)
    trk = port_tracker(scene)
    for i in range(START):
        trk.track(frames[i], 0.05 * i)
    assert trk.state == tt.TrackState.OK and trk._last_n_in >= 60
    return scene, frames, convert.tracker_state_to_numpy(trk), convert.map_state_to_numpy(trk.map)


def test_pipelined_sequence_against_the_reference(start_state, monkeypatch):
    scene, frames, state, arrays = start_state
    kw = dict(pipeline_lag=2, pipeline_min_kfs=2)
    ref, got = ref_tracker(scene, **kw), port_tracker(scene, **kw)
    load_ref_state(ref, state, arrays)
    convert.load_tracker_state(got, state, arrays)
    assert ref.pipeline_lag == got.pipeline_lag == 2 and got.worker is None

    # The reference computes its remap inline: record its inputs (the previous
    # dispatch's snapshot ids and this one's) beside the array it passes on.
    ref_remaps, got_remaps = [], []
    j_prog, t_prog = jds.fused_frame_program, tds.fused_frame_program

    def j_spy(*a, **k):
        old = None if ref._chain is None else ref._chain["ids"].copy()
        ref_remaps.append((old, ref._dev_local["ids"].copy(), np.asarray(a[13])))
        return j_prog(*a, **k)

    def t_spy(*a, **k):
        got_remaps.append(a[13].numpy().copy())
        return t_prog(*a, **k)

    monkeypatch.setattr(jds, "fused_frame_program", j_spy)
    monkeypatch.setattr(tds, "fused_frame_program", t_spy)
    poses = {"ref": [], "got": []}
    for name, trk in (("ref", ref), ("got", got)):
        for i in range(START, START + PIPE_FRAMES):
            poses[name].append(trk.track(frames[i], 0.05 * i))
        trk.flush_mapping()
    assert got.n_pipelined_frames == ref.n_pipelined_frames == PIPE_FRAMES
    assert got.n_frames_dropped == ref.n_frames_dropped == 0 and got.n_lost_events == ref.n_lost_events == 0
    # The pipeline returns the pose retired `pipeline_lag` frames ago.
    assert [p is None for p in poses["got"]] == [p is None for p in poses["ref"]]
    assert [p is None for p in poses["got"]][:3] == [True, True, False]

    mr, mg = ref.map, got.map
    kf_r = sorted(int(f) for f in mr.kf_frame_id[mr.kf_valid])
    kf_g = sorted(int(f) for f in mg.kf_frame_id[mg.kf_valid])
    assert kf_g == kf_r and got.n_kf_inserted == ref.n_kf_inserted > state["n_kf_inserted"], "same keyframe frame ids"

    # Snapshot-swap remap: on the reference's own inputs the port's function
    # gives the reference's array (which landmark ids a snapshot holds after
    # several mapping steps depends on the last bit of a float sum, so the two
    # runs' own arrays are compared only in kind).
    assert len(got_remaps) == len(ref_remaps) == PIPE_FRAMES
    identity = np.arange(CAP)
    swaps = 0
    for (old_ids, ids, rm), rm_got in zip(ref_remaps, got_remaps):
        if np.array_equal(rm, identity):
            continue
        swaps += 1
        assert np.array_equal(got._snapshot_remap(old_ids, ids), rm), "remap equal to the reference's array"
        assert not np.array_equal(rm_got, identity), "the port swapped its snapshot on the same frame"
    assert swaps >= 3, "the sequence swaps its snapshot several times (a non-identity remap)"
    assert np.array_equal(got_remaps[0], identity) and np.array_equal(ref_remaps[0][2], identity)

    tr, tg = ref.trajectory, got.trajectory
    assert [r[0] for r in tg] == [r[0] for r in tr], "the same frames retired, in order"
    ts_r, Twc_r = ref.export_trajectory()
    ts_g, Twc_g = got.export_trajectory()
    assert np.array_equal(ts_g, ts_r)
    # Until the first mapping step of the pipelined part lands (a keyframe
    # every fourth frame), both sides track the same map: tight. After it the
    # two maps are two runs of a chaotic system (which matches a step keeps
    # hangs on last bits): the poses stay close, not equal.
    diffs = [None if a is None else float(np.abs(a - b).max()) for a, b in zip(poses["got"], poses["ref"])]
    assert max(d for d in diffs[:6] if d is not None) <= 1e-4, "tolerance: retired poses 1e-4 on the shared map"
    assert max(d for d in diffs if d is not None) <= 5e-2, "tolerance: retired poses 5e-2 after four mapping steps"
    assert np.abs(Twc_g - Twc_r).max() <= 5e-2, "tolerance: exported poses 5e-2 (every record rides its keyframe's BA)"


def test_pipelined_synchronous_mapping_is_reproducible(start_state):
    """`pipeline_lag=2` with `async_mapping=False` is deterministic: two runs
    from the same state export the same trajectory bit for bit."""
    scene, frames, state, arrays = start_state
    out = []
    for _ in range(2):
        trk = port_tracker(scene, pipeline_lag=2, pipeline_min_kfs=2)
        convert.load_tracker_state(trk, state, arrays)
        for i in range(START, START + 8):
            trk.track(frames[i], 0.05 * i)
        out.append(trk.export_trajectory()[1])
    assert out[0].shape == out[1].shape and np.array_equal(out[0], out[1])


# --------------------------------------------------------------------- (c)


def _async_tracker(scene, **kw):
    return port_tracker(scene, async_mapping=True, **kw)


def _run_async(scene, frames, **kw):
    """The default mode over `frames`; checks every tracked frame's bindings
    against the live map on the way."""
    trk = _async_tracker(scene, **kw)
    stale = []
    finish = trk._finish_tracked_frame

    def spy(frame, n_in):
        ids = frame.lm_idx[frame.lm_idx >= 0]
        if len(ids) and not trk.map.lm_valid[ids].all():
            stale.append((frame.frame_id, int((~trk.map.lm_valid[ids]).sum())))
        return finish(frame, n_in)

    trk._finish_tracked_frame = spy
    try:
        for i, f in enumerate(frames):
            trk.track(f, 0.05 * i)  # must not raise
        trk.flush_mapping()
    finally:
        worker, trk.worker = trk.worker, None
        worker.stop()
    assert not worker._thread.is_alive()
    return trk, worker, stale


def _sync_ate(scene, frames, ts):
    trk = port_tracker(scene)
    for i, f in enumerate(frames):
        trk.track(f, 0.05 * i)
    ts_est, Twc = trk.export_trajectory()
    return ate_rmse(ts_est, Twc[:, :3, 3], np.arange(len(frames)) * 0.05, ts).rmse_scaled


def _check_ring(n, min_pipelined, **kw):
    scene, frames, ts = _ring(n)
    trk, worker, stale = _run_async(scene, frames, **kw)
    assert trk.pipeline_lag == 2
    assert trk.state == tt.TrackState.OK and trk.n_lost_events == 0
    assert trk.n_pipelined_frames > min_pipelined, (trk.n_pipelined_frames, trk.n_sync_frames)
    assert worker.n_processed >= 1 and worker.error is None
    assert not stale, stale
    ts_est, Twc = trk.export_trajectory()
    assert len(ts_est) / n > 0.8 and np.all(np.diff(ts_est) > 0), "coverage and retirement in order"
    m = trk.map
    assert np.isfinite(m.kf_R[m.kf_valid]).all() and np.isfinite(m.lm_pos[m.lm_valid]).all()
    ate = ate_rmse(ts_est, Twc[:, :3, 3], np.arange(n) * 0.05, ts[:n]).rmse_scaled
    sync = _sync_ate(scene, frames, ts[:n])
    # The asynchronous run sees other snapshots than the synchronous one; it
    # is held against the port's own control on the same frames.
    assert ate <= 2.0 * sync + 0.02, (ate, sync)
    return trk


def test_async_pipelined_ring_short():
    """48 frames, pipelining from 4 keyframes. The bounded wait is given a
    long budget so that a loaded test machine cannot starve the tracker of
    its map frontier: which snapshot a frame sees then depends on the
    worker's progress, not on the clock."""
    _check_ring(48, min_pipelined=10, pipeline_min_kfs=4, young_map_kfs=6, map_wait_budget_ms=5000.0)


@pytest.mark.slow
def test_async_pipelined_ring_tracks():
    """The sweep of tests/test_async_pipeline.py with every policy at its
    default (pipelining from 8 keyframes, young-map drains up to 12)."""
    _check_ring(120, min_pipelined=20)


def _check_blackout(n, black, **kw):
    scene, frames, _ = _ring(n)
    seq = list(frames)
    for i in range(*black):
        seq[i] = np.zeros_like(seq[i])
    trk, worker, stale = _run_async(scene, seq, time_recently_lost=0.6, **kw)
    assert trk.n_lost_events >= 1
    assert trk.n_frames_dropped >= 1, "frames in flight behind the blackout were dropped"
    assert any(c.startswith("pipeline_fail_retry") for cs in trk.frame_causes.values() for c in cs)
    # Relocalization is not ported: re-acquired, or lost with the loss counted.
    assert trk.state in (tt.TrackState.OK, tt.TrackState.RECENTLY_LOST, tt.TrackState.LOST)
    if trk.state != tt.TrackState.OK:
        assert trk.n_lost_frames >= 1
    assert not stale, stale
    return trk


def test_pipeline_blackout_short():
    _check_blackout(56, (44, 48), pipeline_min_kfs=4, young_map_kfs=6, map_wait_budget_ms=5000.0)


@pytest.mark.slow
def test_pipeline_blackout_recovery():
    _check_blackout(90, (45, 49))


def test_mapping_thread_failure_reaches_the_track_thread():
    """An exception on the mapping thread is re-raised on the track thread at
    the next bounded wait or flush; nothing swallows it."""
    scene, frames, _ = _ring(24)
    trk = _async_tracker(scene, young_map_kfs=0)

    def boom(k, map_ref):
        raise RuntimeError("mapping step failed on purpose")

    trk._mapping_step = boom
    try:
        with pytest.raises(RuntimeError, match="on purpose"):
            for i, f in enumerate(frames):
                trk.track(f, 0.05 * i)
            trk.flush_mapping()
        assert trk.n_kf_inserted >= 3, "the failure came from a keyframe handed to the worker"
    finally:
        trk.worker.error = None
        trk.worker.stop()


# ------------------------------------------------- full width (slow, CPU)


@pytest.mark.slow
@pytest.mark.parametrize("which", ["port", "reference"])
def test_full_width_ring_async_against_sync_control(which):
    """The bench ring at full width (752x480, 1000 features, every cap at its
    default, first 120 frames, no loop closing) on the CPU, synchronous then
    asynchronous, for the port and for the reference: the bound that the chip
    smoke's `async` phase holds the card to (asynchronous ATE <= 2 x the
    synchronous ATE of the same process + 0.02 m) holds for both. Run with
    `-m slow -s`; the printed lines are the measurement behind that bound."""
    import json

    from orbslam3_cpp_fork_tpu.ops import camera as jcam
    from orbslam3_cpp_fork_tpu.ops import orb as jorb
    from orbslam3_cpp_fork_tpu_torch.ops.orb import OrbParams

    n = 120
    scene = synthetic.make_ring_scene(seed=7, n_points=1200, size_range=(9, 15), width=752, height=480)
    Rs, ts = synthetic.circle_trajectory(n_frames=300, radius=2.5, total_angle=2.3 * np.pi)
    frames = [synthetic.to_u8(synthetic.render_frame(scene, Rs[i], ts[i])) for i in range(n)]
    K = scene.K
    ates = {}
    for mode in ("sync", "async"):
        kw = dict(width=752, height=480, enable_loop_closing=False, async_mapping=mode == "async")
        if which == "port":
            cam = convert.camera_from_numpy(K[0, 0], K[1, 1], K[0, 2], K[1, 2])
            trk = tt.MonoTracker(tt.TrackerConfig(camera=cam, orb=OrbParams(n_features=1000), **kw), "cpu")
        else:
            cam = jcam.Camera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2])
            trk = jt.MonoTracker(jt.TrackerConfig(camera=cam, orb=jorb.OrbParams(n_features=1000), mapping_backend="cpu", **kw))
        try:
            for i, f in enumerate(frames):
                trk.track(f, 0.05 * i)
            ts_est, Twc = trk.export_trajectory()
        finally:
            if trk.worker is not None:
                trk.worker.stop()
        ate = ate_rmse(ts_est, Twc[:, :3, 3], np.arange(n) * 0.05, ts[:n])
        ates[mode] = ate.rmse_scaled
        print(json.dumps(dict(
            which=which, mode=mode, ate_scaled_m=ate.rmse_scaled, coverage=len(ts_est) / n, state=trk.state.name,
            keyframes=int(trk.map.n_keyframes()), landmarks=int(trk.map.n_landmarks()), n_lost_events=trk.n_lost_events,
            n_pipelined_frames=trk.n_pipelined_frames, n_sync_frames=trk.n_sync_frames,
            n_frames_dropped=trk.n_frames_dropped, n_kf_skipped_backpressure=trk.n_kf_skipped_backpressure,
        )))
        assert trk.state.name == "OK" and trk.n_lost_events == 0 and len(ts_est) / n > 0.8
    assert ates["async"] <= 2.0 * ates["sync"] + 0.02, ates
