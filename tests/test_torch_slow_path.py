"""The split-phase tracking path and the loss ladder of the port's Tracker
against the reference's.

(a) `match_by_projection_leveled` and `match_bow_like` on seeded inputs:
    exact. (b) `_match_landmarks_into_frame`, `_pose_optimize` and one whole
    `_track_frame_slow` step: a reference tracker and a port tracker are put
    on the same map and in the same live state (`convert.map_state_to_numpy`,
    `convert.tracker_state_to_numpy`) and given the same features of the next
    frame: same matches, same bindings, pose within 1e-4. (c) `_set_lost` and
    `_recently_lost_step`: the same featureless frames take both through the
    same states; where the reference goes on to relocalize (not ported), the
    port counts the frame.

Cut to size for the CPU: a 320x240 ring, 400 features, caps of 1024, 52
frames tracked once by the port (synchronous mode) to make the maps.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_cpp_fork_tpu.models import map_state as jms
from orbslam3_cpp_fork_tpu.ops import camera as jcam
from orbslam3_cpp_fork_tpu.ops import orb as jorb
from orbslam3_cpp_fork_tpu.runtime import tracker as jt
from orbslam3_cpp_fork_tpu_torch import convert
from orbslam3_cpp_fork_tpu_torch.datasets import synthetic
from orbslam3_cpp_fork_tpu_torch.models.map_state import MapConfig
from orbslam3_cpp_fork_tpu_torch.ops.orb import OrbParams
from orbslam3_cpp_fork_tpu_torch.runtime import tracker as tt

W, H, N_FEAT, CAP = 320, 240, 400, 1024
N_FRAMES = 52
EARLY = 20  # a state on a young map (<= 10 keyframes)
MAP_CFG = dict(max_keyframes=48, max_landmarks=4096)
CAPS = dict(local_lm_cap=CAP, ba_lm_cap=CAP, ba_obs_cap=8192)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


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


def _match_inputs(seed, L=96, N=80):
    rng = np.random.default_rng(seed)
    f_bits = rng.integers(0, 2, (N, 256)).astype(np.int8)
    src = rng.integers(0, N, L)
    lm_bits = f_bits[src].copy()
    flip = rng.random((L, 256)) < 0.08
    lm_bits = np.where(flip, 1 - lm_bits, lm_bits).astype(np.int8)
    f_xy = rng.uniform(0, 300, (N, 2)).astype(np.float32)
    uv = (f_xy[src] + rng.normal(0, 6, (L, 2))).astype(np.float32)
    f_level = rng.integers(0, 8, N).astype(np.int32)
    pred_level = np.clip(f_level[src] + rng.integers(-2, 3, L), 0, 7).astype(np.int32)
    return dict(
        lm_bits=lm_bits, lm_valid=rng.random(L) < 0.9, uv=uv, pred_level=pred_level,
        f_bits=f_bits, f_xy=f_xy, f_level=f_level, f_valid=rng.random(N) < 0.9,
        angle_l=rng.uniform(0, 2 * np.pi, L).astype(np.float32), angle_f=rng.uniform(0, 2 * np.pi, N).astype(np.float32),
    )


@pytest.mark.parametrize("seed,radius", [(0, 15.0), (1, 30.0), (2, 6.0)])
def test_match_by_projection_leveled_exact(seed, radius):
    d = _match_inputs(seed)
    ref = jt.match_by_projection_leveled(
        jnp.asarray(d["lm_bits"]), jnp.asarray(d["lm_valid"]), jnp.asarray(d["uv"]), jnp.asarray(d["pred_level"]),
        radius, jnp.asarray(d["f_bits"]), jnp.asarray(d["f_xy"]), jnp.asarray(d["f_level"]), jnp.asarray(d["f_valid"]),
    )
    got = tt.match_by_projection_leveled(
        _t(d["lm_bits"]), _t(d["lm_valid"]), _t(d["uv"]), _t(d["pred_level"]), radius,
        _t(d["f_bits"]), _t(d["f_xy"]), _t(d["f_level"]), _t(d["f_valid"]),
    )
    ok_r = np.asarray(ref[1])
    assert ok_r.sum() > 10
    assert np.array_equal(got[1].numpy(), ok_r), "tolerance: exact"
    assert np.array_equal(got[0].numpy()[ok_r], np.asarray(ref[0])[ok_r]), "tolerance: exact"


@pytest.mark.parametrize("seed", [0, 1])
def test_match_bow_like_exact(seed):
    d = _match_inputs(seed)
    # A common rotation between the two sides, so that the orientation
    # histogram has a peak to keep.
    src_angle = d["angle_f"][np.argmin(((d["lm_bits"][:, None, :] != d["f_bits"][None]).sum(-1)), axis=1)]
    angle_l = np.mod(src_angle + 0.3, 2 * np.pi).astype(np.float32)
    ref = jt.match_bow_like(
        jnp.asarray(d["lm_bits"]), jnp.asarray(d["lm_valid"]), jnp.asarray(angle_l),
        jnp.asarray(d["f_bits"]), jnp.asarray(d["f_valid"]), jnp.asarray(d["angle_f"]),
    )
    got = tt.match_bow_like(
        _t(d["lm_bits"]), _t(d["lm_valid"]), _t(angle_l), _t(d["f_bits"]), _t(d["f_valid"]), _t(d["angle_f"]),
    )
    ok_r = np.asarray(ref[1])
    assert ok_r.sum() > 10
    assert np.array_equal(got[1].numpy(), ok_r), "tolerance: exact"
    assert np.array_equal(got[0].numpy()[ok_r], np.asarray(ref[0])[ok_r]), "tolerance: exact"


# ------------------------------------------------------------- shared state


def _scene():
    scene = synthetic.make_ring_scene(seed=7, n_points=900, size_range=(5, 9), width=W, height=H)
    Rs, ts = synthetic.circle_trajectory(n_frames=N_FRAMES + 8, radius=2.5, total_angle=0.8 * np.pi * (N_FRAMES + 8) / 120)
    return scene, Rs, ts


def port_tracker(scene, **kw):
    K = scene.K
    cfg = tt.TrackerConfig(**{
        **dict(camera=convert.camera_from_numpy(K[0, 0], K[1, 1], K[0, 2], K[1, 2]), width=W, height=H,
               orb=OrbParams(n_features=N_FEAT), async_mapping=False, enable_loop_closing=False,
               map_cfg=MapConfig(**MAP_CFG)),
        **CAPS, **kw,
    })
    return tt.MonoTracker(cfg, "cpu")


def ref_tracker(scene, **kw):
    K = scene.K
    cfg = jt.TrackerConfig(
        camera=jcam.Camera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2]), width=W, height=H,
        orb=jorb.OrbParams(n_features=N_FEAT), async_mapping=False, enable_loop_closing=False,
        mapping_backend="cpu", map_cfg=jms.MapConfig(**MAP_CFG), **CAPS, **kw,
    )
    return jt.MonoTracker(cfg)


def ref_map_from_numpy(d):
    m = jms.MapState(jms.MapConfig(n_features=d["kf_xy"].shape[1], imu_cap=d["kf_imu"].shape[1], **MAP_CFG))
    for k in convert.MAP_ARRAYS:
        getattr(m, k)[...] = d[k]
    for k in convert.MAP_SCALARS:
        setattr(m, k, d[k])
    m.mark_obs_dirty()
    return m


def load_ref_state(ref, state, map_arrays):
    """The reference tracker on the same map and in the same live state."""
    ref.atlas.maps[ref.atlas.active_idx] = ref_map_from_numpy(map_arrays)
    ref.state = jt.TrackState[state["state"]]
    ref.frame_id, ref.ref_kf = state["frame_id"], state["ref_kf"]
    ref.last_kf_frame_id, ref.n_kf_inserted = state["last_kf_frame_id"], state["n_kf_inserted"]
    ref._last_n_in, ref.lost_t = state["last_n_in"], state["lost_t"]
    ref.velocity = None if state["velocity"] is None else tuple(v.copy() for v in state["velocity"])
    f = state["last"]
    ref.last = jt.FrameData(
        frame_id=f["frame_id"], timestamp=f["timestamp"], R=f["R"].copy(), t=f["t"].copy(),
        **{k: f[k].copy() for k in convert.FRAME_ARRAYS},
    )
    ref._dev_local = None


def frame_features(img):
    """The ORB features of an image, as the inputs both trackers are stepped
    with (the port's extraction: the describe stage's parity is
    tests/test_torch_describe.py's, and it compiles nothing)."""
    from orbslam3_cpp_fork_tpu_torch.ops import orb as torb

    f = torb.extract_orb(torch.from_numpy(np.clip(img, 0, 255).astype(np.uint8)).to(torch.float32), OrbParams(n_features=N_FEAT))
    # No distortion: the undistorted keypoints are the raw ones.
    return dict(xy=f.xy.numpy(), level=f.level.numpy(), angle=f.angle.numpy(), desc=f.desc_numpy(),
                valid=f.valid.numpy())


def no_features():
    return dict(
        xy=np.zeros((N_FEAT, 2), np.float32), level=np.zeros(N_FEAT, np.int32), angle=np.zeros(N_FEAT, np.float32),
        desc=np.zeros((N_FEAT, 8), np.uint32), valid=np.zeros(N_FEAT, bool),
    )


def frame_of(mod, feats, frame_id):
    return mod.FrameData(
        frame_id=frame_id, timestamp=0.05 * frame_id, lm_idx=np.full(N_FEAT, -1, np.int32),
        ur=np.full(N_FEAT, -1.0, np.float32), depth=np.full(N_FEAT, -1.0, np.float32),
        **{k: v.copy() for k, v in feats.items()},
    )


@pytest.fixture(scope="module")
def states():
    """The port tracks the sequence once; its map and live state after frame
    EARLY (a young map) and after the last frame (> 10 keyframes), with the
    features of the frames that follow each."""
    scene, Rs, ts = _scene()
    trk = port_tracker(scene)
    snaps = {}
    for i in range(N_FRAMES):
        trk.track(synthetic.render_frame(scene, Rs[i], ts[i]), 0.05 * i)
        if i in (EARLY, N_FRAMES - 1):
            snaps[i] = (convert.tracker_state_to_numpy(trk), convert.map_state_to_numpy(trk.map))
    assert trk.state == tt.TrackState.OK and trk.n_fused_declined == 0
    nxt = {i: frame_features(synthetic.render_frame(scene, Rs[i], ts[i])) for i in (EARLY + 1, N_FRAMES - 1, N_FRAMES)}
    return scene, snaps, nxt


def both_loaded(states, at, **kw):
    scene, snaps, _ = states
    state, arrays = snaps[at]
    ref, got = ref_tracker(scene, **kw), port_tracker(scene, **kw)
    load_ref_state(ref, state, arrays)
    convert.load_tracker_state(got, state, arrays)
    # No keyframe decision in these steps: the comparison is of tracking.
    ref.last_kf_frame_id = got.last_kf_frame_id = state["frame_id"]
    return ref, got


# --------------------------------------------------------------------- (b)


def test_tracker_state_round_trip(states):
    scene, snaps, _ = states
    state, arrays = snaps[N_FRAMES - 1]
    got = port_tracker(scene)
    convert.load_tracker_state(got, state, arrays)
    back = convert.tracker_state_to_numpy(got)
    assert back["state"] == "OK" and back["frame_id"] == N_FRAMES and back["ref_kf"] == state["ref_kf"]
    for k in convert.FRAME_ARRAYS + ("R", "t"):
        assert np.array_equal(back["last"][k], state["last"][k]), k
    assert all(np.array_equal(a, b) for a, b in zip(back["velocity"], state["velocity"]))
    assert state["snapshot_ids"] is not None and state["snapshot_anchor"][0] >= 0
    assert got.map.n_keyframes() > 10, "the late state sits on an established map"


def test_match_landmarks_and_pose_optimize_parity(states):
    ref, got = both_loaded(states, N_FRAMES - 1)
    feats = states[2][N_FRAMES]
    out = {}
    for name, trk, mod in (("ref", ref, jt), ("got", got, tt)):
        frame = frame_of(mod, feats, N_FRAMES)
        trk._predict_pose(frame)
        m = trk.map
        last_lms = np.unique(trk.last.lm_idx[trk.last.lm_idx >= 0])
        last_lms = last_lms[m.lm_valid[last_lms]]
        vis0 = m.lm_visible.copy()
        lm_hit, feat_hit = trk._match_landmarks_into_frame(frame, last_lms, 15.0)
        frame.lm_idx[feat_hit] = lm_hit
        n_in = trk._pose_optimize(frame)
        out[name] = (lm_hit, feat_hit, n_in, frame, m.lm_visible - vis0, m.lm_found.copy())
    (lr, fr, nr, frr, vr, fdr), (lg, fg, ng, frg, vg, fdg) = out["ref"], out["got"]
    assert len(lr) > 30
    assert np.array_equal(lg, lr) and np.array_equal(fg, fr), "same matches (exact)"
    assert np.array_equal(vg, vr), "same visibility counts"
    assert ng == nr and np.array_equal(frg.lm_idx, frr.lm_idx), "same inliers, same bindings"
    assert np.array_equal(fdg, fdr), "same found counts"
    assert np.abs(frg.R - frr.R).max() <= 1e-4 and np.abs(frg.t - frr.t).max() <= 1e-4, "tolerance: pose 1e-4"


@pytest.mark.parametrize("at", [EARLY, N_FRAMES - 1])
def test_track_frame_slow_step_parity(states, at):
    ref, got = both_loaded(states, at)
    feats = states[2][at + 1]
    frames = {}
    for name, trk, mod in (("ref", ref, jt), ("got", got, tt)):
        frame = frame_of(mod, feats, at + 1)
        trk._track_frame_slow(frame)
        frames[name] = frame
    fr, fg = frames["ref"], frames["got"]
    assert ref.state == jt.TrackState.OK and got.state == tt.TrackState.OK
    assert got._last_n_in == ref._last_n_in > 30
    assert np.array_equal(fg.lm_idx, fr.lm_idx), "same bindings"
    assert np.abs(fg.R - fr.R).max() <= 1e-4 and np.abs(fg.t - fr.t).max() <= 1e-4, "tolerance: pose 1e-4"
    assert got.ref_kf == ref.ref_kf and got.last is fg
    for a, b in zip(got.velocity, ref.velocity):
        assert np.abs(a - b).max() <= 1e-4, "tolerance: velocity 1e-4"


def test_fused_decline_falls_through_to_the_slow_path(states):
    """A frame the fused path declines is retried by the split-phase path and
    tracked: it is counted, and it is not a loss."""
    _, got = both_loaded(states, N_FRAMES - 1)
    got._track_frame_fused = lambda frame: False
    frame = frame_of(tt, states[2][N_FRAMES], N_FRAMES)
    got._track_frame(frame)
    assert got.n_fused_declined == 1 and got.state == tt.TrackState.OK and got.n_lost_events == 0
    assert frame.R is not None and (frame.lm_idx >= 0).sum() > 30


# --------------------------------------------------------------------- (c)


def _step(trk, mod, feats, fid):
    frame = frame_of(mod, feats, fid)
    T = trk._process(frame)
    return trk.state.name, T is not None


def test_loss_on_a_young_map_goes_straight_to_lost(states):
    ref, got = both_loaded(states, EARLY)
    assert got.map.n_keyframes() <= 10
    sr = _step(ref, jt, no_features(), EARLY + 1)
    sg = _step(got, tt, no_features(), EARLY + 1)
    assert sg == sr == ("LOST", False)
    assert got.n_lost_events == ref.n_lost_events == 1
    assert got.velocity is None and got.last.R is None
    # The next frame with features relocalizes against the recent keyframes,
    # as the reference's does; a featureless one stays LOST and is counted.
    n0 = got.n_lost_frames
    assert _step(got, tt, no_features(), EARLY + 2) == _step(ref, jt, no_features(), EARLY + 2) == ("LOST", False)
    assert got.n_lost_frames == n0 + 1 and got.lost_frames == 1
    assert _step(got, tt, states[2][EARLY + 1], EARLY + 3) == _step(ref, jt, states[2][EARLY + 1], EARLY + 3) == ("OK", True)
    assert got.lost_frames == 0 and got.events[-1]["kind"] == "reloc"


def test_recently_lost_ladder_on_featureless_frames(states):
    """OK -> RECENTLY_LOST on the first featureless frame (the pose and the
    motion model are kept), RECENTLY_LOST until `time_recently_lost` has
    passed, then LOST: the same states, frame by frame, as the reference."""
    ref, got = both_loaded(states, N_FRAMES - 1, time_recently_lost=0.12)
    seq_r, seq_g = [], []
    for j in range(4):
        seq_r.append(_step(ref, jt, no_features(), N_FRAMES + j))
        seq_g.append(_step(got, tt, no_features(), N_FRAMES + j))
        if seq_r[-1][0] == "LOST":
            break
    assert seq_g == seq_r
    assert [s for s, _ in seq_g] == ["RECENTLY_LOST", "RECENTLY_LOST", "RECENTLY_LOST", "LOST"]
    assert got.n_lost_events == ref.n_lost_events == 1
    assert got.lost_t == ref.lost_t == pytest.approx(0.05 * N_FRAMES)
    assert got.n_lost_frames == 3, "one per frame on which the reference calls its relocalization"
    assert got.velocity is None


def test_recently_lost_reacquires_the_map(states):
    """The camera stands still through two featureless frames, then sees the
    last tracked view again: the wide re-acquisition around the reference
    keyframe brings both trackers back to OK at the same pose."""
    ref, got = both_loaded(states, N_FRAMES - 1)
    feats = states[2][N_FRAMES - 1]
    out = []
    for trk, mod in ((ref, jt), (got, tt)):
        trk.velocity = None
        for j in range(2):
            assert _step(trk, mod, no_features(), N_FRAMES + j) == ("RECENTLY_LOST", True)
        frame = frame_of(mod, feats, N_FRAMES + 2)
        T = trk._process(frame)
        out.append((trk.state.name, T, frame))
    (sr, Tr, fr), (sg, Tg, fg) = out
    assert sr == "OK" and sg == "OK"
    assert got.n_lost_events == 1 and got.velocity is None and got.last is fg
    assert (fg.lm_idx >= 0).sum() >= 30 and np.array_equal(fg.lm_idx, fr.lm_idx), "same bindings"
    assert np.abs(Tg - Tr).max() <= 1e-4, "tolerance: pose 1e-4"
