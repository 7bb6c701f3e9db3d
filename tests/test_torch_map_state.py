"""The port's map model (models/map_state.py, a copy of the reference's
numpy SoA map) against the reference's MapState driven with the same calls;
the native covisibility graph against the numpy fallback; and the
`convert.map_state_from_numpy` round trip."""

import numpy as np
import pytest

from orbslam3_cpp_fork_tpu.models import map_state as jms
from orbslam3_cpp_fork_tpu_torch import convert, native
from orbslam3_cpp_fork_tpu_torch.models import map_state as tms

K_N, L_N, N_F = 12, 400, 60


def drive(mod, seed, use_native=True):
    """Build a small map with a fixed script of mutations."""
    rng = np.random.default_rng(seed)
    m = mod.MapState(mod.MapConfig(max_keyframes=K_N, max_landmarks=L_N, n_features=N_F, imu_cap=4))
    if not use_native:
        m._native = None
    n_lm = 150
    desc = rng.integers(0, 2**32, (n_lm, 8), dtype=np.uint64).astype(np.uint32)
    bits = np.unpackbits(desc.view(np.uint8), axis=-1, bitorder="little").astype(np.int8)
    pos = np.stack([rng.uniform(-3, 3, n_lm), rng.uniform(-2, 2, n_lm), rng.uniform(4, 9, n_lm)], 1).astype(np.float32)
    m.kf_frame_id[0] = 0
    ids = m.add_landmarks(
        pos, desc, bits, 0, rng.integers(0, 8, n_lm), np.zeros((n_lm, 3), np.float32),
        np.full(n_lm, 0.1, np.float32), np.full(n_lm, 100.0, np.float32),
    )
    kfs = []
    for k in range(8):
        seen = rng.choice(ids, 40, replace=False)
        lm_idx = np.full(N_F, -1, np.int32)
        lm_idx[rng.choice(N_F, 40, replace=False)] = seen
        R = np.eye(3, dtype=np.float32)
        t = np.array([-0.2 * k, 0.0, 0.0], np.float32)
        kfs.append(m.add_keyframe(
            R, t, rng.uniform(0, 600, (N_F, 2)).astype(np.float32), rng.integers(0, 8, N_F).astype(np.int32),
            rng.uniform(-3, 3, N_F).astype(np.float32), rng.integers(0, 2**32, (N_F, 8), dtype=np.uint64).astype(np.uint32),
            rng.uniform(size=N_F) < 0.95, lm_idx, 0.05 * k, k,
        ))
    m.update_landmark_stats(ids)
    free = np.nonzero(m.kf_lm_idx[kfs[3]] < 0)[0][:5]
    m.add_observation(kfs[3], free, ids[:5])
    m.replace_landmark(int(ids[10]), int(ids[11]))
    m.replace_landmark(int(ids[12]), int(ids[10]))  # old already replaced: no-op on an invalid target
    m.remove_landmarks(ids[20:30])
    m.remove_keyframe(kfs[2])
    lm_idx = np.full(N_F, -1, np.int32)
    lm_idx[:30] = ids[40:70]
    kfs.append(m.add_keyframe(
        np.eye(3, dtype=np.float32), np.array([-2.0, 0, 0], np.float32), rng.uniform(0, 600, (N_F, 2)).astype(np.float32),
        rng.integers(0, 8, N_F).astype(np.int32), rng.uniform(-3, 3, N_F).astype(np.float32),
        rng.integers(0, 2**32, (N_F, 8), dtype=np.uint64).astype(np.uint32), np.ones(N_F, bool), lm_idx, 1.0, 20,
    ))
    m.update_landmark_stats(ids[40:70])
    return m, ids, kfs


@pytest.mark.parametrize("seed", [0, 1])
def test_same_calls_same_map(seed):
    ref, ids, kfs = drive(jms, seed)
    got, _, _ = drive(tms, seed)
    a, b = convert.map_state_to_numpy(ref), convert.map_state_to_numpy(got)
    for k in convert.MAP_ARRAYS:
        assert np.array_equal(a[k], b[k]), f"{k} differs (tolerance: exact, both are numpy)"
    for k in convert.MAP_SCALARS:
        assert a[k] == b[k], k
    assert got.n_keyframes() == ref.n_keyframes() == 8 and got.n_landmarks() == ref.n_landmarks()
    assert kfs[-1] == 2, "the culled keyframe's slot is reused"
    assert np.array_equal(got.resolve_replaced(ids[:20]), ref.resolve_replaced(ids[:20]))
    assert got.resolve_replaced(ids[10:11])[0] == ids[11] and not got.lm_valid[ids[10]]
    for k in np.nonzero(ref.kf_valid)[0]:
        r_ids, r_w = ref.covisible_keyframes(int(k), min_weight=1)
        g_ids, g_w = got.covisible_keyframes(int(k), min_weight=1)
        assert np.array_equal(np.sort(r_w), np.sort(g_w)) and set(r_ids) == set(g_ids)
        assert np.array_equal(got.local_map_landmarks(g_ids), ref.local_map_landmarks(r_ids))


@pytest.mark.parametrize("seed", [0, 1])
def test_native_covisibility_equals_numpy(seed):
    assert native.backend() == "native", "g++ is present here: the native graph must build"
    nat, _, _ = drive(tms, seed, use_native=True)
    ref, _, _ = drive(tms, seed, use_native=False)
    assert nat._native is not None and ref._native is None
    for k in np.nonzero(ref.kf_valid)[0]:
        assert np.array_equal(nat.covisibility_weights(int(k)), ref.covisibility_weights(int(k)))
    dense = ref.obs.astype(np.int32) @ ref.obs.astype(np.int32).T
    k = int(np.nonzero(ref.kf_valid)[0][0])
    w = dense[k].copy()
    w[k] = 0
    assert np.array_equal(ref.covisibility_weights(k), w)


def test_native_library_lands_in_the_build_directory():
    import os

    pkg = os.path.dirname(os.path.dirname(tms.__file__))
    assert native.load() is not None
    assert os.path.exists(os.path.join(pkg, "build", "_mapgraph.so"))
    assert not [f for f in os.listdir(os.path.join(pkg, "native")) if f.endswith(".so")]


def test_round_trip_from_the_reference_map():
    ref, ids, kfs = drive(jms, 3)
    d = convert.map_state_to_numpy(ref)
    got = convert.map_state_from_numpy(d)
    assert isinstance(got, tms.MapState) and got.cfg.max_keyframes == K_N and got.cfg.n_features == N_F
    back = convert.map_state_to_numpy(got)
    for k in convert.MAP_ARRAYS:
        assert back[k].dtype == d[k].dtype and np.array_equal(back[k], d[k]), k
    # The loaded map keeps working: covisibility is rebuilt from `obs`, and
    # a mutation lands as in the reference.
    k0 = int(np.nonzero(ref.kf_valid)[0][1])
    assert np.array_equal(got.covisibility_weights(k0), ref.covisibility_weights(k0))
    ref.remove_landmarks(ids[70:75])
    got.remove_landmarks(ids[70:75])
    assert np.array_equal(got.kf_lm_idx, ref.kf_lm_idx) and np.array_equal(got.obs, ref.obs)
    with pytest.raises(KeyError):
        convert.map_state_from_numpy({k: v for k, v in d.items() if k != "obs"})


def test_inertial_hooks_are_refused():
    """The inertial hooks that used to refuse (`_reintegrate`, `store_preint`,
    `stacked_preint`) now run: the same raw rows attached to a chain of
    keyframes, re-integrated at a new bias, one keyframe culled (its rows
    spliced into its successor's) and the window stacked, against the
    reference's MapState: every preintegration field to 1e-5 relative."""
    from orbslam3_cpp_fork_tpu.ops import imu as jimu
    from orbslam3_cpp_fork_tpu_torch.ops import imu as timu

    noise = (1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0)
    maps = []
    for mod, calib in ((jms, jimu.ImuCalib.create(*noise)), (tms, timu.ImuCalib.create(*noise, device="cpu"))):
        rng = np.random.default_rng(5)
        m = mod.MapState(mod.MapConfig(max_keyframes=8, max_landmarks=16, n_features=8, imu_cap=64))
        m._imu_calib = calib
        prev = -1
        for k in range(5):
            m.add_keyframe(np.eye(3, dtype=np.float32), np.zeros(3, np.float32), np.zeros((8, 2), np.float32),
                           np.zeros(8, np.int32), np.zeros(8, np.float32), np.zeros((8, 8), np.uint32),
                           np.zeros(8, bool), np.full(8, -1, np.int32), 0.1 * k, k)
            rows = np.concatenate([np.full((20, 1), 0.005), rng.normal(0, 1, (20, 3)) + [0, 0, 9.81],
                                   rng.normal(0, 0.4, (20, 3))], 1).astype(np.float32)
            bias = rng.normal(0, 0.01, 3).astype(np.float32)
            m.set_keyframe_inertial(k, np.zeros(3, np.float32), bias, bias * 3, prev, rows if prev >= 0 else None)
            prev = k
        m._reintegrate(3, bias=np.array([0.01, -0.02, 0.005, 0.05, 0.02, -0.03], np.float32))
        m.remove_keyframe(2)
        maps.append(m)
    ref, got = maps
    for k in ("kf_pre_valid", "kf_prev", "kf_next", "kf_imu_n", "kf_imu"):
        assert np.array_equal(getattr(got, k), getattr(ref, k)), k
    for k in ("kf_pre_dR", "kf_pre_dV", "kf_pre_dP", "kf_pre_C", "kf_pre_J", "kf_pre_dT", "kf_pre_bias"):
        r, g = getattr(ref, k), getattr(got, k)
        assert np.abs(g - r).max() <= 1e-5 * max(float(np.abs(r).max()), 1e-30), k
    ks = np.array([1, 3, 4])
    st_r, st_g = ref.stacked_preint(ks), got.stacked_preint(ks)
    for k in convert.PREINT_FIELDS:
        r, g = np.asarray(getattr(st_r, k), np.float32), getattr(st_g, k).numpy()
        assert g.shape == r.shape and np.abs(g - r).max() <= 1e-5 * max(float(np.abs(r).max()), 1e-30), k


def test_device_keyframe_store_mirrors_the_map():
    import torch

    m, ids, kfs = drive(tms, 4)
    store = convert.kf_store_from_numpy(m, "cpu")
    for k in np.nonzero(m.kf_valid)[0]:
        assert np.array_equal(store.desc[k].numpy().astype(np.uint32), m.kf_desc[k])
        assert np.array_equal(store.xy[k].numpy(), m.kf_xy[k]) and np.array_equal(store.valid[k].numpy(), m.kf_feat_valid[k])
        assert np.array_equal(store.level[k].numpy(), m.kf_level[k]) and store.gen[k] == m.kf_gen[k]
    # A reused slot is uploaded again (generation check); untouched rows are not.
    k = int(np.nonzero(m.kf_valid)[0][0])
    m.remove_keyframe(k)
    k2 = m.add_keyframe(
        np.eye(3, dtype=np.float32), np.zeros(3, np.float32), np.full((N_F, 2), 7.0, np.float32), np.zeros(N_F, np.int32),
        np.zeros(N_F, np.float32), np.zeros((N_F, 8), np.uint32), np.ones(N_F, bool), np.full(N_F, -1, np.int32), 9.0, 99,
    )
    assert k2 == k and store.gen[k] != m.kf_gen[k]
    store.sync(m, [k])
    assert float(store.xy[k].min()) == 7.0 and store.desc.dtype == torch.int64


def test_covisibility_under_three_threads():
    """The track thread inserts keyframes, the loop thread fuses landmarks and
    binds observations (both under the map lock), and a third thread reads
    covisibility without it, which rebuilds the native mirror after each
    fusion. Every round, the mirror's rows must equal `obs @ obs[k]`: a
    rebuild racing a locked write must not publish a graph without it."""
    import threading

    assert native.backend() == "native", "g++ is present here: the native graph must build"
    rng = np.random.default_rng(5)
    m = tms.MapState(tms.MapConfig(max_keyframes=32, max_landmarks=512, n_features=N_F, imu_cap=4))
    n_lm = 400
    desc = rng.integers(0, 2**32, (n_lm, 8), dtype=np.uint64).astype(np.uint32)
    bits = np.unpackbits(desc.view(np.uint8), axis=-1, bitorder="little").astype(np.int8)
    ids = m.add_landmarks(
        rng.normal(size=(n_lm, 3)).astype(np.float32), desc, bits, -1, np.zeros(n_lm, np.int32),
        np.zeros((n_lm, 3), np.float32), np.full(n_lm, 0.1, np.float32), np.full(n_lm, 100.0, np.float32),
    )
    map_lock = threading.Lock()

    def insert_kf(r):
        lm_idx = np.full(N_F, -1, np.int32)
        lm_idx[: N_F // 2] = rng.choice(ids, N_F // 2, replace=False)
        return m.add_keyframe(
            np.eye(3, dtype=np.float32), np.zeros(3, np.float32), np.zeros((N_F, 2), np.float32),
            np.zeros(N_F, np.int32), np.zeros(N_F, np.float32), np.zeros((N_F, 8), np.uint32),
            np.ones(N_F, bool), lm_idx, 0.05 * r, r,
        )

    for r in range(24):
        insert_kf(r)

    def track(r):
        with map_lock:
            if m.n_keyframes() >= 28:
                m.remove_keyframe(int(np.nonzero(m.kf_valid)[0][0]))
            insert_kf(r)

    def loop(r):
        for j in range(3):
            with map_lock:
                live = ids[m.lm_valid[ids]]
                m.replace_landmark(int(live[(r + j) % len(live)]), int(live[(r + j + 7) % len(live)]))
                for k in np.nonzero(m.kf_valid)[0][2 * j: 2 * j + 4]:
                    free = np.nonzero(m.kf_lm_idx[k] < 0)[0][:2]
                    m.add_observation(int(k), free, live[(r + np.arange(len(free)) * 13) % len(live)])

    def read(_):
        for k in np.nonzero(m.kf_valid)[0][:12]:
            m.covisible_keyframes(int(k), min_weight=1)

    for r in range(24, 274):
        gate = threading.Barrier(3)

        def run(fn, r=r, gate=gate):
            gate.wait()
            fn(r)

        threads = [threading.Thread(target=run, args=(fn,)) for fn in (track, loop, read)]
        for th in threads:
            th.start()
        for th in threads:
            th.join()
        dense = m.obs.astype(np.int32) @ m.obs.astype(np.int32).T
        if not m._native_dirty:
            # The mirror as published, before any rebuild a read would do.
            for k in np.nonzero(m.kf_valid)[0]:
                w = m._native.covis_row(int(k))
                w[~m.kf_valid] = 0
                want = dense[k].copy()
                want[k] = 0
                want[~m.kf_valid] = 0
                assert np.array_equal(w, want), f"round {r}: keyframe {k}'s covisibility row is stale"
        for k in np.nonzero(m.kf_valid)[0]:
            want = dense[k].copy()
            want[k] = 0
            want[~m.kf_valid] = 0
            assert np.array_equal(m.covisibility_weights(int(k)), want), f"round {r}: keyframe {k}"


def test_covisibility_routes_agree_through_a_slam_run():
    """A short synchronous SLAM run on the CPU through every path that writes
    `obs` (keyframe insertion, observation binding, landmark fusion,
    landmark culling, keyframe culling and removal): after every frame, and
    just before every keyframe cull, the native graph's covisibility rows
    equal the dense product `obs @ obs.T` for every live keyframe
    (`chip_smoke.covisibility_rows_differ`, which the card's long phase
    runs before every cull; ROADMAP C5). A keyframe every 2 frames of a slow 320x240 pass makes keyframes
    redundant enough that the cull removes some."""
    import torch

    import chip_smoke
    from orbslam3_cpp_fork_tpu_torch.datasets import synthetic
    from orbslam3_cpp_fork_tpu_torch.ops.orb import OrbParams
    from orbslam3_cpp_fork_tpu_torch.runtime import tracker as tt

    assert native.backend() == "native", "g++ is present here: the native graph must build"
    scene = synthetic.make_scene(seed=3, width=320, height=240)
    Rs, ts = synthetic.smooth_trajectory(n_frames=13, step=0.03, yaw_rate=0.002)
    K = scene.K
    cfg = tt.TrackerConfig(
        camera=convert.camera_from_numpy(K[0, 0], K[1, 1], K[0, 2], K[1, 2]), width=scene.width,
        height=scene.height, orb=OrbParams(n_features=300), async_mapping=False, enable_loop_closing=False,
        kf_max_interval=2, kf_min_interval=1, map_cfg=tms.MapConfig(max_keyframes=32, max_landmarks=4096),
    )
    calls = {}
    checked = [0]

    def routes_agree(m):
        assert chip_smoke.covisibility_rows_differ(m) == 0
        checked[0] += 1

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    patch = pytest.MonkeyPatch()
    try:
        for name in ("add_keyframe", "add_observation", "replace_landmark", "remove_landmarks", "remove_keyframe"):
            def counted(self, *a, _real=getattr(tms.MapState, name), _name=name, **kw):
                calls[_name] = calls.get(_name, 0) + 1
                return _real(self, *a, **kw)
            patch.setattr(tms.MapState, name, counted)
        trk = tt.Tracker(cfg, "cpu")
        assert trk.map._native is not None
        real_cull = trk._cull_keyframes

        def cull(k):
            routes_agree(trk.map)
            return real_cull(k)

        trk._cull_keyframes = cull
        for i, f in enumerate(synthetic.render_sequence(scene, Rs, ts)):
            trk.track(f, 0.05 * i)
            routes_agree(trk.map)
    finally:
        patch.undo()
        torch.set_num_threads(n)
    assert trk.state == tt.TrackState.OK
    assert trk.cull_stats.culled >= 1 and calls.get("remove_keyframe", 0) >= trk.cull_stats.culled
    for name in ("add_keyframe", "add_observation", "replace_landmark", "remove_landmarks"):
        assert calls.get(name, 0) >= 1, f"the run never called MapState.{name}"
    assert checked[0] == 13 + trk.cull_stats.calls
