"""The multi-map Atlas and its checkpoints, port against reference.

`Atlas.create_new_map` and `merge_into` on the same random two-map Atlas:
every array bit for bit (the keyframe poses, the moved landmarks, the
remaps, the temporal chain, the IMU fields), `lm_obs_count` included, where
both count each moved observation twice (ROADMAP R14, witnessed here); the
covisibility graph after a merge; `checkpoint.save_atlas` /
`load_atlas` round trips bit for bit, and files written by either package
load in the other. ROADMAP R13: after a reset the reference's device
keyframe store serves the discarded keyframe's rows; the port's does not.

Tolerances: exact throughout.
"""

import numpy as np
import pytest
import torch

from orbslam3_cpp_fork_tpu.models import atlas as jatlas
from orbslam3_cpp_fork_tpu.models import map_state as jms
from orbslam3_cpp_fork_tpu.runtime import checkpoint as jckpt
from orbslam3_cpp_fork_tpu_torch import convert
from orbslam3_cpp_fork_tpu_torch.models import atlas as tatlas
from orbslam3_cpp_fork_tpu_torch.models import map_state as tms
from orbslam3_cpp_fork_tpu_torch.runtime import checkpoint as tckpt

CFG = dict(max_keyframes=16, max_landmarks=256, n_features=32, imu_cap=8)


def _rot(rng, scale=0.3):
    w = rng.normal(0, scale, 3)
    th = np.linalg.norm(w)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return (np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx).astype(np.float32)


def fill_map(m, rng, n_kf, n_lm, frame0=0, imu=True):
    """Random keyframes observing random landmarks, with a temporal chain and
    IMU fields, through the MapState API (the same calls in both packages)."""
    N = m.cfg.n_features
    pos = rng.normal(0, 2, (n_lm, 3)).astype(np.float32) + [0, 0, 5]
    bits = rng.integers(0, 2, (n_lm, 256)).astype(np.int8)
    ids = m.add_landmarks(
        pos=pos, desc_packed=np.packbits(bits.astype(np.uint8), axis=-1, bitorder="little").view(np.uint32),
        desc_i8=bits, first_kf=-1, level=rng.integers(0, 8, n_lm).astype(np.int32),
        normal=rng.normal(0, 1, (n_lm, 3)).astype(np.float32),
        min_dist=rng.uniform(0.1, 1, n_lm).astype(np.float32), max_dist=rng.uniform(5, 20, n_lm).astype(np.float32),
    )
    prev = -1
    for i in range(n_kf):
        lm_idx = np.full(N, -1, np.int32)
        bound = rng.random(N) < 0.7
        lm_idx[bound] = rng.choice(ids, bound.sum(), replace=False)
        k = m.add_keyframe(
            R=_rot(rng), t=rng.normal(0, 1, 3).astype(np.float32),
            xy=rng.uniform(0, 300, (N, 2)).astype(np.float32), level=rng.integers(0, 8, N).astype(np.int32),
            angle=rng.uniform(0, 6.28, N).astype(np.float32),
            desc_packed=rng.integers(0, 2**32, (N, 8), dtype=np.uint32), feat_valid=rng.random(N) < 0.95,
            lm_idx=lm_idx, timestamp=0.05 * (frame0 + i), frame_id=frame0 + i,
            ur=rng.uniform(-1, 300, N).astype(np.float32), depth=rng.uniform(-1, 9, N).astype(np.float32),
        )
        if imu:
            m.kf_vel[k] = rng.normal(0, 1, 3)
            m.kf_bg[k], m.kf_ba[k] = rng.normal(0, 0.01, 3), rng.normal(0, 0.1, 3)
            m.kf_prev[k] = prev
            if prev >= 0:
                m.kf_next[prev] = k
            m.kf_pre_valid[k] = prev >= 0
            m.kf_pre_dR[k], m.kf_pre_dV[k], m.kf_pre_dP[k] = _rot(rng, 0.05), rng.normal(0, 1, 3), rng.normal(0, 1, 3)
            m.kf_pre_C[k] = rng.normal(0, 1, (15, 15))
            m.kf_pre_J[k] = rng.normal(0, 1, (5, 3, 3))
            m.kf_pre_dT[k], m.kf_pre_bias[k] = 0.05, rng.normal(0, 0.01, 6)
            m.kf_imu[k] = rng.normal(0, 1, m.kf_imu[k].shape)
            m.kf_imu_n[k] = rng.integers(0, m.cfg.imu_cap)
        prev = k
    m.update_landmark_stats(ids)
    return m


def two_map_atlases(seed):
    """The same two-map Atlas in both packages (map 1 active), with a hole in
    map 0's keyframe and landmark slots so that the merge fills recycled
    slots, and a Sim(3) between the maps."""
    rng = np.random.default_rng(seed)
    out = []
    for mod_atlas, mod_ms in ((jatlas, jms), (tatlas, tms)):
        r = np.random.default_rng(seed)
        atlas = mod_atlas.Atlas(mod_ms.MapConfig(**CFG))
        fill_map(atlas.maps[0], r, 7, 120)
        atlas.maps[0].kf_pre_valid[3] = False  # no re-integration when its predecessor goes
        atlas.maps[0].remove_keyframe(2)
        atlas.maps[0].remove_landmarks(np.arange(10, 20))
        atlas.create_new_map()
        fill_map(atlas.maps[1], r, 6, 90, frame0=40)
        out.append(atlas)
    M = (float(rng.uniform(0.7, 1.4)), _rot(rng), rng.normal(0, 1, 3).astype(np.float32))
    return out[0], out[1], M


def assert_maps_equal(a, b, skip=()):
    for k in convert.MAP_ARRAYS:
        if k not in skip:
            assert np.array_equal(getattr(a, k), getattr(b, k)), f"{k}: tolerance exact"
    for k in convert.MAP_SCALARS:
        assert getattr(a, k) == getattr(b, k), k


def test_create_new_map_ids_and_active_index():
    ref, got = jatlas.Atlas(jms.MapConfig(**CFG)), tatlas.Atlas(tms.MapConfig(**CFG))
    for a in (ref, got):
        a.create_new_map()
        a.create_new_map()
        a.active_idx = 0
        a.create_new_map()
    assert [m.map_id for m in got.maps] == [m.map_id for m in ref.maps] == [0, 1, 2, 3]
    assert got.active_idx == ref.active_idx == 3 and got._next_map_id == ref._next_map_id == 4
    assert got.n_maps() == ref.n_maps() == 4 and got.active is got.maps[3]


@pytest.mark.parametrize("seed,order", [(0, "src_after_dst"), (1, "src_before_dst")])
def test_merge_into_matches_the_reference(seed, order):
    ref, got, M = two_map_atlases(seed)
    if order == "src_before_dst":
        for a in (ref, got):  # the source map first in the list
            a.maps.reverse()
            a.active_idx = 0
    dst, src = (0, 1) if order == "src_after_dst" else (1, 0)
    obs_src = got.maps[src].lm_obs_count.copy()
    prev_src, next_src = got.maps[src].kf_prev.copy(), got.maps[src].kf_next.copy()
    r_kf, r_lm = ref.merge_into(dst, src, M)
    g_kf, g_lm = got.merge_into(dst, src, M)
    assert g_kf == r_kf and g_lm == r_lm, "remaps: tolerance exact"
    assert got.n_maps() == ref.n_maps() == 1 and got.active_idx == ref.active_idx == 0
    a, b = ref.maps[0], got.maps[0]
    assert_maps_equal(a, b)
    assert a.big_change_idx == 1
    # The temporal chain follows the remap.
    for k_old, k_new in g_kf.items():
        for link_src, link_dst in ((prev_src, b.kf_prev), (next_src, b.kf_next)):
            p = int(link_src[k_old])
            assert link_dst[k_new] == (g_kf[p] if p >= 0 else -1)
    # ROADMAP R14: a moved landmark's count is its observing keyframes plus
    # the source's count of the same observations.
    moved = np.asarray(list(g_lm.values()))
    n_obs = b.obs[:, moved].sum(0)
    assert np.array_equal(b.lm_obs_count[moved], n_obs + obs_src[list(g_lm)]), "counted twice (R14)"
    assert (obs_src[list(g_lm)] > 0).any() and np.array_equal(obs_src[list(g_lm)], n_obs)


def test_merge_updates_the_covisibility_graph():
    ref, got, M = two_map_atlases(2)
    ref.merge_into(0, 1, M)
    _, g_lm = got.merge_into(0, 1, M)
    a, b = ref.maps[0], got.maps[0]
    W = b.obs.astype(np.int32) @ b.obs.T.astype(np.int32)
    for k in np.nonzero(b.kf_valid)[0]:
        nb_r, w_r = a.covisible_keyframes(int(k), min_weight=1)
        nb_g, w_g = b.covisible_keyframes(int(k), min_weight=1)
        assert np.array_equal(nb_g, nb_r) and np.array_equal(w_g, w_r), "tolerance: exact"
        assert np.array_equal(np.sort(w_g), np.sort(W[k][(W[k] >= 1) & (np.arange(len(W)) != k) & b.kf_valid]))
    # Moved keyframes see the moved landmarks through the graph.
    assert b.local_map_landmarks(np.nonzero(b.kf_valid)[0]).size >= len(g_lm) - 5


def _all_arrays(atlas):
    return [{k: v for k, v in vars(m).items() if isinstance(v, np.ndarray)} for m in atlas.maps]


def test_map_state_fields_agree():
    """The checkpoint format needs no conversion: both MapStates have the same
    array fields with the same shapes and types."""
    a = {k: (v.shape, v.dtype) for k, v in vars(jms.MapState(jms.MapConfig(**CFG))).items() if isinstance(v, np.ndarray)}
    b = {k: (v.shape, v.dtype) for k, v in vars(tms.MapState(tms.MapConfig(**CFG))).items() if isinstance(v, np.ndarray)}
    assert a == b and len(a) == 45


def test_checkpoint_round_trip_bitwise(tmp_path):
    _, got, _ = two_map_atlases(3)
    got.maps[1].imu_stage, got.maps[1].imu_t0 = 2, 1.25
    path = str(tmp_path / "atlas.npz")
    tckpt.save_atlas(got, path, extra={"kfdb_seed": 0})
    back, extra = tckpt.load_atlas(path)
    assert extra == {"kfdb_seed": 0}
    assert back.active_idx == got.active_idx and back._next_map_id == got._next_map_id
    assert [m.map_id for m in back.maps] == [m.map_id for m in got.maps]
    for x, y in zip(_all_arrays(got), _all_arrays(back)):
        assert x.keys() == y.keys()
        for k in x:
            assert x[k].dtype == y[k].dtype and np.array_equal(x[k], y[k]), f"{k}: tolerance exact"
    assert (back.maps[1].imu_stage, back.maps[1].imu_t0) == (2, 1.25)
    # The restored incidence feeds the covisibility graph.
    k = int(np.nonzero(got.maps[0].kf_valid)[0][0])
    assert np.array_equal(back.maps[0].covisible_keyframes(k, min_weight=1)[1],
                          got.maps[0].covisible_keyframes(k, min_weight=1)[1])


@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_checkpoint_files_cross_load(tmp_path, direction):
    ref, got, _ = two_map_atlases(4)
    path = str(tmp_path / "atlas.npz")
    (jckpt if direction == "reference_to_port" else tckpt).save_atlas(
        ref if direction == "reference_to_port" else got, path)
    back, _ = (tckpt if direction == "reference_to_port" else jckpt).load_atlas(path)
    src = ref if direction == "reference_to_port" else got
    for x, y in zip(_all_arrays(src), _all_arrays(back)):
        for k in x:
            assert np.array_equal(x[k], y[k]), f"{k}: tolerance exact"
    assert back.active_idx == src.active_idx and back._next_map_id == src._next_map_id


def test_checkpoint_names_a_missing_field(tmp_path):
    _, got, _ = two_map_atlases(5)
    path = str(tmp_path / "atlas.npz")
    tckpt.save_atlas(got, path)
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if k != "m1.kf_vel"}
    np.savez(str(tmp_path / "cut.npz"), **arrays)
    with pytest.raises(ValueError, match="kf_vel"):
        tckpt.load_atlas(str(tmp_path / "cut.npz"))


# ------------------------------------------------------------------- R13


def _store_rows_after_reset(trk, to_np):
    """Register keyframe slot 0 of a small map in the device keyframe store,
    reset the map (fewer than 10 keyframes), give the fresh map another
    keyframe in slot 0 and read the store's row back."""
    rng = np.random.default_rng(6)
    N = trk.cfg.map_cfg.n_features

    def add(m):
        return m.add_keyframe(
            R=np.eye(3, dtype=np.float32), t=np.zeros(3, np.float32), xy=rng.uniform(0, 300, (N, 2)).astype(np.float32),
            level=np.zeros(N, np.int32), angle=np.zeros(N, np.float32),
            desc_packed=rng.integers(0, 2**32, (N, 8), dtype=np.uint32), feat_valid=np.ones(N, bool),
            lm_idx=np.full(N, -1, np.int32), timestamp=0.0, frame_id=0,
        )

    k = add(trk.map)
    trk._kf_store.sync(trk.map, [k])
    trk._spawn_or_reset_map()
    assert trk.atlas.n_maps() == 1 and trk.map.map_id == 0 and trk.map.n_keyframes() == 0
    k2 = add(trk.map)
    assert k2 == k and trk.map.kf_gen[k2] == 1
    trk._kf_store.sync(trk.map, [k2])
    return to_np(trk._kf_store.desc[k2]), trk.map.kf_desc[k2].astype(np.int64)


def test_reset_serves_fresh_device_rows_r13():
    """ROADMAP R13. The reset branch of `_spawn_or_reset_map` swaps in a fresh
    map with the same id whose keyframe generations restart at 0, so the
    first keyframe in a slot gets generation 1, the discarded keyframe's. The
    reference's store then keeps the discarded descriptors; the port's store
    is invalidated on reset and serves the new ones."""
    from orbslam3_cpp_fork_tpu.ops.camera import Camera as JCam
    from orbslam3_cpp_fork_tpu.runtime import tracker as jt
    from orbslam3_cpp_fork_tpu_torch.ops.camera import Camera as TCam
    from orbslam3_cpp_fork_tpu_torch.runtime import tracker as tt

    kw = dict(width=320, height=240, async_mapping=False, enable_loop_closing=False)
    ref = jt.Tracker(jt.TrackerConfig(camera=JCam.pinhole(200.0, 200.0, 160.0, 120.0),
                                      map_cfg=jms.MapConfig(max_keyframes=8, max_landmarks=64), **kw))
    got = tt.Tracker(tt.TrackerConfig(camera=TCam.pinhole(200.0, 200.0, 160.0, 120.0),
                                      map_cfg=tms.MapConfig(max_keyframes=8, max_landmarks=64), **kw), "cpu")
    row_r, want_r = _store_rows_after_reset(ref, lambda x: np.asarray(x).astype(np.int64))
    row_g, want_g = _store_rows_after_reset(got, lambda x: x.numpy())
    assert np.array_equal(want_r, want_g)
    assert not np.array_equal(row_r, want_r), "the reference serves the discarded keyframe's row (R13)"
    assert isinstance(got._kf_store.desc, torch.Tensor) and np.array_equal(row_g, want_g), "the port: the new row"
