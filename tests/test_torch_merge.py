"""The Atlas merge and map spawning of the runtime, port against reference
(`_execute_merge` and the merge essential graph:
tests/test_torch_merge_execute.py).

- `LoopCloser.on_merge`: the loop edges, exact.
- The merge branch of `_detect_and_correct` on a two-map Atlas with the
  scripted validation of tests/test_loop_confirmation.py: the same proposal
  (map ids, keyframes, Sim(3)) or the same pending streak, exact.
- `_spawn_or_reset_map` (both branches) and `_timestamp_guards` on a map of
  random features: the same Atlas, state, database rows and refreshed
  codebook, exact.
- ROADMAP R16: the 17th map of a session takes over map 0's database rows
  in both implementations, and the port logs it.
"""

import logging

import numpy as np
import pytest
import torch

from orbslam3_cpp_fork_tpu.models import atlas as jatlas
from orbslam3_cpp_fork_tpu.models import map_state as jms
from orbslam3_cpp_fork_tpu.ops import camera as jcam
from orbslam3_cpp_fork_tpu.ops import orb as jorb
from orbslam3_cpp_fork_tpu.runtime import loop_closing as jlc
from orbslam3_cpp_fork_tpu.runtime import tracker as jt
from orbslam3_cpp_fork_tpu_torch import convert
from orbslam3_cpp_fork_tpu_torch.models import atlas as tatlas
from orbslam3_cpp_fork_tpu_torch.models import map_state as tms
from orbslam3_cpp_fork_tpu_torch.runtime import loop_closing as tlc
from orbslam3_cpp_fork_tpu_torch.runtime import tracker as tt

import merge_rig
import test_loop_confirmation as tlconf
import test_torch_atlas
from merge_rig import CAPS, H, MAP_CFG, N_FEAT, W, live_frame
from test_torch_loop_closing import _PortScripted


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_on_merge_matches_the_reference():
    S = (1.0, np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    edges = [(0, 1, 5, S), (1, 2, 7, S), (1, 3, 9, S), (2, 0, 4, S)]
    remap = {2: 11, 7: 12, 3: 13}
    out = []
    for mod in (jlc, tlc):
        lc = object.__new__(mod.LoopCloser)
        lc.loop_edges = list(edges)
        lc.on_merge(1, 0, remap)
        out.append(lc.loop_edges)
    assert [e[:3] for e in out[1]] == [e[:3] for e in out[0]] == [(0, 1, 5), (0, 11, 12), (2, 0, 4)]


# ------------------------------------------ the merge branch of detection


def _line_map(mod, n_kf=20):
    m = mod.MapState(mod.MapConfig(max_keyframes=64, max_landmarks=256, n_features=8))
    for i in range(n_kf):
        m.add_keyframe(
            R=np.eye(3, dtype=np.float32), t=np.array([-0.1 * i, 0, 0], np.float32),
            xy=np.zeros((8, 2), np.float32), level=np.zeros(8, np.int32), angle=np.zeros(8, np.float32),
            desc_packed=np.zeros((8, 8), np.uint32), feat_valid=np.ones(8, bool), lm_idx=np.full(8, -1, np.int32),
            timestamp=float(i), frame_id=i,
        )
    return m


def _two_map_atlas(mod_atlas, mod_ms):
    atlas = mod_atlas.Atlas(mod_ms.MapConfig(max_keyframes=64, max_landmarks=256, n_features=8))
    atlas.maps = [_line_map(mod_ms)]
    atlas.create_new_map()
    atlas.maps[1] = _line_map(mod_ms)
    atlas.maps[1].map_id = 1
    return atlas


@pytest.mark.parametrize("script,target", [
    ([120, 120, 120, None], "other map"),  # three validations in map 0: a merge proposal
    ([120, 120, None, None], "other map"),  # two: a pending streak, no proposal
    ([55, 55, 55], "active map"),  # the candidate in the active map: a loop correction
])
def test_merge_branch_of_detection_matches_the_reference(script, target):
    max_k = 64
    gid = 3 if target == "other map" else 1 * max_k + 3  # keyframe 3 of map 0, or of map 1
    cfg = dict(min_kfs=2, kf_gap_after_loop=0)
    ref = tlconf._ScriptedCloser(_two_map_atlas(jatlas, jms), tlconf._FakeKFDB(gid), script, jlc.LoopConfig(**cfg))
    got = _PortScripted(_two_map_atlas(tatlas, tms), tlconf._FakeKFDB(gid), script, tlc.LoopConfig(**cfg))
    outs = []
    for lc in (ref, got):
        props = [lc.process_keyframe(k) for k in range(12, 12 + len(script))]
        outs.append([None if p is None else (p[0], p[1], float(p[2][0]), p[3], p[4]) for p in props])
    assert outs[1] == outs[0], "tolerance: exact"
    assert got.n_merges == ref.n_merges and got.corrected == ref.corrected
    assert (got.pending is None) == (ref.pending is None)
    if got.pending is not None:
        assert got.pending[:2] == ref.pending[:2] and got.pending[3] == ref.pending[3]
    if script[2] is not None and target == "other map":
        assert outs[1][2] == (0, 3, 1.0, 1, 14) and got.n_merges == 1 and not got.corrected
    if target == "active map":
        assert got.corrected == [(14, 3)] and got.n_merges == 0


# --------------------------------------- spawn, reset, timestamp guard


def _ref_tracker(scene, **kw):
    K = scene.K
    return jt.Tracker(jt.TrackerConfig(
        camera=jcam.Camera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2]), width=W, height=H,
        orb=jorb.OrbParams(n_features=N_FEAT), async_mapping=False, mapping_backend="cpu",
        map_cfg=jms.MapConfig(**MAP_CFG), **CAPS, **kw,
    ))


def _ref_map(d):
    m = jms.MapState(jms.MapConfig(n_features=d["kf_xy"].shape[1], imu_cap=d["kf_imu"].shape[1], **MAP_CFG),
                     map_id=d["map_id"])
    for k in convert.MAP_ARRAYS:
        getattr(m, k)[...] = d[k]
    for k in convert.MAP_SCALARS:
        setattr(m, k, d[k])
    m.mark_obs_dirty()
    return m


def _loaded_pair(scene, atlas_np, **kw):
    """A reference and a port tracker on the same Atlas (`atlas_to_numpy`),
    keyframe database rows and trajectory records, OK on keyframe
    merge_rig.K_B of the active map."""
    got = merge_rig.loaded_port_tracker(scene, atlas_np, **kw)
    ref = _ref_tracker(scene, **kw)
    ref.atlas.maps = [_ref_map(d) for d in atlas_np["maps"]]
    ref.atlas.active_idx, ref.atlas._next_map_id = atlas_np["active_idx"], atlas_np["next_map_id"]
    ref.state = jt.TrackState.OK
    ref.ref_kf, ref.frame_id = got.ref_kf, got.frame_id
    ref.trajectory = [(f, t, mid, k, R.copy(), tt_.copy()) for f, t, mid, k, R, tt_ in got.trajectory]
    merge_rig.register(ref)
    return ref, got


def _export(trk):
    ts, Twc = trk.export_trajectory()
    return np.asarray(ts), np.asarray(Twc)


def _random_map(n_kf):
    """One map of `n_kf` keyframes of random features and bindings
    (tests/test_torch_atlas.py's filler), as `atlas_to_numpy` gives it."""
    m = tms.MapState(tms.MapConfig(n_features=N_FEAT, **MAP_CFG))
    test_torch_atlas.fill_map(m, np.random.default_rng(8), n_kf, 600, imu=False)
    return dict(maps=[convert.map_state_to_numpy(m)], active_idx=0, next_map_id=1)


@pytest.mark.parametrize("n_kf,branch", [(6, "reset"), (12, "spawn")])
def test_spawn_or_reset_matches_the_reference(n_kf, branch):
    ref, got = _loaded_pair(merge_rig.ring_scene(), _random_map(12))
    for trk in (ref, got):
        m = trk.map
        for k in np.nonzero(m.kf_valid)[0][n_kf:]:
            trk.kfdb.erase(trk._gid(int(k)))
            m.remove_keyframe(int(k))
        trk.ref_kf = 0
        trk._spawn_or_reset_map()
    assert [m.map_id for m in got.atlas.maps] == [m.map_id for m in ref.atlas.maps]
    assert got.atlas.n_maps() == (1 if branch == "reset" else 2) and got.atlas.active_idx == ref.atlas.active_idx
    assert got.map.n_keyframes() == 0 and got.state.name == ref.state.name == "NO_IMAGES_YET"
    assert (got.ref_kf, got.n_kf_inserted, got.lost_frames) == (ref.ref_kf, ref.n_kf_inserted, ref.lost_frames)
    assert sorted(got.kfdb._desc_store) == sorted(ref.kfdb._desc_store), "database rows: tolerance exact"
    assert len(got.kfdb._desc_store) == (0 if branch == "reset" else n_kf)
    assert got.kfdb.n_refreshes == ref.kfdb.n_refreshes
    if got.kfdb.codebook is not None or ref.kfdb.codebook is not None:
        assert np.array_equal(got.kfdb.codebook, ref.kfdb.codebook), "codebook refresh: tolerance exact"
    if branch == "spawn":
        kept = [m for m in got.atlas.maps if m.map_id == 0][0]
        assert kept.n_keyframes() == n_kf


@pytest.mark.parametrize("dt,spawns", [(-0.1, True), (0.1, False)])
def test_timestamp_guards_match_the_reference(dt, spawns):
    one = _random_map(12)
    ref, got = _loaded_pair(merge_rig.ring_scene(), one)
    for trk, mod in ((ref, jt), (got, tt)):
        trk.last = live_frame(mod, one["maps"][0], 3)
        trk._timestamp_guards(5.0 + dt)
    assert got.atlas.n_maps() == ref.atlas.n_maps() == (2 if spawns else 1)
    assert got.state.name == ref.state.name == ("NO_IMAGES_YET" if spawns else "OK")


def test_a_seventeenth_map_shares_map_0s_database_rows_r16(caplog):
    """ROADMAP R16 (the reference's, copied): database rows are namespaced by
    map_id % 16 and map ids only grow, so the 17th map of a session (id 16)
    writes over map 0's rows. Both implementations spawn it from an
    established map 15: the same map ids and rows, and a keyframe of map 16
    replaces map 0's keyframe in the shared row (exact); the port warns."""
    one = _random_map(12)
    ref, got = _loaded_pair(merge_rig.ring_scene(), one)
    bits = np.unpackbits(one["maps"][0]["kf_desc"][5].view(np.uint8), axis=-1, bitorder="little").astype(np.int8)
    valid = one["maps"][0]["kf_feat_valid"][5]
    for trk, load in ((ref, _ref_map), (got, convert.map_state_from_numpy)):
        for _ in range(15):
            trk.atlas.create_new_map()
        trk.atlas.maps[trk.atlas.active_idx] = load(dict(one["maps"][0], map_id=15))
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            trk._spawn_or_reset_map()
        assert [m.map_id for m in trk.atlas.maps] == list(range(17)) and trk.map.map_id == 16
        row0 = trk._gid(0, 0)
        assert trk._gid(0) == row0, "map 16's slot 0 is map 0's row"
        before = trk.kfdb._desc_store[row0][0].copy()
        trk.kfdb.add(trk._gid(0), bits, valid)
        after = trk.kfdb._desc_store[row0][0]
        assert not np.array_equal(before, after)
        assert np.array_equal(after, trk.kfdb._desc_store[trk._gid(5, 0)][0]), "map 0's row now holds map 16's keyframe"
        warned = any("ROADMAP R16" in r.getMessage() for r in caplog.records)
        assert warned == (trk is got), "the port warns at the spawn; the reference does not"
    assert sorted(got.kfdb._desc_store) == sorted(ref.kfdb._desc_store), "database rows: tolerance exact"
