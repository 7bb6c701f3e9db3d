"""The inertial Atlas from the reference's own states
(tests/inertial_merge_rig.py): the reference tracked chip_smoke.py's inertial
merge scene on EuRoC's camera rig (ROADMAP R13 repaired, as the port does)
and stored its state just before three calls. Each state is loaded into a
reference tracker and a port tracker and both make the same call.

(a) "spawn" and (b) "reset": `_spawn_or_reset_map` after each blind
    stretch. Both give the same map ids in the same order, the same maps
    bit for bit, the same database rows and codebook, and the same live and
    VI runtime fields; the reset keeps the map id, leaves no keyframe and
    erases the map's database rows.
(c) "merge": the loop step whose proposal welds map 1 (past its own VIBA2)
    into map 0:
    1. the same proposal: destination map, candidate, Sim(3) within 1e-4;
    2. the weld (sM, RM, tM) within 1e-5, the same keyframe and landmark
       remaps, the moved keyframes' temporal links, preintegrations and raw
       IMU rows equal, their velocities (v RM / sM) within 1e-5, the
       merged map's IMU stage and imu_t0 equal;
    3. SearchAndFuse around the weld: the same bindings (tables exact);
    4. the database rows after the weld equal;
    5. the live state the merge leaves: cur_v (within 1e-5), last_kf_slot,
       last_body and prior_H dropped;
    6. `_merge_inertial_ba` (a VI BA padded to 2 x vi_kf_cap keyframes):
       poses, velocities and biases within tests/test_torch_vi_ba.py's 1e-4,
       landmarks within 1e-3 of their distance from the welded keyframe's
       centre (one landmark 8.4 m away parts by 1.8 mm, 2.2e-4 of it; the
       next by 0.38 mm); no merge_eg span.
The five frames after the weld: tests/test_torch_inertial_merge_frames.py.

ROADMAP R23's witness: the weld applies the whole rotation of the Sim(3)
solve, so it tilts every moved keyframe's gravity direction by the angle
between RM e_z and e_z, in both implementations (ORB-SLAM3 welds two
inertial maps by yaw alone).
"""

import numpy as np
import pytest
import torch

import chip_smoke
from inertial_merge_rig import STATES, live_frame, load_states, loaded, scene_and_frames
from orbslam3_cpp_fork_tpu_torch import convert

TOL = 1e-4  # proposal Sim(3), the merge VI BA
TOL_WELD = 1e-5
TOL_LM = 1e-3
INERTIAL_EXACT = ("kf_bg", "kf_ba", "kf_pre_valid", "kf_pre_dR", "kf_pre_dV", "kf_pre_dP", "kf_pre_C", "kf_pre_J",
                  "kf_pre_dT", "kf_pre_bias", "kf_imu", "kf_imu_n")


@pytest.fixture(scope="module")
def stored():
    states, meta = load_states(STATES)
    scene = scene_and_frames(render=False)[0]
    return states, meta, scene


def _modules(impl):
    if impl == "reference":
        from orbslam3_cpp_fork_tpu.runtime import tracker

        return tracker
    from orbslam3_cpp_fork_tpu_torch.runtime import tracker

    return tracker


def _with_one_thread(fn):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return fn()
    finally:
        torch.set_num_threads(n)


def test_the_states_are_the_reference_run(stored):
    states, meta, _ = stored
    spawn, reset, merge, after = (states[k] for k in ("spawn", "reset", "merge", "after"))
    print(f"\nthe reference's run (R13 repaired): spawns and resets "
          f"{[(r['frame'], r['kind'], r['map_id'], r['kfs'], r['stage']) for r in meta['spawns']]}; welds "
          f"{[(r['frame'], r['src'], r['dst'], r['kfs'], r['s'], r['tilt_deg']) for r in meta['welds']]}; stages by "
          f"map {meta['stages']}; imu_t0 {meta['imu_t0']}; at the weld {meta['weld']}; at the end {meta['end']}; "
          "loops "
          f"{[(r['kf_frame'], r['match_frame']) for r in meta['loops']]}")
    assert not meta["missing"]
    m0 = spawn["atlas"]["maps"][spawn["atlas"]["active_idx"]]
    assert int(m0["map_id"]) == 0 and int(m0["imu_stage"]) == 3 and int(m0["kf_valid"].sum()) >= 10
    a = reset["atlas"]
    m1 = a["maps"][a["active_idx"]]
    assert len(a["maps"]) == 2 and int(m1["map_id"]) == 1 and int(m1["kf_valid"].sum()) < 10
    a = merge["atlas"]
    m1 = a["maps"][a["active_idx"]]
    assert len(a["maps"]) == 2 and int(m1["map_id"]) == 1 and int(m1["imu_stage"]) == 3
    assert [r["kind"] for r in meta["spawns"]] == ["spawn", "reset"] and meta["welds"][0]["dst"] == 0
    assert len(after["atlas"]["maps"]) == 1 and after["call"]["at"] == merge["call"]["at"] == meta["welds"][0]["frame"]


def _vi_runtime(trk):
    pre = trk._pre_from_kf
    return dict(cur_v=np.array(trk.cur_v), cur_bg=np.array(trk.cur_bg), cur_ba=np.array(trk.cur_ba),
                last_body=trk.last_body, prior_H=trk.prior_H, pre=pre, since=len(trk._imu_since_kf),
                since_t=list(trk._imu_since_kf_t), last_kf_slot=int(trk.last_kf_slot),
                refine=int(trk._scale_refine_idx), inserted=bool(trk._kf_inserted_last_frame),
                last_imu_t=trk._last_imu_t)


@pytest.mark.parametrize("stage", ["spawn", "reset"])
def test_spawn_or_reset_agrees(stored, stage):
    states, _, scene = stored
    S = states[stage]
    out = {}
    for impl in ("reference", "port"):
        def run(impl=impl):
            trk = loaded(impl, scene, S)
            trk._spawn_or_reset_map()
            return trk

        out[impl] = _with_one_thread(run)
    ref, got = out["reference"], out["port"]
    a_ref, a_got = convert.atlas_to_numpy(ref.atlas), convert.atlas_to_numpy(got.atlas)
    ids = [int(m["map_id"]) for m in a_ref["maps"]]
    print(f"\n{stage}: maps {ids} (active {a_ref['active_idx']}), keyframes "
          f"{[int(m['kf_valid'].sum()) for m in a_ref['maps']]}; database rows {int(ref.kfdb.present.sum())}, "
          f"codebook refreshes {ref.kfdb.n_refreshes}")
    assert [int(m["map_id"]) for m in a_got["maps"]] == ids
    assert (a_got["active_idx"], a_got["next_map_id"]) == (a_ref["active_idx"], a_ref["next_map_id"])
    for mr, mg in zip(a_ref["maps"], a_got["maps"]):
        for k in convert.MAP_SCALARS:
            assert mg[k] == mr[k], k
        for k in convert.MAP_ARRAYS:
            assert np.array_equal(mg[k], mr[k]), f"map {mr['map_id']}: {k}, tolerance exact"
    d_ref, d_got = convert.kfdb_to_numpy(ref.kfdb), convert.kfdb_to_numpy(got.kfdb)
    for k in ("present", "hists", "codebook", "n_refreshes", "pool_count"):
        assert np.array_equal(d_got[k], d_ref[k]), f"database {k}, tolerance exact"
    assert sorted(d_got["desc_store"]) == sorted(d_ref["desc_store"])
    assert ref.state.name == got.state.name == "NO_IMAGES_YET"
    assert (ref.ref_kf, ref.n_kf_inserted, ref.lost_frames) == (got.ref_kf, got.n_kf_inserted, got.lost_frames)
    assert ref.velocity is None and got.velocity is None
    vr, vg = _vi_runtime(ref), _vi_runtime(got)
    for k in ("cur_v", "cur_bg", "cur_ba"):
        assert np.array_equal(vg[k], vr[k]) and not vg[k].any(), k
    for k in ("last_body", "prior_H", "pre"):
        assert vr[k] is None and vg[k] is None, k
    for k in ("since", "since_t", "last_kf_slot", "refine", "inserted", "last_imu_t"):
        assert vg[k] == vr[k], k
    # The port drops its device keyframe store and local-map snapshot at every
    # spawn and reset (ROADMAP R13).
    assert (got._kf_store.gen == -1).all() and got._dev_local is None
    K = ref.cfg.map_cfg.max_keyframes
    old = S["atlas"]["maps"][S["atlas"]["active_idx"]]
    ns = int(old["map_id"]) % 16
    if stage == "reset":
        assert ids == [0, 1] and a_ref["active_idx"] == 1 and int(a_ref["maps"][1]["kf_valid"].sum()) == 0
        assert not d_ref["present"][ns * K:(ns + 1) * K].any(), "the reset map's database rows are erased"
    else:
        assert ids == [0, 1] and a_ref["active_idx"] == 1 and int(a_ref["maps"][0]["kf_valid"].sum()) >= 10
        assert d_ref["present"][ns * K:(ns + 1) * K].sum() == int(old["kf_valid"].sum()), "map 0 keeps its rows"


def _merge_run(impl, scene, S):
    """Load state (c) and run the loop step with spies. Returns the tracker
    and what the spies saw."""
    mod = _modules(impl)
    trk = loaded(impl, scene, S)
    lc, atlas = trk.loop_closer, trk.atlas
    seen = dict(proposals=[], welds=[], moved=[], fused=[])
    real_pk, real_merge, real_fuse = lc.process_keyframe, atlas.merge_into, lc._search_and_fuse

    def process_keyframe(*a, **kw):
        out = real_pk(*a, **kw)
        seen["proposals"].append(out)
        return out

    def merge_into(dst_idx, src_idx, M):
        kf_remap, lm_remap = real_merge(dst_idx, src_idx, M)
        dst = atlas.active
        kn = np.asarray(sorted(kf_remap.values()), np.int64)
        seen["welds"].append((float(M[0]), np.array(M[1]), np.array(M[2])))
        seen["moved"].append(dict(kf_remap=dict(kf_remap), lm_remap=dict(lm_remap), imu_stage=int(dst.imu_stage),
                                  imu_t0=float(dst.imu_t0), map_id=int(dst.map_id),
                                  **{k: np.array(getattr(dst, k)[kn]) for k in
                                     ("kf_R", "kf_vel", "kf_prev", "kf_next", *INERTIAL_EXACT)}))
        return kf_remap, lm_remap

    def search_and_fuse(*a, **kw):
        out = real_fuse(*a, **kw)
        m = trk.map
        seen["fused"].append({k: np.array(getattr(m, k)) for k in ("lm_valid", "lm_replaced", "kf_lm_idx", "obs")})
        return out

    lc.process_keyframe, atlas.merge_into, lc._search_and_fuse = process_keyframe, merge_into, search_and_fuse
    call = S["call"]
    frame = live_frame(mod, call["frame"])
    trk._loop_step(call["k"], trk.map, frame=frame)
    seen["after"] = dict(cur_v=np.array(trk.cur_v), last_kf_slot=int(trk.last_kf_slot), last_body=trk.last_body,
                         prior_H=trk.prior_H, frame_R=frame.R.copy(), frame_t=frame.t.copy(),
                         lm_idx=frame.lm_idx.copy(), kfdb=convert.kfdb_to_numpy(trk.kfdb),
                         map={k: np.array(getattr(trk.map, k)) for k in
                              ("kf_valid", "kf_R", "kf_t", "kf_vel", "kf_bg", "kf_ba", "lm_valid", "lm_pos")},
                         spans={k: len(v) for k, v in trk.timers.samples.items() if k.startswith("merge")})
    return trk, seen


@pytest.fixture(scope="module")
def merged(stored):
    states, meta, scene = stored
    S = states["merge"]
    out = {impl: _with_one_thread(lambda impl=impl: _merge_run(impl, scene, S)) for impl in ("reference", "port")}
    return S, meta, out


def test_same_proposal(merged):
    S, meta, out = merged
    (pr,), (pg,) = (out[impl][1]["proposals"] for impl in ("reference", "port"))
    print(f"\nproposal: map {pr[3]} keyframe {pr[4]} -> map {pr[0]} keyframe {pr[1]}, Sim(3) scale {pr[2][0]!r} "
          f"(port {pg[2][0]!r})")
    assert pr is not None and pg is not None
    assert (pg[0], pg[1], pg[3], pg[4]) == (pr[0], pr[1], pr[3], pr[4]) == (0, pr[1], 1, S["call"]["k"])
    assert abs(float(pg[2][0]) - float(pr[2][0])) <= TOL * float(pr[2][0])
    np.testing.assert_allclose(np.asarray(pg[2][1]), np.asarray(pr[2][1]), atol=TOL)
    np.testing.assert_allclose(np.asarray(pg[2][2]), np.asarray(pr[2][2]), atol=TOL)


def test_same_weld_and_moved_inertial_state(merged):
    _, meta, out = merged
    (wr,), (wg,) = (out[impl][1]["welds"] for impl in ("reference", "port"))
    (mr,), (mg,) = (out[impl][1]["moved"] for impl in ("reference", "port"))
    tilt = chip_smoke.weld_tilt_deg(wr[1])
    print(f"\nweld: sM {wr[0]!r} / {wg[0]!r}, |RM| apart {np.abs(wg[1] - wr[1]).max():.2e}, |tM| apart "
          f"{np.abs(wg[2] - wr[2]).max():.2e}; tilt of RM e_z {tilt:.4f} deg (port "
          f"{chip_smoke.weld_tilt_deg(wg[1]):.4f}); {len(mr['kf_remap'])} keyframes and {len(mr['lm_remap'])} "
          f"landmarks moved; velocities apart {np.abs(mg['kf_vel'] - mr['kf_vel']).max():.2e}")
    assert abs(wg[0] - wr[0]) <= TOL_WELD
    assert np.abs(wg[1] - wr[1]).max() <= TOL_WELD and np.abs(wg[2] - wr[2]).max() <= TOL_WELD
    assert mg["kf_remap"] == mr["kf_remap"] and mg["lm_remap"] == mr["lm_remap"]
    assert (mg["map_id"], mg["imu_stage"], mg["imu_t0"]) == (mr["map_id"], mr["imu_stage"], mr["imu_t0"]) == (
        0, 3, mr["imu_t0"])
    for k in ("kf_prev", "kf_next", *INERTIAL_EXACT):
        assert np.array_equal(mg[k], mr[k]), f"{k}, tolerance exact"
    assert np.abs(mg["kf_vel"] - mr["kf_vel"]).max() <= TOL_WELD


def test_search_and_fuse_fuses_the_same_landmarks(merged):
    (fr,), (fg,) = (out[1]["fused"] for out in merged[2].values())
    for k in fr:
        assert np.array_equal(fg[k], fr[k]), f"{k}: tolerance exact"


def test_same_database_rows_and_live_state_after_the_weld(merged):
    ar, ag = (merged[2][impl][1]["after"] for impl in ("reference", "port"))
    for k in ("present", "hists", "codebook"):
        assert np.array_equal(ag["kfdb"][k], ar["kfdb"][k]), f"database {k}, tolerance exact"
    assert sorted(ag["kfdb"]["desc_store"]) == sorted(ar["kfdb"]["desc_store"])
    assert ag["last_kf_slot"] == ar["last_kf_slot"] >= 0
    assert ar["last_body"] is None and ag["last_body"] is None, "the body state follows the welded pose"
    assert ar["prior_H"] is None and ag["prior_H"] is None, "the marginal prior is dropped"
    assert np.abs(ag["cur_v"] - ar["cur_v"]).max() <= TOL_WELD
    assert np.array_equal(ag["lm_idx"], ar["lm_idx"]), "the live frame's bindings follow the landmark remap"


def test_merge_inertial_ba_agrees(merged):
    ar, ag = (merged[2][impl][1]["after"] for impl in ("reference", "port"))
    for impl, a in (("reference", ar), ("port", ag)):
        print(f"\n{impl}: merge spans {a['spans']}")
        assert a["spans"].get("merge_vi_ba") == 1 and "merge_eg" not in a["spans"]
    assert ag["spans"].get("merge") == 1, "the port times the whole merge"
    mr, mg = ar["map"], ag["map"]
    kv, lv = mr["kf_valid"], mr["lm_valid"]
    assert np.array_equal(mg["kf_valid"], kv) and np.array_equal(mg["lm_valid"], lv)
    for f in ("kf_R", "kf_t", "kf_vel", "kf_bg", "kf_ba"):
        err = float(np.abs(mg[f][kv] - mr[f][kv]).max())
        print(f"{f}: max |port - reference| {err:.3e} over {int(kv.sum())} keyframes")
        assert err <= TOL, f
    S, _, out = merged
    k = out["reference"][1]["moved"][0]["kf_remap"][S["call"]["k"]]
    c = -mr["kf_R"][k].T @ mr["kf_t"][k]
    d = np.abs(mg["lm_pos"][lv] - mr["lm_pos"][lv]).max(1)
    depth = np.maximum(np.linalg.norm(mr["lm_pos"][lv] - c, axis=1), 1.0)
    print(f"landmarks: max |port - reference| {d.max():.3e}, {(d / depth).max():.3e} of the distance from keyframe "
          f"{k}'s centre, over {int(lv.sum())}")
    assert (d / depth).max() <= TOL_LM
    assert np.abs(ag["frame_R"] - ar["frame_R"]).max() <= TOL and np.abs(ag["frame_t"] - ar["frame_t"]).max() <= TOL


def test_the_weld_tilts_the_moved_keyframes_gravity_r23(merged):
    """ROADMAP R23. Both maps are gravity-aligned by their own IMU init, but
    the weld applies the Sim(3) solve's whole rotation RM (its roll and
    pitch too), so each moved keyframe's gravity direction in its camera
    frame, R_cw e_z, turns by the angle between RM e_z and e_z."""
    S, _, out = merged
    a = S["atlas"]
    src = a["maps"][a["active_idx"]]
    for impl in ("reference", "port"):
        (w,), (moved,) = out[impl][1]["welds"], out[impl][1]["moved"]
        tilt = chip_smoke.weld_tilt_deg(w[1])
        ks = np.asarray(sorted(moved["kf_remap"]), np.int64)
        at = np.searchsorted(sorted(moved["kf_remap"].values()), [moved["kf_remap"][int(k)] for k in ks])
        turn = chip_smoke.tilt_deg(src["kf_R"][ks][:, :, 2], moved["kf_R"][at][:, :, 2])
        print(f"\n{impl}: weld tilt {tilt:.4f} deg; the moved keyframes' gravity directions turned by "
              f"{turn.min():.4f}-{turn.max():.4f} deg")
        assert tilt > 0.05, "the weld tilts the welded map (R23)"
        np.testing.assert_allclose(turn, tilt, atol=1e-3)


def test_a_reset_maps_frames_export_at_the_new_maps_keyframes_r24(stored):
    """ROADMAP R24. From state (b): a frame recorded against keyframe k of
    the map about to be reset; the reset keeps the map id and the fresh map's
    first keyframe takes slot k again. Both implementations then export the
    frame at the new keyframe's pose (ORB-SLAM3's ResetActiveMap marks such
    frames lost)."""
    states, _, scene = stored
    S = states["reset"]
    a = S["atlas"]
    old = a["maps"][a["active_idx"]]
    k = int(np.nonzero(old["kf_valid"])[0][0])
    R_new = np.eye(3, dtype=np.float32)
    t_new = np.array([0.0, 0.0, 2.0], np.float32)
    for impl in ("reference", "port"):
        def run(impl=impl):
            trk = loaded(impl, scene, S)
            fid = int(old["kf_frame_id"][k])
            trk.trajectory = [(fid, float(old["kf_timestamp"][k]), int(old["map_id"]), k, np.eye(3, dtype=np.float32),
                               np.zeros(3, np.float32))]
            trk._spawn_or_reset_map()
            m = trk.map
            assert m.map_id == int(old["map_id"]) and m.n_keyframes() == 0
            m.kf_valid[k], m.kf_R[k], m.kf_t[k] = True, R_new, t_new
            return trk.export_trajectory()

        ts_est, Twc = _with_one_thread(run)
        c_old = -old["kf_R"][k].T @ old["kf_t"][k]
        print(f"\n{impl}: {len(ts_est)} pose(s) exported for the reset map's frame, centre {Twc[0][:3, 3]} (its own "
              f"keyframe's centre was {c_old})")
        assert len(ts_est) == 1
        np.testing.assert_allclose(Twc[0][:3, 3], -R_new.T @ t_new, atol=1e-6)
        assert np.linalg.norm(Twc[0][:3, 3] - c_old) > 0.5


def test_atlas_round_trip_keeps_every_maps_inertial_fields(stored):
    """State (c)'s Atlas (two inertial maps at stage 3) through
    `convert.atlas_from_numpy` / `atlas_to_numpy` bit for bit, and a port
    tracker loaded with it gives every map, the inactive one too, its IMU
    calibration (the merge takes the inertial branch only with the
    destination's)."""
    states, _, scene = stored
    S = states["merge"]
    back = convert.atlas_to_numpy(convert.atlas_from_numpy(S["atlas"]))
    assert (back["active_idx"], back["next_map_id"]) == (S["atlas"]["active_idx"], S["atlas"]["next_map_id"])
    for a, b in zip(S["atlas"]["maps"], back["maps"]):
        assert int(a["imu_stage"]) == 3
        for k in (*convert.MAP_SCALARS, *convert.MAP_ARRAYS):
            assert np.array_equal(np.asarray(a[k]), np.asarray(b[k])), k
    trk = loaded("port", scene, S)
    assert all(m._imu_calib is trk.imu_calib for m in trk.atlas.maps) and trk.atlas.imu_calib is trk.imu_calib
