"""The first loop on a stereo-inertial map, from the reference's own state
(tests/stereo_inertial_long_rig.py, state "loop"): the reference tracked
chip_smoke.py's stereo inertial long scene (EuRoC's baseline and camera
rig) past VIBA2 (stage 3) to the loop step that closed its first loop, the
hypothesis pending. That state is loaded into a reference tracker and a
port tracker; each runs that one loop step, the global BA requested inline
as in the synchronous run, and the stages of the correction are recorded on both
sides (chip_smoke.record_loop_stages and record_inertial_path) and compared
in order:

1. the guard opens on both (stage 3): the same candidate validated, its
   transform within 1e-4 and its scale exactly 1 (IMU_STEREO solves the
   loop's Sim(3) with a fixed scale);
2. the window correction: keyframe poses within 1e-4, landmarks within 1e-3;
3. SearchAndFuse: the same landmarks fused (tables exact);
4. the essential graph in "4dof" mode on both (OptimizeEssentialGraph4DoF):
   poses within 1e-4, landmarks within 1e-3; on both sides, across the
   graph, no keyframe's gravity direction in its body frame (Rwb^T e_z) and
   no vertex scale moves by 1e-5 or more;
5. the global BA request: FullInertialBA(7), inline, over the whole
   chain's stereo rows (the same route, keyframes, rows and stereo rows on
   both). Its solve is skipped here (`_run_vi_ba` stubbed on both) and held
   in tests/test_torch_stereo_inertial_long_gba.py from the reference's own
   state at that request.

And the guard while closed: from the same state with the map's stage set
back to 2, neither side attempts a loop or a merge.
"""

import numpy as np
import pytest

import chip_smoke
from stereo_inertial_long_rig import run_both

TOL_POSE = 1e-4
TOL_LM = 1e-3
TOL_GRAVITY = 1e-5


def _step(trk, mod, S):
    trk._loop_step(S["call"]["k"], trk.map)


def _no_solve(trk):
    trk._run_vi_ba = lambda *a, **kw: None


@pytest.fixture(scope="module")
def runs():
    return run_both("loop", _step, prepare=_no_solve, keep=True)


def _loop(runs, impl):
    (rec,) = runs[4][impl]["loops"]
    return rec


def test_the_state_is_the_reference_run_before_its_first_stereo_inertial_loop(runs):
    S, meta, Rs, ts, out = runs
    m, call = S["map"], S["call"]
    first = meta["loops"][0]
    dist, deg = chip_smoke.revisit(Rs, ts, first)
    print(f"\nstate: frame {call['at']}, keyframe {call['k']}, stage {int(m['imu_stage'])}, "
          f"{int(m['kf_valid'].sum())} live keyframes, {int(m['lm_valid'].sum())} landmarks; the reference's loops "
          f"{[(r['kf_frame'], r['match_frame']) for r in meta['loops']]}; the first: {dist:.3f} m, {deg:.1f} deg apart")
    assert int(m["imu_stage"]) == 3 and S["loop"]["n_loops_closed"] == 0
    assert S["loop"]["pending"] is not None, "the loop's hypothesis is pending"
    assert first["kf"] == call["k"] and deg <= chip_smoke.LOOP_REVISIT_DEG, "a true revisit"


def test_same_candidate_and_a_fixed_scale_transform(runs):
    a, b = _loop(runs, "reference"), _loop(runs, "port")
    meta = runs[1]
    for name, r in (("reference", a), ("port", b)):
        print(f"\n{name}: validations {[(k, c, None if v is None else (v[0], v[3])) for k, c, v in r['validations']]}, "
              f"projection counts {r['projections']}, Sim(3) scale {r['s']!r}")
        assert runs[4][name]["trk"].loop_closer.n_loops_closed == 1
    assert (a["kf"], a["match"]) == (b["kf"], b["match"]) == (meta["loops"][0]["kf"], meta["loops"][0]["match"])
    assert [v[:2] for v in a["validations"]] == [v[:2] for v in b["validations"]]
    assert [p[:2] for p in a["projections"]] == [p[:2] for p in b["projections"]]
    assert a["s"] == b["s"] == 1.0, "a fixed scale"
    np.testing.assert_allclose(b["R"], a["R"], atol=TOL_POSE)
    np.testing.assert_allclose(b["t"], a["t"], atol=TOL_POSE)


def _apart(a, b):
    kv, lv = a["kf_valid"], a["lm_valid"]
    assert np.array_equal(kv, b["kf_valid"]) and np.array_equal(lv, b["lm_valid"])
    return (float(np.abs(a["kf_R"][kv] - b["kf_R"][kv]).max()), float(np.abs(a["kf_t"][kv] - b["kf_t"][kv]).max()),
            float(np.abs(a["lm_pos"][lv] - b["lm_pos"][lv]).max()))


@pytest.mark.parametrize("stage", ["window", "essential_graph"])
def test_poses_and_landmarks_agree_after(runs, stage):
    a, b = _loop(runs, "reference")["stages"][stage], _loop(runs, "port")["stages"][stage]
    dR, dt, dX = _apart(a, b)
    print(f"\nafter {stage}: max |dR| {dR:.2e}, max |dt| {dt:.2e}, max |dX| {dX:.2e}")
    assert dR <= TOL_POSE and dt <= TOL_POSE, "tolerance: 1e-4"
    assert dX <= TOL_LM, "tolerance: 1e-3"


def test_search_and_fuse_fuses_the_same_landmarks(runs):
    a, b = _loop(runs, "reference")["stages"]["fuse"], _loop(runs, "port")["stages"]["fuse"]
    for key in ("lm_valid", "lm_replaced", "kf_lm_idx", "obs"):
        assert np.array_equal(a[key], b[key]), f"{key}: tolerance exact"


def test_the_essential_graph_is_4dof_and_holds_gravity_and_scale(runs):
    for impl in ("reference", "port"):
        (g,) = runs[4][impl]["rec"]["graph"]
        print(f"\n{impl}: essential graph {g['mode']}, {g['ms']:.1f} ms; across it a body gravity direction moved "
              f"{g['gravity_moved']:.2e} at most, a vertex scale {g['scale_moved']:.2e}")
        assert g["mode"] == "4dof"
        assert g["gravity_moved"] < TOL_GRAVITY and g["scale_moved"] < TOL_GRAVITY


def test_the_global_ba_requested_is_full_inertial_ba_7_over_stereo_rows(runs):
    out = runs[4]
    for impl in ("reference", "port"):
        rec = out[impl]["rec"]
        calls = [(r["iters"], r["loop_gba"], r["route"], r["kfs"], r["stereo_rows"], r["rows"]) for r in rec["fiba"]]
        print(f"\n{impl}: global BA after the loop {rec['gba']}; FullInertialBA calls {calls}")
        assert [(b["kind"], b["where"]) for b in rec["gba"]] == [("inertial", "inline")]
        assert [(r["prior_g"], r["prior_a"], r["iters"], r["loop_gba"]) for r in rec["fiba"]] == [(0.0, 0.0, 7, True)]
        assert rec["fiba"][0]["stereo_rows"] > 0
    a, b = out["reference"]["rec"]["fiba"][0], out["port"]["rec"]["fiba"][0]
    assert (a["route"], a["kfs"], a["rows"], a["stereo_rows"]) == (b["route"], b["kfs"], b["rows"], b["stereo_rows"])


def test_the_guard_stays_closed_before_viba2():
    """From the same state with the map's stage set back to 2 (before VIBA2),
    neither side attempts a loop or a merge; the keyframe is registered."""
    def prepare(trk):
        trk.map.imu_stage = 2
        calls = trk.calls = []
        real = trk.loop_closer._detect_and_correct
        trk.loop_closer._detect_and_correct = lambda *a, **kw: (calls.append(a[0]), real(*a, **kw))[1]

    S, _, _, _, out = run_both("loop", _step, prepare=prepare)
    for impl in ("reference", "port"):
        trk = out[impl]["trk"]
        lc = trk.loop_closer
        print(f"\n{impl}: detections attempted {trk.calls}, loops {lc.n_loops_closed}, merges {lc.n_merges}")
        assert trk.calls == [] and lc.n_loops_closed == 0 and lc.n_merges == 0
        assert out[impl]["loops"] == [] and out[impl]["rec"]["gba"] == []
        assert trk.kfdb.present.sum() == np.asarray(S["kfdb"]["present"]).sum() + 1, "the keyframe is registered"
