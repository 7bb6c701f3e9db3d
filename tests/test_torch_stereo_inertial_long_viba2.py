"""Stereo-inertial VIBA2 from the reference's own state
(tests/stereo_inertial_long_rig.py, state "viba2"): the reference tracked
chip_smoke.py's stereo inertial long scene (EuRoC's baseline and camera rig)
to the `_imu_ladder` call that runs VIBA2 (stage 2, 15 s after the first
inertial keyframe). That state is loaded into a reference tracker and a
port tracker and both run the same ladder call: FullInertialBA over the
whole chain with no bias priors and the chain's stereo rows, then stage 3
and the live state re-anchored on the keyframe. Gates: the same number of
stereo rows in the built problem on both; poses, velocities and biases
within tests/test_torch_vi_ba.py's 1e-4, landmarks within its 1e-3.

ScaleRefinement is for IMU_MONOCULAR only (LocalMapping::Run): from the
same trackers after VIBA2, the ladder called with the clock in the 25 s and
the 35 s windows calls `_scale_refinement` on neither side and leaves the
map as it was.
"""

import numpy as np
import pytest

from inertial_long_rig import modules
from stereo_inertial_long_rig import frame_data, run_both

TOL_STATE = 1e-4
TOL_LM = 1e-3
MAP_FIELDS = ("kf_R", "kf_t", "kf_vel", "kf_bg", "kf_ba", "lm_pos", "kf_valid", "lm_valid")


@pytest.fixture(scope="module")
def runs():
    def act(trk, mod, S):
        call = S["call"]
        trk._imu_ladder(frame_data(mod, call), call["k"])

    return run_both("viba2", act)


def test_the_state_is_the_reference_run_just_before_viba2(runs):
    S, meta, _, _, out = runs
    m, call = S["map"], S["call"]
    elapsed = call["timestamp"] - float(m["imu_t0"])
    viba2 = [r for r in meta["fiba"] if r["prior_g"] == 0.0 and not r["loop_gba"]]
    print(f"\nstate: frame {call['at']}, keyframe {call['k']}, {int(m['kf_valid'].sum())} live keyframes, "
          f"{int(m['lm_valid'].sum())} landmarks, {elapsed:.2f} s after the first inertial keyframe; the reference's "
          f"run reached the stages at frames {meta['stage_frames']}; its VIBA2: {viba2[0]}")
    assert int(m["imu_stage"]) == 2 and elapsed >= 15.0
    assert meta["stage_frames"][3] == call["at"], "the reference's VIBA2 ran at this call"


def test_viba2_runs_on_both_over_the_same_stereo_rows(runs):
    out = runs[4]
    for impl in ("reference", "port"):
        fiba = out[impl]["rec"]["fiba"]
        calls = [(r["prior_g"], r["prior_a"], r["iters"], r["route"], r["kfs"], r["stereo_rows"], r["rows"])
                 for r in fiba]
        print(f"\n{impl}: FullInertialBA calls {calls}")
        assert out[impl]["trk"].map.imu_stage == 3
        assert [(r["prior_g"], r["prior_a"], r["iters"]) for r in fiba] == [(0.0, 0.0, 15)]
        assert fiba[0]["stereo_rows"] > 0
    a, b = out["reference"]["rec"]["fiba"][0], out["port"]["rec"]["fiba"][0]
    assert (a["route"], a["kfs"], a["rows"], a["stereo_rows"]) == (b["route"], b["kfs"], b["rows"], b["stereo_rows"])


def test_viba2_agrees(runs):
    out = runs[4]
    ref, got = out["reference"]["trk"], out["port"]["trk"]
    kv, lv = ref.map.kf_valid, ref.map.lm_valid
    assert np.array_equal(got.map.kf_valid, kv) and np.array_equal(got.map.lm_valid, lv)
    for f in ("kf_R", "kf_t", "kf_vel", "kf_bg", "kf_ba"):
        err = float(np.abs(getattr(got.map, f)[kv] - getattr(ref.map, f)[kv]).max())
        print(f"\n{f}: max |port - reference| {err:.3e} over {int(kv.sum())} keyframes (tolerance {TOL_STATE})")
        assert err <= TOL_STATE, f
    err = float(np.abs(got.map.lm_pos[lv] - ref.map.lm_pos[lv]).max())
    print(f"\nlm_pos: max |port - reference| {err:.3e} over {int(lv.sum())} landmarks (tolerance {TOL_LM})")
    assert err <= TOL_LM
    for f in ("cur_v", "cur_bg", "cur_ba"):
        assert np.abs(getattr(got, f) - getattr(ref, f)).max() <= TOL_STATE, f


@pytest.mark.parametrize("window", [25.0, 35.0])
def test_scale_refinement_stays_off(runs, window):
    S, out = runs[0], runs[4]
    call = S["call"]
    for impl in ("reference", "port"):
        trk, rec = out[impl]["trk"], out[impl]["rec"]
        mod = modules(impl)[0]
        m = trk.map
        before = {f: getattr(m, f).copy() for f in MAP_FIELDS}
        frame = frame_data(mod, dict(call, timestamp=float(m.imu_t0) + window + 0.2))
        trk._imu_ladder(frame, call["k"])
        print(f"\n{impl}: the ladder at {window + 0.2:.1f} s after the first inertial keyframe: stage {m.imu_stage}, "
              f"ScaleRefinement calls {len(rec['refine'])}")
        assert m.imu_stage == 3 and rec["refine"] == []
        for f in MAP_FIELDS:
            assert np.array_equal(getattr(m, f), before[f]), f
