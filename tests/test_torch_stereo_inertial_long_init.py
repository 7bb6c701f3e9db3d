"""The stereo-inertial IMU init from the reference's own state
(tests/stereo_inertial_long_rig.py, state "init"): the reference tracked
chip_smoke.py's stereo inertial long scene (EuRoC's baseline and camera rig)
to the `_imu_ladder` call that runs `_initialize_imu` with fix_scale=True
(10 keyframes, 1 s after the first inertial keyframe). That state is loaded
into a reference tracker and a port tracker and both run the same ladder
call: gravity, biases and velocities with the poses fixed and the scale
forced to 1 (LocalMapping::InitializeIMU's bFixedScale), the world rotated
to gravity, then FullInertialBA with the stereo priors (1e2, 1e5) over the
chain's stereo rows. Gates: stage 1 on both; the scale exactly 1 on both,
so no keyframe centre and no landmark changes its distance from the origin
across the re-alignment (tolerance 1e-5 m: float32 rotation); Rwg,
rotations and biases within tests/vi_same_state.py's 1e-4.

Positions and velocities: the reference itself, with one ulp on the init
keyframe's translation, moves its velocities by more than
TOL_MAP["stereo"] (2e-4) at this state (ROADMAP R27: the init's
Levenberg-Marquardt loop accepts or rejects its last steps on float32 cost
comparisons). So the port is held within TOL_MAP["stereo"] of the
reference's own one-ulp run, a solution the reference itself gives.
"""

import numpy as np
import pytest

from stereo_inertial_long_rig import frame_data, run_both
from vi_same_state import TOL, TOL_MAP

TOL_RESCALED = 1e-5


def _act(trk, mod, S):
    call = S["call"]
    trk._imu_ladder(frame_data(mod, call), call["k"])


@pytest.fixture(scope="module")
def runs():
    return run_both("init", _act)


@pytest.fixture(scope="module")
def ulp():
    """The reference from the same state with one ulp on the init
    keyframe's translation."""
    def prepare(trk):
        m = trk.map
        k = np.flatnonzero(m.kf_valid)[np.argmax(m.kf_frame_id[m.kf_valid])]  # the newest keyframe
        m.kf_t[k] = np.nextafter(m.kf_t[k], np.float32(np.inf))

    return run_both("init", _act, prepare=prepare, impls=("reference",))[4]["reference"]["trk"]


def test_the_state_is_the_reference_run_just_before_its_imu_init(runs):
    S, meta, _, _, out = runs
    m, call = S["map"], S["call"]
    elapsed = call["timestamp"] - float(m["imu_t0"])
    print(f"\nstate: frame {call['at']}, keyframe {call['k']}, {int(m['kf_valid'].sum())} live keyframes, "
          f"{int(m['lm_valid'].sum())} landmarks, {elapsed:.2f} s after the first inertial keyframe; the reference's "
          f"run reached the stages at frames {meta['stage_frames']}")
    assert int(m["imu_stage"]) == 0 and elapsed >= 1.0 and int(m["kf_valid"].sum()) >= 10
    assert meta["stage_frames"][1] == call["at"], "the reference's IMU init ran at this call"


def test_the_init_takes_at_scale_one_on_both(runs):
    out = runs[4]
    for impl in ("reference", "port"):
        (init,) = out[impl]["rec"]["init"]
        fiba = out[impl]["rec"]["fiba"]
        calls = [(r["prior_g"], r["prior_a"], r["iters"], r["route"], r["stereo_rows"], r["rows"]) for r in fiba]
        print(f"\n{impl}: IMU init fix_scale {init['fix_scale']}, took {init['ok']}, scale {init['s']!r}, largest "
              f"change of a distance from the origin {init['rescaled']:.2e} m; FullInertialBA {calls}")
        assert out[impl]["trk"].map.imu_stage == 1
        assert init["fix_scale"] and init["ok"] and init["s"] == 1.0
        assert init["rescaled"] < TOL_RESCALED
        assert [(r["prior_g"], r["prior_a"], r["iters"]) for r in fiba] == [(1e2, 1e5, 15)]
        assert fiba[0]["stereo_rows"] > 0
    assert out["reference"]["rec"]["fiba"][0]["stereo_rows"] == out["port"]["rec"]["fiba"][0]["stereo_rows"]


def test_gravity_rotations_and_biases_agree_after_it(runs):
    out = runs[4]
    (a,), (b,) = out["reference"]["rec"]["init"], out["port"]["rec"]["init"]
    err = float(np.abs(np.asarray(b["Ryw"]) - np.asarray(a["Ryw"])).max())
    print(f"\nRwg: max |port - reference| {err:.3e} (tolerance {TOL})")
    assert err <= TOL
    ref, got = out["reference"]["trk"], out["port"]["trk"]
    kv = ref.map.kf_valid
    assert np.array_equal(got.map.kf_valid, kv)
    for f in ("kf_R", "kf_bg", "kf_ba"):
        err = float(np.abs(getattr(got.map, f)[kv] - getattr(ref.map, f)[kv]).max())
        print(f"\n{f}: max |port - reference| {err:.3e} over {int(kv.sum())} keyframes (tolerance {TOL})")
        assert err <= TOL, f
    for f in ("cur_bg", "cur_ba"):
        assert np.abs(getattr(got, f) - getattr(ref, f)).max() <= TOL, f


def _pv_apart(a, b, kv):
    return {**{f: float(np.abs(getattr(a.map, f)[kv] - getattr(b.map, f)[kv]).max()) for f in ("kf_t", "kf_vel")},
            "cur_v": float(np.abs(a.cur_v - b.cur_v).max())}


def test_positions_and_velocities_part_as_the_reference_parts_from_itself_r27(runs, ulp):
    """ROADMAP R27's witness, and the port's gate beside it."""
    out = runs[4]
    ref, got = out["reference"]["trk"], out["port"]["trk"]
    kv = ref.map.kf_valid
    assert np.array_equal(ulp.map.kf_valid, kv)
    port, self_, to_ulp = _pv_apart(got, ref, kv), _pv_apart(ulp, ref, kv), _pv_apart(got, ulp, kv)
    print(f"\npositions and velocities, max apart: port from the reference {port}; the reference with one ulp "
          f"from the reference {self_}; the port from the reference with one ulp {to_ulp} (tolerance "
          f"{TOL_MAP['stereo']})")
    assert max(self_.values()) > TOL_MAP["stereo"], "the reference moves under one ulp"
    for f in port:
        assert to_ulp[f] <= TOL_MAP["stereo"], f
