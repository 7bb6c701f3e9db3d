"""FullInertialBA(7) after the first stereo-inertial loop, from the
reference's own state (tests/stereo_inertial_long_rig.py, state "gba"): the
reference's loop step at frame 187 of chip_smoke.py's stereo inertial long
scene, after its essential graph, at the global BA request (the loop
closer's `global_ba_hook`). That state is loaded into a reference tracker
and a port tracker and both run the request: FullInertialBA(7) inline
over the whole chain's stereo rows, on the sparse route. Gates: the same
route, keyframes, rows and stereo rows on both.

The solve turns one ulp of its input into more than the VI BA tolerance
for body states (1e-4): the reference with one ulp on the loop keyframe's
translation moves its translations by ~2.7e-4 and its landmarks by ~9e-4
(ROADMAP R27, the inertial side of R21: seven iterations from a state the
graph just moved). So, as for R21, the port is
at fault only if it parts from the reference by more than the reference
parts from itself: field by field, the port's distance from the reference
is held to the one-ulp run's.
"""

import numpy as np
import pytest

from stereo_inertial_long_rig import run_both

TOL_POSE = 1e-4
TOL_LM = 1e-3
FIELDS = ("kf_R", "kf_t", "kf_vel", "kf_bg", "kf_ba")


def _request(trk, mod, S):
    trk.loop_closer.global_ba_hook(S["call"]["k"], S["call"]["c"])


@pytest.fixture(scope="module")
def runs():
    return run_both("gba", _request, loop_stages=False)


@pytest.fixture(scope="module")
def ulp():
    """The reference from the same state with one ulp on the loop keyframe's
    translation."""
    def prepare(trk):
        from long_loop_rig import load_states
        from stereo_inertial_long_rig import STATES

        k = load_states(STATES)[0]["gba"]["call"]["k"]
        trk.map.kf_t[k] = np.nextafter(trk.map.kf_t[k], np.float32(np.inf))

    return run_both("gba", _request, prepare=prepare, impls=("reference",), loop_stages=False)[4]["reference"]["trk"]


def _apart(a, b):
    kv, lv = b.kf_valid, b.lm_valid
    assert np.array_equal(a.kf_valid, kv) and np.array_equal(a.lm_valid, lv)
    out = {f: float(np.abs(getattr(a, f)[kv] - getattr(b, f)[kv]).max()) for f in FIELDS}
    out["lm_pos"] = float(np.abs(a.lm_pos[lv] - b.lm_pos[lv]).max())
    return out


def test_the_state_is_the_reference_loop_step_at_its_global_ba(runs):
    S, meta = runs[0], runs[1]
    m, call = S["map"], S["call"]
    first = meta["loops"][0]
    print(f"\nstate: frame {call['at']}, loop keyframe {call['k']} -> {call['c']}, stage {int(m['imu_stage'])}, "
          f"{int(m['kf_valid'].sum())} live keyframes, {int(m['lm_valid'].sum())} landmarks, loops closed "
          f"{S['loop']['n_loops_closed']}")
    assert int(m["imu_stage"]) == 3 and S["loop"]["n_loops_closed"] == 1
    assert (call["k"], call["c"]) == (first["kf"], first["match"])


def test_full_inertial_ba_7_runs_inline_over_the_same_stereo_rows(runs):
    out = runs[4]
    for impl in ("reference", "port"):
        rec = out[impl]["rec"]
        calls = [(r["iters"], r["loop_gba"], r["route"], r["kfs"], r["stereo_rows"], r["rows"], round(r["ms"]))
                 for r in rec["fiba"]]
        print(f"\n{impl}: global BA {rec['gba']}; FullInertialBA calls {calls}")
        assert [(b["kind"], b["where"]) for b in rec["gba"]] == [("inertial", "inline")]
        assert [(r["prior_g"], r["prior_a"], r["iters"], r["loop_gba"]) for r in rec["fiba"]] == [(0.0, 0.0, 7, True)]
        assert rec["fiba"][0]["stereo_rows"] > 0
    a, b = out["reference"]["rec"]["fiba"][0], out["port"]["rec"]["fiba"][0]
    assert (a["route"], a["kfs"], a["rows"], a["stereo_rows"]) == (b["route"], b["kfs"], b["rows"], b["stereo_rows"])


def test_the_port_parts_from_the_reference_less_than_the_reference_from_itself_r27(runs, ulp):
    """ROADMAP R27's witness at the global BA after the loop, and the port's
    gate beside it."""
    out = runs[4]
    ref, got = out["reference"]["trk"].map, out["port"]["trk"].map
    port, self_ = _apart(got, ref), _apart(ulp.map, ref)
    print(f"\nafter FullInertialBA(7), max apart from the reference: port {port}; the reference with one ulp on the "
          f"loop keyframe's translation {self_} (VI BA tolerances: {TOL_POSE}, landmarks {TOL_LM})")
    assert self_["kf_t"] > TOL_POSE, "the reference moves under one ulp"
    for f in port:
        assert port[f] <= self_[f], f
