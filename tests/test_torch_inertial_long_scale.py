"""ScaleRefinement from the reference's own state (tests/inertial_long_rig.py,
state "scale"): the reference tracked chip_smoke.py's inertial long scene on
EuRoC's camera rig to its first `_scale_refinement` call (the 25 s window,
stage 3). That state is loaded into a reference tracker and a port tracker
and both run the same call: gravity direction and scale over the whole
chain with everything else fixed, then, if the scale moved by more than
0.2%, the map re-aligned (`apply_gravity_scale`, velocities scaled) and
every stored preintegration re-integrated with the newest biases. Gates:
the same branch (applied, rejected or no change needed), the scale within
tests/vi_same_state.py's TOL_SCALE["mono"] relative (a valley flat to f32
precision), and the map and the preintegrations after it within the VIBA2
tolerances (rotations, biases and rotation deltas 1e-4; positions,
velocities and the velocity and position deltas TOL_MAP["mono"]).
"""

import numpy as np
import pytest

from inertial_long_rig import frame_data, run_both
from vi_same_state import KF_FIELDS, TOL, TOL_MAP, TOL_SCALE


@pytest.fixture(scope="module")
def runs():
    def act(trk, mod, S):
        call = S["call"]
        trk._scale_refinement(frame_data(mod, call), call["k"])

    return run_both("scale", act)


def test_the_state_is_the_reference_run_before_its_first_scale_refinement(runs):
    S, meta, _, _, out = runs
    m, call = S["map"], S["call"]
    elapsed = call["timestamp"] - float(m["imu_t0"])
    first = meta["refinements"][0]
    print(f"\nstate: frame {call['at']}, keyframe {call['k']}, {int(m['kf_valid'].sum())} live keyframes, "
          f"{elapsed:.2f} s after the first inertial keyframe; the reference's run: ScaleRefinement calls "
          f"{[(r['frame'], round(r['t'], 2), r['s'], r['branch']) for r in meta['refinements']]}")
    assert int(m["imu_stage"]) == 3 and 25.0 <= elapsed < 25.5
    assert first["frame"] == call["at"]


def test_the_same_branch_and_scale(runs):
    meta, out = runs[1], runs[4]
    (a,), (b,) = out["reference"]["rec"]["refine"], out["port"]["rec"]["refine"]
    print(f"\nScaleRefinement: reference s {a['s']!r} ({a['branch']}), port s {b['s']!r} ({b['branch']}); the "
          f"reference's run: {meta['refinements'][0]['s']!r} ({meta['refinements'][0]['branch']})")
    assert a["branch"] == b["branch"] == meta["refinements"][0]["branch"]
    assert abs(b["s"] - a["s"]) <= TOL_SCALE["mono"] * a["s"], "tolerance: 2e-3 relative"


def test_the_map_and_its_preintegrations_agree_after_it(runs):
    out = runs[4]
    ref, got = out["reference"]["trk"], out["port"]["trk"]
    kv = ref.map.kf_valid
    assert np.array_equal(got.map.kf_valid, kv)
    pv = kv & ref.map.kf_pre_valid
    assert np.array_equal(got.map.kf_pre_valid & kv, pv)
    tols = {f: (TOL if f in ("kf_R", "kf_bg", "kf_ba") else TOL_MAP["mono"]) for f in KF_FIELDS}
    tols.update(kf_pre_dR=TOL, kf_pre_bias=TOL, kf_pre_dV=TOL_MAP["mono"], kf_pre_dP=TOL_MAP["mono"])
    for f, tol in tols.items():
        sel = pv if f.startswith("kf_pre") else kv
        err = float(np.abs(getattr(got.map, f)[sel] - getattr(ref.map, f)[sel]).max())
        print(f"\n{f}: max |port - reference| {err:.3e} (tolerance {tol})")
        assert err <= tol, f
    assert ref.map.big_change_idx - got.map.big_change_idx == 0
