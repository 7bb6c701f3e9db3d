"""The five frames after an inertial weld, from the reference's own state
(tests/inertial_merge_rig.py, state "after"): the reference tracked
chip_smoke.py's inertial merge scene (ROADMAP R13 repaired, as the port
does) to the end of the frame whose loop step welded map 1 into map 0
through `_merge_inertial_ba` (tests/test_torch_inertial_merge.py holds the
weld itself). That state, one map at stage 3 whose preintegration chain
stops at the welded map's first keyframe, is loaded into a port tracker,
which tracks the next five frames on the reference's features and the same
IMU rows (the VI pose optimization against the last keyframe, then against
the last frame with its marginal prior; a keyframe and its mapping step
with the local VI BA and the loop step on the fifth). The reference's
outputs on the same inputs from the same state were stored by the rig
(`inertial_merge_rig.next_frames`; the slow
tests/test_torch_inertial_merge_e2e.py -k next_frames recomputes them), so
this file runs none of the reference's compiles. Gates: tests/vi_same_state.py's:
poses, cur_v, cur_bg and cur_ba within 1e-4, every frame OK, the same
keyframe insertions.
"""

import numpy as np
import pytest
import torch

from inertial_merge_rig import STATES, load_states, next_frames, scene_and_frames

TOL = 1e-4
VI_FIELDS = ("cur_v", "cur_bg", "cur_ba")


@pytest.fixture(scope="module")
def tracked():
    states, _ = load_states(STATES)
    S = states["after"]
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return S, next_frames("port", scene_and_frames(render=False)[0], S)
    finally:
        torch.set_num_threads(n)


def test_the_state_is_the_end_of_the_weld_frame(tracked):
    S, _ = tracked
    a = S["atlas"]
    m = a["maps"][a["active_idx"]]
    print(f"\nstate: after frame {S['call']['at']}, map {int(m['map_id'])} with {int(m['kf_valid'].sum())} keyframes "
          f"at stage {int(m['imu_stage'])}; {len(S['next'])} frames follow")
    assert len(a["maps"]) == 1 and int(m["map_id"]) == 0 and int(m["imu_stage"]) == 3
    assert S["state"]["state"] == "OK" and len(S["next"]) == len(S["reference_next"]) == 5


def test_next_frames_agree(tracked):
    S, got = tracked
    for j, (r, g) in enumerate(zip(S["reference_next"], got)):
        print(f"\nframe +{j + 1}: {r['state']} / {g['state']}, keyframes inserted {r['kfs']} / {g['kfs']}, pose apart "
              f"{np.abs(g['T'] - r['T']).max():.2e}, "
              + ", ".join(f"{k} {np.abs(g[k] - r[k]).max():.2e}" for k in VI_FIELDS))
        assert r["state"] == g["state"] == "OK" and r["T"] is not None and g["T"] is not None
        assert r["kfs"] == g["kfs"]
        assert np.abs(g["T"] - r["T"]).max() <= TOL
        for k in VI_FIELDS:
            assert np.abs(g[k] - r[k]).max() <= TOL, k
