"""ROADMAP R28: a frame tracked by the split-phase stages binds landmarks
that another thread fused meanwhile. Stereo pairs always take those stages
(`_track_frame_slow`), which read the map without its lock; in the default
mode the loop thread's SearchAndFuse can replace a landmark the frame has
just bound. ORB-SLAM3 holds mMutexMapUpdate over a frame's tracking, so a
frame never finishes on a replaced landmark there.

From the reference's own state before its first loop step
(tests/stereo_inertial_long_rig.py, state "loop", frame 187), both trackers
track the next pair while a stand-in for the loop thread fuses the first
bound landmark of the frame into another one after every pose
optimization. At `_finish_tracked_frame` (where chip_smoke.py's loop B
checks every binding) the port's bindings are all live, each fused one
forwarded to its survivor; the reference keeps the replaced ids (the
witness). The frame stops there on both sides.
"""

import numpy as np
import pytest
import torch

import chip_smoke
from stereo_inertial_long_rig import SIZE, loaded, scene_and_frames


class _Stop(Exception):
    pass


@pytest.fixture(scope="module")
def finished():
    from long_loop_rig import load_states
    from orbslam3_cpp_fork_tpu_torch.datasets import synthetic
    from stereo_inertial_long_rig import STATES

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        S = load_states(STATES)[0]["loop"]
        scene, stamps, Rs, ts, _, rows = scene_and_frames(render=False)
        i = S["call"]["at"] + 1
        pair = [synthetic.to_u8(synthetic.render_frame(scene, *pose)) for pose in
                ((Rs[i], ts[i]), synthetic.stereo_right_pose(Rs[i], ts[i], chip_smoke.SIL_BASELINE))]
        assert pair[0].shape == (SIZE[1], SIZE[0])
        out = {}
        for impl in ("reference", "port"):
            trk = loaded(impl, scene, S)
            m, fused = trk.map, []
            real_opt = trk._pose_opt_dispatch

            def opt(frame, _real=real_opt, _m=m, _fused=fused):
                n_in = _real(frame)
                bound = frame.lm_idx[frame.lm_idx >= 0]
                others = np.setdiff1d(np.flatnonzero(_m.lm_valid), bound)
                if len(bound) and len(others):
                    _m.replace_landmark(int(bound[0]), int(others[0]))
                    _fused.append((int(bound[0]), int(others[0])))
                return n_in

            def finish(frame, n_in, _m=m, _impl=impl, _fused=fused):
                ids = frame.lm_idx[frame.lm_idx >= 0]
                out[_impl] = dict(ids=ids.copy(), live=_m.lm_valid[ids].copy(), fused=list(_fused))
                raise _Stop

            trk._pose_opt_dispatch, trk._finish_tracked_frame = opt, finish
            with pytest.raises(_Stop):
                trk.track_stereo(pair[0], pair[1], float(stamps[i]), imu=rows[i])
    finally:
        torch.set_num_threads(n)
    return out


def test_the_port_finishes_the_frame_on_live_landmarks_r28(finished):
    r = finished["port"]
    print(f"\nport: {len(r['ids'])} bindings at the frame's end, {int((~r['live']).sum())} dead; fused meanwhile "
          f"{r['fused']}")
    assert r["fused"], "a bound landmark was fused during the frame"
    assert r["live"].all()
    survivors = {new for _, new in r["fused"]}
    assert survivors & set(r["ids"].tolist()), "a fused binding is forwarded to its survivor"


def test_the_reference_finishes_the_frame_on_fused_landmarks_r28(finished):
    r = finished["reference"]
    print(f"\nreference: {len(r['ids'])} bindings at the frame's end, {int((~r['live']).sum())} dead; fused meanwhile "
          f"{r['fused']}")
    assert r["fused"] and not r["live"].all(), "the reference keeps replaced ids (R28)"
