"""The inertial path past its init, from the reference's own states:
chip_smoke.py's inertial long scene (tests/test_vi_tracking_e2e.py's bobbing
circle over two laps at 10 fps, exact 200 Hz IMU, the camera on EuRoC's rig
IMU.T_b_c1, the reference's default ladder, loop closing and the global BA
on, synchronous) tracked by the reference's IMU_MONOCULAR Tracker on the
CPU, which stops just before three stages and stores its state each time:

(a) "viba2": the `_imu_ladder` call that runs VIBA2 (stage 2, 15 s past the
    first inertial keyframe);
(b) "scale": the first `_scale_refinement` call (the 25 s window);
(c) "loop": the first loop step that closes a loop on the inertial map
    (stage 3), with the loop closer's hypothesis pending.

Each state holds the live tracking state with its inertial part, the map,
the keyframe database and the loop state, and the arguments of the call.
The reference reaches all three, so the port is never used to make them.
The states are stored in tests/data/inertial_long_states.npz; rewrite it
with

    python tests/inertial_long_rig.py [PATH]

(one torch thread, the reference's JAX on the CPU; ~12 min on an idle
machine).

Cut to size for the CPU: 640x480 with 400 features (the phase runs 752x480
with 1,000 on the card) and a map of 128 keyframes and 4,096 landmarks
(MAP_CFG); the scene, its clock, the ladder and the solver capacities are
the card's, so every stage keeps its time. (With
tests/vi_same_state.py's caps of 1,024 landmarks, VIBA2's whole-chain
problem loses the newest keyframes' landmarks and the next frame is lost.)
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the inertial long phase's scene and config)
from long_loop_rig import load_states, save_states, snapshot  # noqa: E402
from orbslam3_cpp_fork_tpu_torch import convert  # noqa: E402
from orbslam3_cpp_fork_tpu_torch.runtime import tracker as tt  # noqa: E402

STATES = Path(__file__).parent / "data" / "inertial_long_states.npz"
SIZE = (640, 480)
N_FEAT = 400
STAGES = ("viba2", "scale", "loop")
# The map's capacities cut for the CPU (the run holds at most 92 keyframes
# and ~2,800 landmarks): the whole-map solves pad their landmarks to it.
MAP_CFG = dict(max_keyframes=128, max_landmarks=4096)


def scene_and_frames(render=True):
    """The scene at the CPU size: scene, stamps, camera poses, uint8 frames
    (None unless `render`) and IMU rows."""
    return chip_smoke.render_inertial_long(*SIZE, render=render)


def port_tracker(scene, n_features=N_FEAT, map_cfg=MAP_CFG):
    from orbslam3_cpp_fork_tpu_torch.models.map_state import MapConfig

    kw = {} if map_cfg is None else dict(map_cfg=MapConfig(**map_cfg))
    return tt.Tracker(chip_smoke.inertial_long_config(scene, n_features, **kw), "cpu")


def ref_tracker(scene, n_features=N_FEAT, map_cfg=MAP_CFG):
    from orbslam3_cpp_fork_tpu.models.map_state import MapConfig
    from orbslam3_cpp_fork_tpu.ops.camera import Camera
    from orbslam3_cpp_fork_tpu.ops.orb import OrbParams
    from orbslam3_cpp_fork_tpu.runtime import tracker as jt

    K = scene.K
    return jt.Tracker(jt.TrackerConfig(
        camera=Camera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2]), width=scene.width, height=scene.height,
        sensor=jt.Sensor.IMU_MONOCULAR, orb=OrbParams(n_features=n_features),
        imu=jt.ImuSettings(freq=chip_smoke.VI_IMU_HZ, Tbc=np.asarray(chip_smoke.EUROC_T_B_C1, np.float32)),
        mapping_backend="cpu", async_mapping=False, enable_loop_closing=True,
        **({} if map_cfg is None else dict(map_cfg=MapConfig(**map_cfg))),
    ))


def loaded(impl, scene, S):
    """A reference or a port tracker in the state of `snapshot`, the
    inertial part included."""
    if impl == "reference":
        from test_torch_loop_drift import load_ref_place_recognition
        from vi_rig import load_ref_state

        trk = ref_tracker(scene)
        load_ref_state(trk, S["state"], S["map"])
        load_ref_place_recognition(trk, S["kfdb"], S["loop"])
    else:
        trk = port_tracker(scene)
        convert.load_tracker_state(trk, S["state"], S["map"])
        convert.load_place_recognition(trk, S["kfdb"], S["loop"])
    return trk


def modules(impl):
    """(tracker module, optim.inertial module, the module the loop closer
    solves its essential graph with, that solver's name) of an
    implementation."""
    if impl == "reference":
        from orbslam3_cpp_fork_tpu.optim import inertial, pose_graph
        from orbslam3_cpp_fork_tpu.runtime import tracker

        return tracker, inertial, pose_graph, "optimize_pose_graph_padded"
    from orbslam3_cpp_fork_tpu_torch.optim import inertial, pose_graph

    return tt, inertial, pose_graph, "optimize_pose_graph"


def run_both(stage, act, prepare=None, keep=False):
    """Load the stored state `stage` into a reference and a port tracker
    (one torch thread), wrap their inertial path
    (`chip_smoke.record_inertial_path`) and loop stages
    (`chip_smoke.record_loop_stages`, with copies if `keep`), call
    `prepare(trk)` and then `act(trk, tracker module, S)` on each. Returns
    (S, meta, camera poses Rs, ts, {impl: dict(trk, rec, loops, out)})."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        states, meta = load_states(STATES)
        S = states[stage]
        scene, _, Rs, ts, _, _ = scene_and_frames(render=False)
        out = {}
        for impl in ("reference", "port"):
            mod, vi, pg, solver = modules(impl)
            trk = loaded(impl, scene, S)
            rec = chip_smoke.record_inertial_path(trk, vi, pg, solver)
            loops = chip_smoke.record_loop_stages(trk, ts, keep=keep)
            if prepare is not None:
                prepare(trk)
            out[impl] = dict(trk=trk, rec=rec, loops=loops, out=act(trk, mod, S))
    finally:
        torch.set_num_threads(n)
    return S, meta, Rs, ts, out


def frame_data(mod, call):
    """The FrameData a stage call was given (its id and stamp; the stage
    writes its pose)."""
    return mod.FrameData(frame_id=int(call["frame_id"]), timestamp=float(call["timestamp"]))


def capture():
    """Drive the reference over the scene from a cold start (one torch
    thread) and take the three states. Returns ({stage: snapshot with its
    call}, meta: every frame's IMU stage, the frames of the stages, the
    ScaleRefinement calls with their scale and branch, the loops with their
    keyframes and frames, frames tracked, the seconds)."""
    from orbslam3_cpp_fork_tpu.optim import inertial as jvi

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        scene, stamps, Rs, ts, frames, rows = scene_and_frames()
        ref = ref_tracker(scene)
        cfg, now = ref.cfg, {"i": 0}
        states, refines = {}, []
        real_ladder, real_refine, real_loop = ref._imu_ladder, ref._scale_refinement, ref._loop_step

        def call_of(frame, k):
            return dict(frame_id=int(frame.frame_id), timestamp=float(frame.timestamp), k=int(k), at=now["i"])

        def ladder(frame, k):
            m = ref.map
            if ("viba2" not in states and m.imu_stage == 2 and m.imu_t0 >= 0
                    and frame.timestamp - m.imu_t0 >= cfg.viba2_time):
                states["viba2"] = dict(snapshot(ref), call=call_of(frame, k))
            return real_ladder(frame, k)

        refines_s = []
        real_init = jvi.inertial_init

        def init_spy(*a, **kw):
            res = real_init(*a, **kw)
            refines_s.append(float(res.scale))
            return res

        def refine(frame, k):
            if "scale" not in states:
                states["scale"] = dict(snapshot(ref), call=call_of(frame, k))
            big0, refines_s[:] = ref.map.big_change_idx, []
            jvi.inertial_init = init_spy
            try:
                out = real_refine(frame, k)
            finally:
                jvi.inertial_init = real_init
            s = refines_s[0] if refines_s else None
            refines.append(dict(frame=now["i"], t=float(frame.timestamp - ref.map.imu_t0), s=s,
                                branch=chip_smoke.scale_branch(s, ref.map.big_change_idx != big0)))
            return out

        pending = {}

        def loop_step(k, map_ref, frame=None):
            if "loop" not in states:
                pending["S"] = dict(snapshot(ref), call=dict(k=int(k), at=now["i"], imu_stage=int(ref.map.imu_stage)))
            n0 = ref.loop_closer.n_loops_closed
            out = real_loop(k, map_ref, frame=frame)
            if "loop" not in states and ref.loop_closer.n_loops_closed > n0 and ref.map.imu_stage >= 3:
                states["loop"] = pending["S"]
            return out

        ref._imu_ladder, ref._scale_refinement, ref._loop_step = ladder, refine, loop_step
        stage_of, tracked, t0 = [], 0, time.perf_counter()
        for i in range(len(frames)):
            now["i"] = i
            t1 = time.perf_counter()
            tracked += ref.track(frames[i], float(stamps[i]), imu=rows[i]) is not None
            stage_of.append(int(ref.map.imu_stage))
            print(f"frame {i}: stage {stage_of[-1]}, state {ref.state.name}, keyframes {ref.map.n_keyframes()}, "
                f"landmarks {ref.map.n_landmarks()}, loops {ref.loop_closer.n_loops_closed}, "
                f"{time.perf_counter() - t1:.2f} s")
        loops = [dict(kf=int(e["kf"]), match=int(e["match"]), kf_frame=int(e["kf_frame"]),
                      match_frame=int(e["match_frame"]), scale=float(e["scale"]))
                 for e in ref.loop_closer.events if e["kind"] == "loop"]
        meta = dict(stage_of=stage_of, stage_frames={s: stage_of.index(s) for s in sorted(set(stage_of))},
                    refinements=refines, loops=loops, tracked=tracked, seconds=time.perf_counter() - t0,
                    missing=[s for s in STAGES if s not in states])
        return states, meta
    finally:
        torch.set_num_threads(n)


if __name__ == "__main__":
    import os

    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    jax.config.update("jax_platforms", "cpu")  # over a platform pinned by the environment
    path = Path(sys.argv[1]) if len(sys.argv) > 1 else STATES
    states, meta = capture()
    print(json.dumps(meta))
    save_states(states, path, **meta)
    print(f"{sorted(states)} written to {path} ({path.stat().st_size} bytes)")
    load_states(path)
