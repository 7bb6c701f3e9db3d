"""Stereo-inertial past its init, from the reference's own states:
chip_smoke.py's stereo inertial long scene (the inertial long scene's
bobbing circle over two laps at 10 fps with exact 200 Hz IMU, as rectified
pairs of EuRoC's 0.110078 m baseline on a room-sized ring, the camera on
EuRoC's rig IMU.T_b_c1, th_depth 35 baselines, the reference's default
ladder, loop closing and the global BA on, synchronous) tracked by the
reference's IMU_STEREO Tracker on the CPU, which stops just before four
stages and stores its state each time:

(a) "init": the `_imu_ladder` call that runs `_initialize_imu` with
    fix_scale=True (stage 0, 10 keyframes and 1 s after the first inertial
    keyframe) and takes;
(b) "viba2": the `_imu_ladder` call that runs VIBA2 (stage 2, 15 s past the
    first inertial keyframe);
(c) "loop": the first loop step that closes a loop on the stereo-inertial
    map (stage 3), with the loop closer's hypothesis pending;
(d) "gba": in that loop step, the global BA request after the essential
    graph (the loop closer's `global_ba_hook`, FullInertialBA(7)).

Each state holds the live tracking state with its inertial part and the
live frame's stereo fields (`ur`, `depth`), the map (its keyframes' `kf_ur`
and `kf_depth` too), the keyframe database and the loop state, and the
arguments of the call. The reference reaches all four, so the port is
never used to make them. The states are stored in
tests/data/stereo_inertial_long_states.npz; rewrite it with

    python tests/stereo_inertial_long_rig.py [PATH]

(one torch thread, the reference's JAX on the CPU; ~10 min on an idle
machine).

Cut to size for the CPU: 640x480 with 600 features (the phase runs 752x480
with 1,200 on the card; stereo initialization needs 500 features in the
left image, so the CPU size keeps a margin over it) and a map of 128
keyframes and 4,096 landmarks (MAP_CFG, inertial_long_rig's); the scene,
its clock, the ladder, the baseline, th_depth and the solver caps are the
card's. Whether each whole-chain solve took the dense route (up to
vi_full_kf_cap = 48 keyframes) or the sparse one is in the file's meta
("fiba").
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the stereo inertial long phase's scene and config)
from inertial_long_rig import MAP_CFG, modules  # noqa: E402
from long_loop_rig import load_states, save_states, snapshot  # noqa: E402
from orbslam3_cpp_fork_tpu_torch import convert  # noqa: E402
from orbslam3_cpp_fork_tpu_torch.runtime import tracker as tt  # noqa: E402

STATES = Path(__file__).parent / "data" / "stereo_inertial_long_states.npz"
SIZE = (640, 480)
N_FEAT = 600
STAGES = ("init", "viba2", "loop", "gba")


def scene_and_frames(render=True):
    """The scene at the CPU size: scene, stamps, camera poses, uint8
    (left, right) pairs (None unless `render`) and IMU rows."""
    return chip_smoke.render_stereo_inertial_long(*SIZE, render=render)


def port_tracker(scene, n_features=N_FEAT, map_cfg=MAP_CFG):
    from orbslam3_cpp_fork_tpu_torch.models.map_state import MapConfig

    kw = {} if map_cfg is None else dict(map_cfg=MapConfig(**map_cfg))
    return tt.Tracker(chip_smoke.stereo_inertial_long_config(scene, n_features, **kw), "cpu")


def ref_tracker(scene, n_features=N_FEAT, map_cfg=MAP_CFG):
    from orbslam3_cpp_fork_tpu.models.map_state import MapConfig
    from orbslam3_cpp_fork_tpu.ops.camera import Camera
    from orbslam3_cpp_fork_tpu.ops.orb import OrbParams
    from orbslam3_cpp_fork_tpu.runtime import tracker as jt

    K = scene.K
    return jt.Tracker(jt.TrackerConfig(
        camera=Camera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2]), width=scene.width, height=scene.height,
        sensor=jt.Sensor.IMU_STEREO, orb=OrbParams(n_features=n_features),
        imu=jt.ImuSettings(freq=chip_smoke.VI_IMU_HZ, Tbc=np.asarray(chip_smoke.EUROC_T_B_C1, np.float32)),
        bf=chip_smoke.SIL_BASELINE * float(K[0, 0]), th_depth=chip_smoke.SIL_BASELINE * chip_smoke.SIL_TH_DEPTH,
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


def run_both(stage, act, prepare=None, keep=False, impls=("reference", "port"), loop_stages=True):
    """Load the stored state `stage` into a reference and a port tracker
    (one torch thread), wrap their inertial path
    (`chip_smoke.record_inertial_path`) and, if `loop_stages`, the stages of
    a loop step (`chip_smoke.record_loop_stages`, with copies if `keep`),
    call `prepare(trk)` and then `act(trk, tracker module, S)` on each.
    Returns (S, meta, camera poses Rs, ts, {impl: dict(trk, rec, loops,
    out)})."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        states, meta = load_states(STATES)
        S = states[stage]
        scene, _, Rs, ts, _, _ = scene_and_frames(render=False)
        out = {}
        for impl in impls:
            mod, vi, pg, solver = modules(impl)
            trk = loaded(impl, scene, S)
            rec = chip_smoke.record_inertial_path(trk, vi, pg, solver)
            loops = chip_smoke.record_loop_stages(trk, ts, keep=keep) if loop_stages else None
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
    thread) and take the four states. Returns ({stage: snapshot with its
    call}, meta: every frame's IMU stage, the frames of the stages, the IMU
    inits, the FullInertialBA calls with their route, keyframes and stereo
    rows, the ScaleRefinement calls (none for a stereo sensor), the loops
    with their keyframes and frames, keyframes and landmarks at the end,
    frames tracked, the seconds)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        scene, stamps, Rs, ts, frames, rows = scene_and_frames()
        ref = ref_tracker(scene)
        _, vi, pg, solver = modules("reference")
        rec = chip_smoke.record_inertial_path(ref, vi, pg, solver)
        cfg, now = ref.cfg, {"i": 0}
        states, pending = {}, {}
        real_ladder, real_loop = ref._imu_ladder, ref._loop_step

        def call_of(frame, k):
            return dict(frame_id=int(frame.frame_id), timestamp=float(frame.timestamp), k=int(k), at=now["i"])

        def ladder(frame, k):
            m = ref.map
            elapsed = frame.timestamp - m.imu_t0
            init_due = (m.imu_stage == 0 and m.imu_t0 >= 0 and elapsed >= cfg.imu_init_time
                        and len(m.temporal_window(k, cfg.imu_init_min_kfs + 1)) >= cfg.imu_init_min_kfs)
            if "init" not in states and init_due:
                pending["init"] = dict(snapshot(ref), call=call_of(frame, k))
            if "viba2" not in states and m.imu_stage == 2 and m.imu_t0 >= 0 and elapsed >= cfg.viba2_time:
                states["viba2"] = dict(snapshot(ref), call=call_of(frame, k))
            out = real_ladder(frame, k)
            if "init" not in states and init_due and ref.map.imu_stage >= 1:
                states["init"] = pending.pop("init")
            return out

        def loop_step(k, map_ref, frame=None):
            if "loop" not in states:
                pending["loop"] = dict(snapshot(ref), call=dict(k=int(k), at=now["i"],
                                                                imu_stage=int(ref.map.imu_stage)))
            n0 = ref.loop_closer.n_loops_closed
            out = real_loop(k, map_ref, frame=frame)
            if "loop" not in states and ref.loop_closer.n_loops_closed > n0 and ref.map.imu_stage >= 3:
                states["loop"] = pending["loop"]
            return out

        real_hook = ref.loop_closer.global_ba_hook

        def hook(k, c):
            if "gba" not in states:
                pending["gba"] = dict(snapshot(ref), call=dict(k=int(k), c=int(c), at=now["i"]))
            return real_hook(k, c)

        def loop_step_gba(k, map_ref, frame=None):
            out = loop_step(k, map_ref, frame=frame)
            if "gba" not in states and "loop" in states:
                states["gba"] = pending["gba"]
            return out

        ref._imu_ladder, ref._loop_step, ref.loop_closer.global_ba_hook = ladder, loop_step_gba, hook
        stage_of, tracked, t0 = [], 0, time.perf_counter()
        for i, (left, right) in enumerate(frames):
            now["i"] = i
            t1 = time.perf_counter()
            tracked += ref.track_stereo(left, right, float(stamps[i]), imu=rows[i]) is not None
            stage_of.append(int(ref.map.imu_stage))
            print(f"frame {i}: stage {stage_of[-1]}, state {ref.state.name}, keyframes {ref.map.n_keyframes()}, "
                  f"landmarks {ref.map.n_landmarks()}, loops {ref.loop_closer.n_loops_closed}, "
                  f"{time.perf_counter() - t1:.2f} s", flush=True)
        loops = [dict(kf=int(e["kf"]), match=int(e["match"]), kf_frame=int(e["kf_frame"]),
                      match_frame=int(e["match_frame"]), scale=float(e["scale"]))
                 for e in ref.loop_closer.events if e["kind"] == "loop"]
        meta = dict(stage_of=stage_of, stage_frames={s: stage_of.index(s) for s in sorted(set(stage_of))},
                    inits=rec["init"], fiba=[{k: v for k, v in r.items() if k != "ms"} for r in rec["fiba"]],
                    refinements=rec["refine"], loops=loops, graphs=[g["mode"] for g in rec["graph"]],
                    keyframes=int(ref.map.n_keyframes()), landmarks=int(ref.map.n_landmarks()), tracked=tracked,
                    seconds=time.perf_counter() - t0, missing=[s for s in STAGES if s not in states])
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
