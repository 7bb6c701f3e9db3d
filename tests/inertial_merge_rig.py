"""The inertial Atlas from the reference's own states: chip_smoke.py's
inertial merge scene (the inertial long scene over three laps with two flat
stretches, EuRoC's camera rig, the reference's default ladder, loop closing
and the global BA on, synchronous, the user's time_recently_lost of 5 s and
relocalization patience of 12 frames) tracked by the reference's
IMU_MONOCULAR Tracker on the CPU, which stops just before three calls and
stores its state each time:

(a) "spawn": the `_spawn_or_reset_map` call that keeps map 0 (stage 3) in
    the Atlas and starts map 1, after the first blind stretch;
(b) "reset": the `_spawn_or_reset_map` call that discards map 1 (4
    keyframes, before its IMU init), after the second;
(c) "merge": the loop step whose proposal welds map 1 (past its own VIBA2)
    into map 0, with the live frame the merge re-anchors;
(d) "after": the end of that frame, with the next N_NEXT frames' features
    (the reference's ORB) and IMU rows, and what a reference tracker loaded
    with this state gives on them (`next_frames`), so that the tier-1 test
    steps only the port (the slow tests/test_torch_inertial_merge_e2e.py
    -k next_frames steps the reference again and holds it to the stored
    outputs).

Each state holds the whole Atlas with every map's inertial fields
(`convert.atlas_to_numpy`), the live tracking state with its inertial part,
the keyframe database and the loop state, and the call's arguments.

ROADMAP R13: the reference's reset keeps the map id and restarts the
keyframe generations, so its device keyframe store goes on serving the
discarded keyframes' rows to the reset map, whose triangulations then fail:
on this scene the reference loses every reset map at 4-5 keyframes and never
reaches VIBA2 again. The port invalidates the store (and the local-map
snapshot) at every spawn and reset; the rig gives the reference tracker the
same invalidation (`repair_r13`) and nothing else, so state (c) is the
reference's own run with R13 repaired.

The states are stored in tests/data/inertial_merge_states.npz; rewrite it
with

    python tests/inertial_merge_rig.py [PATH]

(one torch thread, the reference's JAX on the CPU; 7-15 min on a CPU
core). Cut to size for the CPU as tests/inertial_long_rig.py: 640x480 with
400 features and a map of 128 keyframes and 4,096 landmarks.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the inertial merge phase's scene and config)
import inertial_long_rig as ilr  # noqa: E402
from long_loop_rig import load_states, save_states  # noqa: E402
from orbslam3_cpp_fork_tpu_torch import convert  # noqa: E402

STATES = Path(__file__).parent / "data" / "inertial_merge_states.npz"
SIZE = ilr.SIZE
N_FEAT = ilr.N_FEAT
STAGES = ("spawn", "reset", "merge", "after")
N_NEXT = 5


def scene_and_frames(render=True):
    """The scene at the CPU size: scene, stamps, camera poses, uint8 frames
    (None unless `render`) and IMU rows."""
    return chip_smoke.render_inertial_merge(*SIZE, render=render)


def repair_r13(ref):
    """ROADMAP R13's repair on a reference tracker instance: after every
    spawn or reset its device keyframe store and local-map snapshot are
    invalidated, as the port's `_spawn_or_reset_map` does."""
    real = ref._spawn_or_reset_map

    def spawn_or_reset():
        out = real()
        ref._kf_store.gen[:] = -1
        ref._dev_local = None
        return out

    ref._spawn_or_reset_map = spawn_or_reset
    return ref


def snapshot(trk) -> dict:
    """Everything a tracking step, a mapping step, a loop step and a spawn
    or reset read, as numpy: the live state, the whole Atlas, the keyframe
    database and the loop state (the trajectory records are left out)."""
    state = convert.tracker_state_to_numpy(trk)
    state["trajectory"] = []
    return dict(state=state, atlas=convert.atlas_to_numpy(trk.atlas), kfdb=convert.kfdb_to_numpy(trk.kfdb),
                loop=convert.loop_state_to_numpy(trk.loop_closer))


def load_ref(ref, S):
    """The reference tracker in the state of `snapshot`: every map of the
    Atlas (each with the tracker's IMU calibration), the live state, the
    keyframe database and the loop state (the counterpart of
    `convert.load_tracker_state(..., atlas=...)` and
    `convert.load_place_recognition`)."""
    from test_torch_loop_drift import load_ref_place_recognition
    from vi_rig import load_ref_state, ref_map_from_numpy

    a = S["atlas"]
    ref.atlas.maps = [ref_map_from_numpy(d, ref.imu_calib) for d in a["maps"]]
    ref.atlas.active_idx, ref.atlas._next_map_id = a["active_idx"], a["next_map_id"]
    load_ref_state(ref, S["state"], a["maps"][a["active_idx"]])
    ref.lost_frames = S["state"]["lost_frames"]
    ref._kf_alias = dict(S["state"]["kf_alias"])
    load_ref_place_recognition(ref, S["kfdb"], S["loop"])
    ref.loop_closer.n_merges = S["loop"]["n_merges"]


def loaded(impl, scene, S):
    """A reference or a port tracker in the state of `snapshot`."""
    if impl == "reference":
        trk = ilr.ref_tracker(scene)
        load_ref(trk, S)
    else:
        trk = ilr.port_tracker(scene)
        convert.load_tracker_state(trk, S["state"], atlas=S["atlas"])
        convert.load_place_recognition(trk, S["kfdb"], S["loop"])
    return trk


def live_frame(mod, d):
    """The live FrameData of a stored call (`convert.frame_to_numpy`) as
    tracker module `mod`'s type."""
    return mod.FrameData(frame_id=d["frame_id"], timestamp=d["timestamp"],
                         R=None if d["R"] is None else d["R"].copy(), t=None if d["t"] is None else d["t"].copy(),
                         **{k: d[k].copy() for k in convert.FRAME_ARRAYS})


def next_frames(impl, scene, S):
    """Load state "after" into a tracker of `impl` and track the stored
    next frames on their features and IMU rows. Returns, after each frame,
    its pose (None if untracked), the tracking state, the keyframes inserted
    and cur_v, cur_bg, cur_ba."""
    from vi_rig import frame_of

    if impl == "reference":
        from orbslam3_cpp_fork_tpu.runtime import tracker as mod
    else:
        from orbslam3_cpp_fork_tpu_torch.runtime import tracker as mod
    trk = loaded(impl, scene, S)
    out = []
    for nxt in S["next"]:
        trk._ingest_imu(nxt["rows"], nxt["stamp"])
        T = trk._process(frame_of(mod, nxt["feats"], trk.frame_id, nxt["stamp"]))
        out.append(dict(T=None if T is None else np.asarray(T, np.float32), state=trk.state.name,
                        kfs=int(trk.n_kf_inserted), **{k: np.array(getattr(trk, k), np.float32)
                                                       for k in ("cur_v", "cur_bg", "cur_ba")}))
    return out


def capture():
    """Drive the reference (R13 repaired) over the scene from a cold start
    (one torch thread) and take the four states. Returns ({stage:
    snapshot with its call}, meta: the run's spawns and resets, welds, each
    map's stages by frame, the last map's keyframe frames and imu_t0, frames
    tracked, loops, the ATE at the weld and at the end, the seconds)."""
    from vi_rig import ref_features

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        scene, stamps, Rs, ts, frames, rows = scene_and_frames()
        ref = repair_r13(ilr.ref_tracker(scene))
        states, pending = {}, {}
        real_sor, real_loop = ref._spawn_or_reset_map, ref._loop_step

        def spawn_or_reset():
            kind = "reset" if ref.map.n_keyframes() < chip_smoke.VIM_KEEP_MIN_KFS else "spawn"
            if kind not in states:
                states[kind] = dict(snapshot(ref), call=dict(kind=kind, at=int(ref.frame_id)))
            return real_sor()

        def loop_step(k, map_ref, frame=None):
            n_maps = ref.atlas.n_maps()
            if "merge" not in states and n_maps > 1 and ref.map.imu_stage >= 3:
                pending["S"] = dict(snapshot(ref), call=dict(k=int(k), at=int(ref.frame_id),
                                                             frame=convert.frame_to_numpy(frame)))
            out = real_loop(k, map_ref, frame=frame)
            if "merge" not in states and ref.atlas.n_maps() < n_maps:
                states["merge"] = pending["S"]
            return out

        ref._spawn_or_reset_map, ref._loop_step = spawn_or_reset, loop_step
        _, vi, pg, solver = ilr.modules("reference")
        rec = chip_smoke.record_inertial_path(ref, vi, pg, solver)

        def on_frame(i):
            if "merge" in states and "after" not in states:
                states["after"] = dict(snapshot(ref), call=dict(at=i))
            m = ref.map
            print(f"frame {i}: map {m.map_id} ({ref.atlas.n_maps()} maps), stage {m.imu_stage}, state "
                  f"{ref.state.name}, keyframes {m.n_keyframes()}, landmarks {m.n_landmarks()}, loops "
                  f"{ref.loop_closer.n_loops_closed}, merges {ref.loop_closer.n_merges}", flush=True)

        rep = chip_smoke.drive_inertial_merge(ref, frames, stamps, rows, ts, on_frame)
        end = chip_smoke.vim_ate(ref, rep["spawn"], rep["dead"], stamps, ts)
        if "after" in states:
            S = states["after"]
            at = S["call"]["at"]
            S["next"] = [dict(feats=ref_features("mono", frames[j], N_FEAT), stamp=float(stamps[j]), rows=rows[j])
                         for j in range(at + 1, at + 1 + N_NEXT)]
            S["reference_next"] = next_frames("reference", scene, S)
        loops = [dict(kf=int(e["kf"]), match=int(e["match"]), kf_frame=int(e["kf_frame"]),
                      match_frame=int(e["match_frame"]), scale=float(e["scale"]))
                 for e in ref.loop_closer.events if e["kind"] == "loop"]
        meta = dict(spawns=rep["spawn"], welds=rep["welds"],
                    stages={str(k): {str(s): f for s, f in v.items()} for k, v in rep["stages"].items()},
                    kf_frames={str(k): v for k, v in rep["kf_frames"].items()},
                    imu_t0={str(k): v for k, v in rep["imu_t0"].items()}, tracked=rep["tracked"],
                    outside=rep["n_outside"], maps_seen=rep["maps_seen"], weld=rep["weld"], end=end, loops=loops,
                    graphs=rec["graph"], seconds=rep["seconds"],
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
    t0 = time.perf_counter()
    states, meta = capture()
    print(json.dumps(meta))
    save_states(states, path, **meta)
    print(f"{sorted(states)} written to {path} ({path.stat().st_size} bytes) in {time.perf_counter() - t0:.0f} s")
    load_states(path)
