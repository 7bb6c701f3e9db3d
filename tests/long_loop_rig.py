"""The port's long run on the CPU just before the loop that throws it off
(ROADMAP C4), as a state that a port tracker and a reference tracker can
both be loaded with.

The long run is chip_smoke.py's long phase (tests/test_long_sequence.py's
560 noisy frames at 640x480, 800 features, synchronous, loop closing on),
driven by the port on the CPU with one torch thread, as the slow
tests/test_torch_long_sequence.py drives it. `capture` snapshots the
tracker (`snapshot`: live state, map, keyframe database, loop state) just
before every loop step, and keeps the one before the first loop after which
the scale-aligned ATE of the exported poses exceeds the long phase's bar.
That state is stored in tests/data/long_cpu_loop_state.npz; rewrite it with

    python tests/long_loop_rig.py [PATH]

(one torch thread, ~16 min on a CPU core).
"""

from __future__ import annotations

import hashlib
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the long phase's scene, frames and config)
from orbslam3_cpp_fork_tpu_torch import convert  # noqa: E402
from orbslam3_cpp_fork_tpu_torch.runtime import tracker as tt  # noqa: E402

STATE = Path(__file__).parent / "data" / "long_cpu_loop_state.npz"


def port_tracker(scene):
    return tt.Tracker(chip_smoke.long_config(scene), "cpu")


def ref_tracker(scene):
    from orbslam3_cpp_fork_tpu.ops.camera import Camera
    from orbslam3_cpp_fork_tpu.ops.orb import OrbParams
    from orbslam3_cpp_fork_tpu.runtime import tracker as jt

    K = scene.K
    return jt.Tracker(jt.TrackerConfig(
        camera=Camera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2]), width=scene.width, height=scene.height,
        orb=OrbParams(n_features=chip_smoke.LONG_FEATURES), mapping_backend="cpu", async_mapping=False,
        enable_loop_closing=True,
    ))


def snapshot(trk) -> dict:
    """Everything a tracking step, a mapping step and a loop step read, as
    numpy (the trajectory records are left out: neither step reads them)."""
    state = convert.tracker_state_to_numpy(trk)
    state["trajectory"] = []
    return dict(state=state, map=convert.map_state_to_numpy(trk.map), kfdb=convert.kfdb_to_numpy(trk.kfdb),
                loop=convert.loop_state_to_numpy(trk.loop_closer))


def loaded(impl, scene, S):
    """A reference or a port tracker in the state of `snapshot` (the
    reference through tests/test_torch_loop_drift.py's `load_ref`)."""
    if impl == "reference":
        from test_torch_loop_drift import load_ref

        trk = ref_tracker(scene)
        load_ref(trk, S)
    else:
        trk = port_tracker(scene)
        convert.load_tracker_state(trk, S["state"], S["map"])
        convert.load_place_recognition(trk, S["kfdb"], S["loop"])
    return trk


# ---------------------------------------------------------------- storage
# A snapshot is a tree of dicts, lists, tuples, numbers, strings, None and
# arrays. It is stored as one JSON description and its arrays; boolean
# arrays bit-packed, equal arrays stored once, and each stored
# keyframe-database descriptor row that equals its map keyframe's
# descriptors stored as that slot.


def _encode(x, arrays, seen=None):
    seen = {} if seen is None else seen
    if isinstance(x, dict):
        return {"d": [[_encode(k, arrays, seen), _encode(v, arrays, seen)] for k, v in x.items()]}
    if isinstance(x, (list, tuple)):
        return {"l" if isinstance(x, list) else "t": [_encode(v, arrays, seen) for v in x]}
    if isinstance(x, np.ndarray):
        packed = x.dtype == bool
        data = np.packbits(x) if packed else x
        key = (x.dtype.str, x.shape, hashlib.sha1(np.ascontiguousarray(data)).hexdigest())
        name = seen.setdefault(key, f"a{len(arrays)}")
        arrays[name] = data
        return {"b": name, "shape": list(x.shape)} if packed else {"a": name}
    if isinstance(x, np.generic):
        return x.item()
    return x


def _decode(x, z):
    if not isinstance(x, dict):
        return x
    if "d" in x:
        return {_decode(k, z): _decode(v, z) for k, v in x["d"]}
    if "l" in x:
        return [_decode(v, z) for v in x["l"]]
    if "t" in x:
        return tuple(_decode(v, z) for v in x["t"])
    if "b" in x:
        shape = tuple(x["shape"])
        return np.unpackbits(z[x["b"]], count=int(np.prod(shape))).astype(bool).reshape(shape)
    return z[x["a"]].copy()


def _maps_of(S: dict) -> dict:
    """{map namespace: map arrays} of a snapshot: its one map, or every map
    of its Atlas (`inertial_merge_rig.snapshot`)."""
    maps = [S["map"]] if "map" in S else S["atlas"]["maps"]
    return {int(m["map_id"]) % 16: m for m in maps}


def _kfdb_from_map(S: dict) -> dict:
    """`S` with each stored keyframe-database descriptor row that equals its
    map keyframe's descriptors replaced by that row's number."""
    kd, maps = S["kfdb"], _maps_of(S)
    K = next(iter(maps.values()))["kf_valid"].shape[0]
    from_map, store = [], {}
    for row, (d, v) in kd["desc_store"].items():
        m, slot = maps.get(row // K), row % K
        if m is not None and m["kf_valid"][slot] and np.array_equal(d, m["kf_desc"][slot]) \
                and np.array_equal(v, m["kf_feat_valid"][slot]):
            from_map.append(row)
        else:
            store[row] = (d, v)
    return dict(S, kfdb=dict(kd, desc_store=store, desc_store_from_map=from_map))


def _kfdb_to_map(S: dict) -> dict:
    """The inverse of `_kfdb_from_map`, in place."""
    kd, maps = S["kfdb"], _maps_of(S)
    K = next(iter(maps.values()))["kf_valid"].shape[0]
    for row in kd.pop("desc_store_from_map"):
        m, slot = maps[row // K], row % K
        kd["desc_store"][row] = (m["kf_desc"][slot].copy(), m["kf_feat_valid"][slot].copy())
    return S


def save_states(states: dict, path, **meta) -> None:
    """Store named snapshots (`snapshot`) and a JSON-able `meta` in one file."""
    arrays = {}
    tree = _encode(dict(S={k: _kfdb_from_map(S) for k, S in states.items()}, meta=meta), arrays)
    np.savez_compressed(path, tree=np.frombuffer(json.dumps(tree).encode(), np.uint8), **arrays)


def load_states(path):
    """(named snapshots, meta) of a file written by `save_states`."""
    with np.load(path) as z:
        out = _decode(json.loads(z["tree"].tobytes().decode()), z)
    return {k: _kfdb_to_map(S) for k, S in out["S"].items()}, out["meta"]


def save_state(S: dict, path, **meta) -> None:
    arrays = {}
    tree = _encode(dict(S=_kfdb_from_map(S), meta=meta), arrays)
    np.savez_compressed(path, tree=np.frombuffer(json.dumps(tree).encode(), np.uint8), **arrays)


def load_state(path=STATE):
    """(snapshot, meta) of a file written by `save_state`."""
    with np.load(path) as z:
        out = _decode(json.loads(z["tree"].tobytes().decode()), z)
    return _kfdb_to_map(out["S"]), out["meta"]


# ---------------------------------------------------------------- capture


def capture(bar: float = chip_smoke.LONG_MAX_ATE_M, last: int = chip_smoke.LONG_FRAMES - 1):
    """Drive the port over the long frames from a cold start (one torch
    thread) until the first loop after which the scale-aligned ATE of the
    exported poses exceeds `bar`. Returns (the snapshot taken just before
    that loop's loop step, meta: its frame, keyframe, match, Sim(3) scale,
    the ATE before and after, and for every loop step from the first that
    held the loop's candidate pending: frame, keyframe, pending hypothesis;
    the exported ATE after every frame since the loop before it, or None if
    no loop does so by frame `last`."""
    from orbslam3_cpp_fork_tpu_torch.utils.evaluation import ate_rmse

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        scene, stamps, Rs, ts = chip_smoke.render_long()
        trk = port_tracker(scene)
        lc, real = trk.loop_closer, trk._loop_step
        now, before, steps = {"i": 0}, {}, []

        def loop_step(k, map_ref, frame=None):
            before[int(k)] = snapshot(trk)
            out = real(k, map_ref, frame=frame)
            p = lc.pending
            steps.append(dict(frame=now["i"], kf=int(k), pending=None if p is None else
                              dict(gid=int(p[0]), count=int(p[1]), scale=float(p[2][0]), kf=int(p[3]))))
            return out

        trk._loop_step = loop_step
        n_loops, since = 0, []
        for i, img in enumerate(chip_smoke.long_frames(scene, Rs, ts)):
            if i > last:
                return None
            now["i"] = i
            trk.track(img, float(stamps[i]))
            ts_est, Twc = trk.export_trajectory()  # synchronous: nothing in flight
            ate = ate_rmse(ts_est, Twc[:, :3, 3], stamps, ts).rmse_scaled if len(ts_est) else float("inf")
            loops = [e for e in lc.events if e["kind"] == "loop"]
            if len(loops) > n_loops:
                if ate > bar:
                    ev = loops[-1]
                    K = trk.map.cfg.max_keyframes
                    c_gid = trk.map.map_id % 16 * K + ev["match"]
                    held = [s for s in steps if s["pending"] is not None and s["pending"]["gid"] == c_gid]
                    first = steps.index(held[0]) if held else len(steps) - 1
                    return before[ev["kf"]], dict(
                        frame=i, kf=int(ev["kf"]), match=int(ev["match"]), kf_frame=int(ev["kf_frame"]),
                        match_frame=int(ev["match_frame"]), scale=float(ev["scale"]), ate_before=since[-1][1],
                        ate_after=ate, loops_before=n_loops, steps=steps[first:], ate_since_last_loop=since)
                n_loops, since = len(loops), []
            since.append((i, ate))
            before.clear()
    finally:
        torch.set_num_threads(n)


if __name__ == "__main__":
    path = Path(sys.argv[1]) if len(sys.argv) > 1 else STATE
    S, meta = capture()
    save_state(S, path, **meta)
    print(json.dumps(meta), f"written to {path} ({path.stat().st_size} bytes)")
