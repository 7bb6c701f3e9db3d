"""Keyframe culling on the card's long run's final map (ROADMAP C5), on the CPU.

The card's 560-frame long run (chip_smoke.py's `long` phase) inserts 137
keyframes and culls none, where the port on the CPU culls some. The cull is
host numpy, so it decides the same on any machine given the same map: its
inputs of the card's final map were written by `python3 chip_smoke.py
--long-state tests/data/long_card_cull_state.npz` on an
NVIDIA H100 and are loaded here into a port tracker (through
`convert.load_tracker_state`) and into a reference tracker. Both culls,
asked with every live keyframe as the new one, remove nothing: no candidate
is 90% redundant on that map, the covisibility graph's native route and
dense product agree on it, and so the card's zero is the map's, not the
port's.
"""

from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke
from orbslam3_cpp_fork_tpu.models import map_state as jms
from orbslam3_cpp_fork_tpu.ops.camera import Camera as JCamera
from orbslam3_cpp_fork_tpu.ops.orb import OrbParams as JOrbParams
from orbslam3_cpp_fork_tpu.runtime import tracker as jtr
from orbslam3_cpp_fork_tpu_torch import convert
from orbslam3_cpp_fork_tpu_torch.models import map_state as tms
from orbslam3_cpp_fork_tpu_torch.ops.orb import OrbParams
from orbslam3_cpp_fork_tpu_torch.runtime import tracker as ttr

STATE = Path(__file__).parent / "data" / "long_card_cull_state.npz"
# The long phase's camera (datasets.synthetic.make_ring_scene at 640x480)
# and features; the cull reads neither, the trackers need them.
FX, CX, CY, W, H, FEATURES = 500.0, 320.0, 240.0, 640, 480, 800


@pytest.fixture(scope="module")
def card_map():
    """The card's final map as `convert.map_state_to_numpy` arrays, and the
    tracker state beside it (reference keyframe, keyframes inserted)."""
    z = np.load(STATE)
    cfg = tms.MapConfig(max_keyframes=int(z["max_keyframes"]), max_landmarks=int(z["max_landmarks"]),
                        n_features=int(z["n_features"]))
    arrays = convert.map_state_to_numpy(tms.MapState(cfg))
    live = z["slots"].astype(np.int64)
    arrays["kf_valid"][live] = True
    arrays["kf_frame_id"][live] = z["kf_frame_id"]
    arrays["kf_lm_idx"][live] = z["kf_lm_idx"]
    arrays["kf_level"][live] = z["kf_level"]
    arrays["kf_feat_valid"][live] = z["kf_lm_idx"] >= 0
    arrays["obs"][live] = np.unpackbits(z["obs"], axis=1, count=cfg.max_landmarks).astype(bool)
    arrays["lm_valid"][:] = np.unpackbits(z["lm_valid"], count=cfg.max_landmarks).astype(bool)
    return arrays, dict(ref_kf=int(z["ref_kf"]), n_kf_inserted=int(z["n_kf_inserted"]), card=str(z["card"]))


def _port_tracker(arrays, live):
    cfg = ttr.TrackerConfig(async_mapping=False, camera=convert.camera_from_numpy(FX, FX, CX, CY), width=W,
                            height=H, orb=OrbParams(n_features=FEATURES), enable_loop_closing=True)
    trk = ttr.Tracker(cfg, "cpu")
    state = convert.tracker_state_to_numpy(trk)
    state.update(state="OK", ref_kf=live["ref_kf"], n_kf_inserted=live["n_kf_inserted"])
    convert.load_tracker_state(trk, state, map_arrays=arrays)
    return trk


def _reference_tracker(arrays, live):
    cfg = jtr.TrackerConfig(async_mapping=False, camera=JCamera.pinhole(FX, FX, CX, CY), width=W, height=H,
                            orb=JOrbParams(n_features=FEATURES), enable_loop_closing=True)
    ref = jtr.Tracker(cfg)
    K, L = arrays["obs"].shape
    m = jms.MapState(jms.MapConfig(max_keyframes=K, max_landmarks=L, n_features=arrays["kf_xy"].shape[1],
                                   imu_cap=arrays["kf_imu"].shape[1]))
    for k in convert.MAP_ARRAYS:
        getattr(m, k)[...] = arrays[k]
    m.mark_obs_dirty()
    ref.atlas.maps[ref.atlas.active_idx] = m
    ref.state = jtr.TrackState.OK
    ref.ref_kf, ref.n_kf_inserted = live["ref_kf"], live["n_kf_inserted"]
    return ref


def test_the_card_state_is_the_long_runs(card_map):
    arrays, live = card_map
    assert live["card"].startswith("NVIDIA H100"), live["card"]
    assert arrays["kf_valid"].sum() == live["n_kf_inserted"] == 137, "137 inserted, all alive: none culled"
    # `obs` is the incidence of the keyframes' landmark ids (the map keeps
    # them so); a keyframe's own landmarks are live.
    inc = np.zeros_like(arrays["obs"])
    for k in np.nonzero(arrays["kf_valid"])[0]:
        lm = arrays["kf_lm_idx"][k]
        inc[k, lm[lm >= 0]] = True
    assert np.array_equal(inc, arrays["obs"])
    assert arrays["lm_valid"][arrays["obs"].any(axis=0)].all()


def test_both_covisibility_routes_agree_on_the_card_state(card_map):
    arrays, _ = card_map
    m = convert.map_state_from_numpy(arrays)
    assert m._native is not None, "the native map graph must build here (g++)"
    assert chip_smoke.covisibility_rows_differ(m) == 0


def test_neither_cull_removes_a_keyframe_of_the_card_state(card_map):
    """Both implementations' `_cull_keyframes` with every live keyframe as
    the newly inserted one: no keyframe goes, and no candidate the port
    weighs reaches the 0.9 redundancy bar."""
    arrays, live = card_map
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        port = _port_tracker(arrays, live)
    finally:
        torch.set_num_threads(n)
    ref = _reference_tracker(arrays, live)
    slots = np.nonzero(arrays["kf_valid"])[0]
    for k in slots:
        port._cull_keyframes(int(k))
        ref._cull_keyframes(int(k))
    st = port.cull_stats
    assert np.array_equal(port.map.kf_valid, arrays["kf_valid"]), "the port culled"
    assert np.array_equal(ref.map.kf_valid, arrays["kf_valid"]), "the reference culled"
    assert st.calls == len(slots) and st.culled == 0 and st.max_cull == 0
    assert st.candidates == st.protected + st.inertial_gap + st.few_landmarks + st.below_redundancy
    assert len(st.redundancy) == st.below_redundancy > 0
    print(f"\ncard state ({live['card']}): {st.candidates} candidates, protected {st.protected}, below the bar "
          f"{st.below_redundancy}; redundant fraction max {max(st.redundancy):.4f}, median "
          f"{float(np.median(st.redundancy)):.4f}")
    assert max(st.redundancy) < 0.9
