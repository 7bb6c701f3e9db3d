"""One loop correction (`_correct_loop`: window correction, SearchAndFuse,
the essential graph, landmark re-anchoring) applied by the reference and by
the port to the same map, the port's after 30 frames of the slow-path rig's
ring.

Tolerances: the same landmarks fused (validity and replacement tables
exact), keyframe poses within 1e-4 and landmark positions within 1e-3 map
units (the essential graph is a Gauss-Newton solve in f32; the reference
pads it to 64 vertices and 1024 edges).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_cpp_fork_tpu.runtime import loop_closing as jlc
from orbslam3_cpp_fork_tpu.runtime.keyframe_database import KeyFrameDatabase as RefDB
from orbslam3_cpp_fork_tpu.utils import lie as jl
from orbslam3_cpp_fork_tpu_torch import convert
from orbslam3_cpp_fork_tpu_torch.runtime import loop_closing as tlc
from orbslam3_cpp_fork_tpu_torch.runtime.keyframe_database import KeyFrameDatabase as PortDB

from test_torch_slow_path import MAP_CFG, _scene, port_tracker, ref_map_from_numpy

FX, FY = 400.0, 400.0


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tracked_map():
    """The port's map after 30 frames of the slow-path rig's ring (320x240,
    400 features), as numpy."""
    scene, Rs, ts = _scene()
    trk = port_tracker(scene)
    from orbslam3_cpp_fork_tpu_torch.datasets import synthetic

    for i in range(30):
        trk.track(synthetic.render_frame(scene, Rs[i], ts[i]), 0.05 * i)
    assert trk.state.name == "OK"
    return convert.map_state_to_numpy(trk.map)


def test_correct_loop_matches_the_reference(tracked_map):
    m_ref = ref_map_from_numpy(tracked_map)
    m_got = convert.map_state_from_numpy(tracked_map)
    kfs = np.nonzero(m_got.kf_valid)[0]
    kfs = kfs[np.argsort(m_got.kf_frame_id[kfs])]
    assert len(kfs) >= 6
    k, c = int(kfs[-1]), int(kfs[len(kfs) // 2])
    # S_kc = T_kw T_cw^-1 with a 1 degree, 3 % correction in it.
    dR = np.asarray(jl.so3_exp(jnp.asarray([0.0, 0.0175, 0.0], jnp.float32)))
    R = dR @ m_got.kf_R[k] @ m_got.kf_R[c].T
    t = m_got.kf_t[k] - R @ m_got.kf_t[c]
    s = 1.03
    K = MAP_CFG["max_keyframes"]
    ref = jlc.LoopCloser(types.SimpleNamespace(active=m_ref, maps=[m_ref]), RefDB(16 * K), FX, FY, 160.0, 120.0)
    got = tlc.LoopCloser(types.SimpleNamespace(active=m_got, maps=[m_got]), PortDB(16 * K, torch.device("cpu")),
                         FX, FY, 160.0, 120.0, torch.device("cpu"))
    ref._correct_loop(k, c, s, R.astype(np.float32), t.astype(np.float32))
    got._correct_loop(k, c, s, R.astype(np.float32), t.astype(np.float32))
    assert got.n_loops_closed == ref.n_loops_closed == 1 and got.events == ref.events
    assert got.last_loop_kf == ref.last_loop_kf == k and m_got.big_change_idx == m_ref.big_change_idx
    # The same landmarks fused.
    assert np.array_equal(m_got.lm_valid, m_ref.lm_valid), "tolerance: exact"
    assert np.array_equal(m_got.lm_replaced, m_ref.lm_replaced), "tolerance: exact"
    assert np.array_equal(m_got.kf_lm_idx, m_ref.kf_lm_idx) and np.array_equal(m_got.obs, m_ref.obs)
    # Poses after the essential graph, landmarks after re-anchoring.
    np.testing.assert_allclose(m_got.kf_R[kfs], m_ref.kf_R[kfs], atol=1e-4)
    np.testing.assert_allclose(m_got.kf_t[kfs], m_ref.kf_t[kfs], atol=1e-4)
    lv = m_got.lm_valid
    np.testing.assert_allclose(m_got.lm_pos[lv], m_ref.lm_pos[lv], atol=1e-3)
    # The correction moved the map, and the loop edge was persisted.
    assert np.abs(m_got.kf_t[k] - tracked_map["kf_t"][k]).max() > 1e-3
    (mid, a, b, S), = got.loop_edges
    (_, ar, br, Sr), = ref.loop_edges
    assert (a, b) == (ar, br) == (c, k)
    np.testing.assert_allclose(S[1], np.asarray(Sr[1]), atol=1e-4)
    # The loop state round-trips through convert.
    st = convert.loop_state_to_numpy(ref)
    fresh = tlc.LoopCloser(got.atlas, got.kfdb, FX, FY, 160.0, 120.0, torch.device("cpu"))
    convert.load_loop_state(fresh, st)
    assert fresh.n_loops_closed == 1 and fresh.last_loop_kf == k and len(fresh.loop_edges) == 1
