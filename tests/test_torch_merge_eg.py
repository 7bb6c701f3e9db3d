"""`optimize_essential_graph_merge`, port against reference, on the fixture
of tests/test_merge_eg.py in sim3 and se3 mode: poses and landmarks within
1e-4 (the port's exact-shape solve against the reference's padded one,
ROADMAP R4). A file of its own: the reference's pose-graph compile is the
largest cost of the merge tests, and the test workers split it from
tests/test_torch_merge_execute.py's.
"""

import numpy as np
import pytest
import torch

from orbslam3_cpp_fork_tpu.runtime import loop_closing as jlc
from orbslam3_cpp_fork_tpu_torch import convert
from orbslam3_cpp_fork_tpu_torch.runtime import loop_closing as tlc

import test_merge_eg


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode", ["sim3", "se3"])
def test_merge_essential_graph_matches_the_reference(mode):
    ref = test_merge_eg._make_line_map()
    R_snap, t_snap = ref.kf_R.copy(), ref.kf_t.copy()
    delta = np.array([0.0, 0.3, 0.0], np.float32)
    for k in (10, 11):
        ref.kf_t[k] = ref.kf_t[k] - delta
    ref.kf_t[6] += np.float32(0.05)  # a free keyframe off its snapshot
    got = convert.map_state_from_numpy(convert.map_state_to_numpy(ref))
    free = list(range(2, 10))
    jlc.optimize_essential_graph_merge(ref, free, R_snap, t_snap, mode=mode, covis_edge_weight=8)
    tlc.optimize_essential_graph_merge(got, free, R_snap, t_snap, mode=mode, covis_edge_weight=8, device="cpu")
    np.testing.assert_allclose(got.kf_R, ref.kf_R, atol=1e-4, err_msg="tolerance 1e-4")
    np.testing.assert_allclose(got.kf_t, ref.kf_t, atol=1e-4, err_msg="tolerance 1e-4")
    np.testing.assert_allclose(got.lm_pos, ref.lm_pos, atol=1e-4, err_msg="tolerance 1e-4")
    c9 = -got.kf_R[9].T @ got.kf_t[9]
    assert c9[1] > 0.15, "the correction reached the free keyframes"
    for k in (0, 1, 10, 11):
        assert np.array_equal(got.kf_t[k], ref.kf_t[k]), "fixed keyframes untouched"
