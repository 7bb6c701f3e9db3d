"""`Tracker._execute_merge`, port against reference, from the same two-map
state (tests/merge_rig.py: a map rendered with exact depth, and a second one
over an overlapping arc in a Sim(3)-moved world with seeded noise, loaded
into both trackers), and `export_trajectory` across the spawn and across
that merge.

Tolerances: the remaps, aliases, database rows and bindings after the fuse
exact; after the welding BA and the merge essential graph the live pose and
the rotations within 1e-4, the translations within 1e-4 but for one
keyframe (2e-4), the landmarks within 1e-4 on 90% and 1e-3 on all. The two
agree to 2.4e-7 before the welding BA and to 7.5e-6 through its fifth
iteration; near convergence the LM accept test (cost 364.38 against 364.39)
takes another step in one implementation than in the other, which leaves
1.3e-4 on the seam's first keyframe and up to 5.4e-4 on the landmarks it
sees. The exports within 1e-5, on the same keyframe poses.
"""

import numpy as np
import pytest
import torch

from orbslam3_cpp_fork_tpu.runtime import tracker as jt
from orbslam3_cpp_fork_tpu_torch.runtime import tracker as tt

import merge_rig
from merge_rig import A_DEGS, B_DEGS, C_A, K_B, circle_pose, live_frame
from test_torch_merge import _export, _loaded_pair


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def two_maps():
    return merge_rig.two_map_state()


def test_execute_merge_matches_the_reference(two_maps):
    scene, atlas_np, S_kc = two_maps
    ref, got = _loaded_pair(scene, atlas_np)
    # Across the spawn: each map's frames in its own world.
    (ts_r, T_r), (ts_g, T_g) = _export(ref), _export(got)
    assert len(ts_g) == 26 and np.array_equal(ts_g, ts_r)
    np.testing.assert_allclose(T_g, T_r, atol=1e-5, err_msg="tolerance 1e-5")

    d_b = atlas_np["maps"][1]
    f_r, f_g = live_frame(jt, d_b, K_B), live_frame(tt, d_b, K_B)
    proposal = (0, C_A, S_kc, 1, K_B)
    ref._execute_merge(K_B, f_r, *proposal)
    got._execute_merge(K_B, f_g, *proposal)

    assert got.atlas.n_maps() == ref.atlas.n_maps() == 1 and got.map.map_id == 0
    assert got._kf_alias == ref._kf_alias and len(got._kf_alias) == 14, "tolerance: exact"
    assert got.ref_kf == ref.ref_kf
    assert np.array_equal(got.kfdb.present, ref.kfdb.present) and np.array_equal(got.kfdb.hists, ref.kfdb.hists)
    assert sorted(got.kfdb._desc_store) == sorted(ref.kfdb._desc_store) == sorted(
        got._gid(int(k)) for k in np.nonzero(got.map.kf_valid)[0]), "database rows: tolerance exact"
    a, b = ref.map, got.map
    assert np.array_equal(b.kf_valid, a.kf_valid) and np.array_equal(b.lm_valid, a.lm_valid)
    assert np.array_equal(b.kf_lm_idx, a.kf_lm_idx), "bindings after the fuse: tolerance exact"
    assert np.array_equal(f_g.lm_idx, f_r.lm_idx), "live bindings: tolerance exact"
    np.testing.assert_allclose(f_g.R, f_r.R, atol=1e-4, err_msg="live pose: tolerance 1e-4")
    np.testing.assert_allclose(f_g.t, f_r.t, atol=1e-4, err_msg="live pose: tolerance 1e-4")
    np.testing.assert_allclose(b.kf_R, a.kf_R, atol=1e-4, err_msg="tolerance 1e-4")
    dt = np.abs(b.kf_t - a.kf_t).max(1)
    assert np.sort(dt)[-2] <= 1e-4 and dt.max() <= 2e-4, "keyframe t: 1e-4, 2e-4 for one keyframe (docstring)"
    dX = np.abs(b.lm_pos - a.lm_pos).max(1)[b.lm_valid]
    assert np.quantile(dX, 0.9) <= 1e-4 and dX.max() <= 1e-3, "landmarks: 1e-4 on 90%, 1e-3 on all (docstring)"
    # The weld put map 1's keyframes at their ground truth in map 0's world.
    c_k = -f_g.R.T @ f_g.t
    assert np.linalg.norm(c_k - circle_pose(B_DEGS[K_B])[1]) < 0.05
    # Across the merge: one world, the records of map 1 through the aliases
    # (the export of the same keyframe poses: the reference's).
    b.kf_R[...], b.kf_t[...] = a.kf_R, a.kf_t
    (ts_r, T_r), (ts_g, T_g) = _export(ref), _export(got)
    assert len(ts_g) == 26 and np.array_equal(ts_g, ts_r)
    np.testing.assert_allclose(T_g, T_r, atol=1e-5, err_msg="tolerance 1e-5")
    gt = np.stack([circle_pose(deg)[1] for deg in np.concatenate([A_DEGS, B_DEGS])])
    assert np.median(np.linalg.norm(T_g[:, :3, 3] - gt, axis=1)) < 0.05


def test_execute_merge_drops_a_stale_proposal(two_maps):
    scene, atlas_np, S_kc = two_maps
    _, got = _loaded_pair(scene, atlas_np)
    f = live_frame(tt, atlas_np["maps"][1], K_B)
    got._execute_merge(K_B, f, 7, C_A, S_kc, 1, K_B)  # no map 7
    got._execute_merge(K_B, f, 0, C_A, S_kc, 0, K_B)  # the active map is not map 0
    assert got.atlas.n_maps() == 2 and not got._kf_alias
