"""Sparse (matrix-free PCG Schur) global BA, port against reference and
against the port's dense-blocked `local_ba` on the same problems: the three
visual cases of tests/test_sparse_ba.py, the map-scale one at a reduced size
(32 keyframes, 1024 landmarks, 320 observations a keyframe), and the PCG
alone.

Tolerances: port vs reference 1e-4 in R, t (1e-3 in Xw, whose depth is
poorly conditioned) and 1e-4 relative in the cost; on the map-scale problem
2e-3 (80 conjugate-gradient iterations a step amplify the f32 summation
order of the segment sums); fixed and invalid keyframes unchanged within
1e-7 (the re-orthonormalization touches every rotation, as the reference's);
the ground-truth gates of the reference tests.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_cpp_fork_tpu.optim import sparse_ba as jsb
from orbslam3_cpp_fork_tpu_torch import convert
from orbslam3_cpp_fork_tpu_torch.optim import sparse_ba as tsb
from orbslam3_cpp_fork_tpu_torch.optim.local_ba import local_ba
from orbslam3_cpp_fork_tpu_torch.utils import lie as tl

from test_optim import _make_ba_problem
from test_sparse_ba import _make_map_scale_problem


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small shapes, six test workers: one intra-op thread each is faster
    than teams of OpenMP threads spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(prob):
    d = {f.name: np.asarray(getattr(prob, f.name)) for f in dataclasses.fields(prob)}
    return convert.ba_problem_from_numpy(d, "cpu")


def _close(got, ref, tol=1e-4, x_tol=1e-3):
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=tol)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=tol)
    np.testing.assert_allclose(got.Xw.numpy(), np.asarray(ref.Xw), atol=x_tol)
    np.testing.assert_allclose(float(got.cost), float(ref.cost), rtol=tol)
    assert (got.obs_inlier.numpy() != np.asarray(ref.obs_inlier)).sum() <= 1


def test_sparse_ba_matches_dense():
    prob, R_gt, t_gt, X_gt = _make_ba_problem()
    p = _port(prob)
    res_s = tsb.sparse_ba(p, iters=12, gate_at=6, cg_iters=60)
    _close(res_s, jsb.sparse_ba(prob, iters=12, gate_at=6, cg_iters=60))
    res_d = local_ba(p, iters=12, gate_at=6)
    for k in range(R_gt.shape[0]):
        assert np.linalg.norm(tl.so3_log(torch.from_numpy(R_gt[k].T) @ res_s.R[k]).numpy()) < 5e-3
        np.testing.assert_allclose(res_s.t[k].numpy(), t_gt[k], atol=2e-2)
        assert np.linalg.norm(tl.so3_log(res_d.R[k].T @ res_s.R[k]).numpy()) < 5e-3
        np.testing.assert_allclose(res_s.t[k].numpy(), res_d.t[k].numpy(), atol=2e-2)
    err_before = np.linalg.norm(np.asarray(prob.Xw) - X_gt, axis=1).mean()
    err_after = np.linalg.norm(res_s.Xw.numpy() - X_gt, axis=1).mean()
    assert err_after < 0.5 * err_before
    assert res_s.obs_inlier.numpy().mean() > 0.95


def test_sparse_ba_respects_fixed_and_invalid():
    prob, _, _, _ = _make_ba_problem(K_n=4)
    obs_valid = np.asarray(prob.obs_valid) & (np.asarray(prob.obs_kf) != 3)
    prob2 = dataclasses.replace(prob, kf_valid=jnp.asarray([True, True, True, False]), obs_valid=jnp.asarray(obs_valid))
    res = tsb.sparse_ba(_port(prob2), iters=8, gate_at=4)
    _close(res, jsb.sparse_ba(prob2, iters=8, gate_at=4))
    R0, t0 = np.asarray(prob.R), np.asarray(prob.t)
    np.testing.assert_allclose(res.R[0].numpy(), R0[0], atol=1e-7)
    np.testing.assert_allclose(res.R[3].numpy(), R0[3], atol=1e-7)
    np.testing.assert_allclose(res.t[3].numpy(), t0[3], atol=1e-7)


def test_sparse_ba_map_scale():
    """tests/test_sparse_ba.py::test_sparse_ba_map_scale at a reduced size."""
    prob, R_gt, t_gt, X_gt = _make_map_scale_problem(K_n=32, L_n=1024, obs_per_kf=320)
    res = tsb.sparse_ba(_port(prob), iters=10, gate_at=5, cg_iters=80)
    _close(res, jsb.sparse_ba(prob, iters=10, gate_at=5, cg_iters=80), tol=2e-3, x_tol=5e-3)
    t_before = np.linalg.norm(np.asarray(prob.t) - t_gt, axis=1).mean()
    assert np.linalg.norm(res.t.numpy() - t_gt, axis=1).mean() < 0.15 * t_before
    x_before = np.linalg.norm(np.asarray(prob.Xw) - X_gt, axis=1).mean()
    assert np.linalg.norm(res.Xw.numpy() - X_gt, axis=1).mean() < 0.4 * x_before
    assert res.obs_inlier.numpy().mean() > 0.95


@pytest.mark.parametrize("iters", [3, 40])
def test_pcg_matches_the_reference(iters):
    rng = np.random.default_rng(iters)
    A = rng.normal(size=(24, 24)).astype(np.float32)
    A = A @ A.T + 24 * np.eye(24, dtype=np.float32)
    b = rng.normal(size=(4, 6)).astype(np.float32)
    P = np.linalg.inv(np.diag(np.diag(A))).astype(np.float32)
    ref = jsb._pcg(lambda x: (jnp.asarray(A) @ x.reshape(-1)).reshape(4, 6), jnp.asarray(b),
                   lambda r: (jnp.asarray(P) @ r.reshape(-1)).reshape(4, 6), iters)
    At, Pt = torch.from_numpy(A), torch.from_numpy(P)
    got = tsb._pcg(lambda x: (At @ x.reshape(-1)).reshape(4, 6), torch.from_numpy(b),
                   lambda r: (Pt @ r.reshape(-1)).reshape(4, 6), iters)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)
    if iters == 40:
        np.testing.assert_allclose(A @ got.numpy().reshape(-1), b.reshape(-1), atol=1e-3)


def _stereo_problem(share=0.6, baseline=0.2):
    """tests/test_optim.py's BA problem with stereo observations: a share of
    the rows carry a right coordinate ur = u - bf/z (centered, with the same
    0.15 px noise as u) from the ground-truth geometry, as a stereo map's
    keyframes do."""
    prob, R_gt, t_gt, X_gt = _make_ba_problem()
    rng = np.random.default_rng(5)
    fx = float(prob.fx)
    bf = baseline * fx
    kf, lm = np.asarray(prob.obs_kf), np.asarray(prob.obs_lm)
    pc = np.einsum("nij,nj->ni", R_gt[kf], X_gt[lm]) + t_gt[kf]
    stereo = rng.random(len(kf)) < share
    uvr = np.asarray(prob.obs_uvr).copy()
    uvr[:, 2] = np.where(stereo, uvr[:, 0] - bf / pc[:, 2] + rng.normal(0, 0.15, len(kf)), 0.0)
    prob = dataclasses.replace(prob, obs_uvr=jnp.asarray(uvr.astype(np.float32)), obs_stereo=jnp.asarray(stereo),
                               bf=jnp.float32(bf))
    return prob, R_gt, t_gt, X_gt


def test_sparse_ba_on_stereo_observations():
    """The visual global BA on a map with stereo observations (the stereo
    slice's loop correction runs it): port against the reference 1e-4 in R,
    t and the cost (1e-3 in Xw), and against the port's local_ba, which
    shares its residual model; the stereo rows make the problem metric."""
    prob, R_gt, t_gt, X_gt = _stereo_problem()
    assert np.asarray(prob.obs_stereo).mean() > 0.5
    p = _port(prob)
    res = tsb.sparse_ba(p, iters=12, gate_at=6, cg_iters=60)
    _close(res, jsb.sparse_ba(prob, iters=12, gate_at=6, cg_iters=60))
    res_d = local_ba(p, iters=12, gate_at=6)
    for k in range(R_gt.shape[0]):
        assert np.linalg.norm(tl.so3_log(res_d.R[k].T @ res.R[k]).numpy()) < 5e-3
        np.testing.assert_allclose(res.t[k].numpy(), res_d.t[k].numpy(), atol=2e-2)
        np.testing.assert_allclose(res.t[k].numpy(), t_gt[k], atol=2e-2)
    err = np.linalg.norm(res.Xw.numpy() - X_gt, axis=1).mean()
    assert err < 0.5 * np.linalg.norm(np.asarray(prob.Xw) - X_gt, axis=1).mean()
