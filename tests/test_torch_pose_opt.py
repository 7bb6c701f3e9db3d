"""Parity of the port's motion-only pose optimization, residuals, Lie and
camera helpers with the JAX reference on the CPU (f32 tolerances: the two
sides sum the normal equations in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_cpp_fork_tpu.ops import camera as jcam
from orbslam3_cpp_fork_tpu.optim import pose_opt as jpo
from orbslam3_cpp_fork_tpu.optim import residuals as jres
from orbslam3_cpp_fork_tpu.utils import lie as jlie
from orbslam3_cpp_fork_tpu_torch.ops import camera as tcam
from orbslam3_cpp_fork_tpu_torch.optim import pose_opt as tpo
from orbslam3_cpp_fork_tpu_torch.optim import residuals as tres
from orbslam3_cpp_fork_tpu_torch.utils import lie as tlie

FX, FY = 400.0, 410.0


def _rot(w):
    return np.asarray(jlie.so3_exp(jnp.asarray(w, jnp.float32)))


def _problem(seed, n=300, outliers=0.15, perturb=0.02):
    rng = np.random.default_rng(seed)
    R = _rot(rng.normal(0, 0.3, 3))
    t = rng.normal(0, 0.5, 3).astype(np.float32)
    pc = np.stack([rng.uniform(-4, 4, n), rng.uniform(-3, 3, n), rng.uniform(2, 12, n)], 1)
    Xw = (R.T @ (pc - t).T).T.astype(np.float32)
    uv = np.stack([FX * pc[:, 0] / pc[:, 2], FY * pc[:, 1] / pc[:, 2]], 1)
    lvl = rng.integers(0, 8, n)
    sigma2 = (1.2 ** (2.0 * lvl)).astype(np.float32)
    uv = uv + rng.normal(0, 1.0, (n, 2)) * np.sqrt(sigma2)[:, None]
    bad = rng.uniform(size=n) < outliers
    uv[bad] += rng.uniform(-60, 60, (bad.sum(), 2))
    valid = rng.uniform(size=n) < 0.95
    R0 = (_rot(rng.normal(0, perturb, 3)) @ R).astype(np.float32)
    t0 = (t + rng.normal(0, perturb * 3, 3)).astype(np.float32)
    return R0, t0, Xw, uv.astype(np.float32), sigma2, valid


@pytest.mark.parametrize("seed,rounds,iters", [(0, 4, 3), (1, 4, 2), (2, 4, 10), (3, 2, 3)])
def test_pose_optimization_matches(seed, rounds, iters):
    R0, t0, Xw, uv, s2, valid = _problem(seed)
    ref = jpo.pose_optimization(R0, t0, Xw, uv, s2, valid, FX, FY, rounds=rounds, iters=iters)
    got = tpo.pose_optimization(
        *[torch.from_numpy(x) for x in (R0, t0, Xw, uv, s2, valid)], FX, FY, rounds=rounds, iters=iters
    )
    Rr, tr = np.asarray(ref.R), np.asarray(ref.t)
    assert np.abs(got.R.numpy() - Rr).max() <= 1e-5, "tolerance: R within 1e-5"
    assert np.abs(got.t.numpy() - tr).max() <= 1e-5, "tolerance: t within 1e-5"
    # Inlier masks equal except where chi2 lies within 1e-3 of the threshold.
    pc = Xw @ Rr.T + tr
    proj = np.stack([FX * pc[:, 0] / pc[:, 2], FY * pc[:, 1] / pc[:, 2]], 1)
    chi2 = np.sum((proj - uv) ** 2, 1) / s2
    near = np.abs(chi2 - jres.CHI2_MONO) <= 1e-3
    gi, ri = got.inliers.numpy(), np.asarray(ref.inliers)
    assert np.array_equal(gi[~near], ri[~near]), "tolerance: equal inliers away from the chi2 threshold"
    assert abs(int(got.n_inliers) - int(ref.n_inliers)) <= int(near.sum()), (
        "tolerance: n_inliers differ only by observations within 1e-3 of the chi2 threshold"
    )


def test_pose_optimization_rejects_nonfinite_step():
    # All observations invalid: H is zero, the damped step is 0 and the
    # pose must come back unchanged and finite.
    R0, t0, Xw, uv, s2, _ = _problem(4)
    valid = np.zeros(len(Xw), bool)
    got = tpo.pose_optimization(*[torch.from_numpy(x) for x in (R0, t0, Xw, uv, s2, valid)], FX, FY, rounds=4, iters=2)
    assert np.abs(got.R.numpy() - R0).max() <= 1e-5 and np.abs(got.t.numpy() - t0).max() <= 1e-6, (
        "tolerance: R within 1e-5 (re-orthonormalized), t within 1e-6"
    )
    assert int(got.n_inliers) == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_chol_solve6_matches(seed):
    rng = np.random.default_rng(seed)
    J = rng.normal(0, 1, (50, 6)) * rng.uniform(0.1, 1e3, 6)
    A = (J.T @ J + 1e-3 * np.eye(6)).astype(np.float32)
    b = rng.normal(0, 1, 6).astype(np.float32)
    ref = np.asarray(jax.jit(jpo.chol_solve6)(A, b))
    got, ok = tpo.chol_solve6(torch.from_numpy(A), torch.from_numpy(b))
    assert bool(ok)
    rel = np.abs(got.numpy() - ref) / (np.abs(ref) + 1e-6)
    exact = np.linalg.solve(A.astype(np.float64), b.astype(np.float64))
    assert np.abs(got.numpy() - exact).max() <= 1e-3 * np.abs(exact).max() + 1e-6, "tolerance: 1e-3 relative to f64"
    assert np.abs(got.numpy() - ref).max() <= 1e-3 * np.abs(ref).max() + 1e-6, f"tolerance: 1e-3 relative; {rel.max()}"


def test_lie_matches():
    rng = np.random.default_rng(7)
    w = np.concatenate([rng.normal(0, 1, (50, 3)), rng.normal(0, 1e-6, (5, 3)), np.zeros((1, 3))]).astype(np.float32)
    xi = rng.normal(0, 1, (56, 6)).astype(np.float32)
    tw, txi = torch.from_numpy(w), torch.from_numpy(xi)
    pairs = [
        (tlie.hat(tw), jlie.hat(w), 0.0),
        (tlie.so3_exp(tw), jlie.so3_exp(w), 1e-6),
        (tlie.so3_left_jacobian(tw), jlie.so3_left_jacobian(w), 1e-6),
        (tlie.se3_exp(txi)[0], jlie.se3_exp(xi)[0], 1e-6),
        (tlie.se3_exp(txi)[1], jlie.se3_exp(xi)[1], 1e-5),
    ]
    Rn = (np.asarray(jlie.so3_exp(w)) + rng.normal(0, 1e-3, (56, 3, 3))).astype(np.float32)
    pairs.append((tlie.so3_normalize(torch.from_numpy(Rn)), jlie.so3_normalize(Rn), 1e-6))
    R, t = np.array(jlie.se3_exp(xi)[0]), np.array(jlie.se3_exp(xi)[1])
    TR, Tt = torch.from_numpy(R), torch.from_numpy(t)
    pairs.append((tlie.se3_mul(TR, Tt, TR, Tt)[1], jlie.se3_mul(R, t, R, t)[1], 1e-5))
    pairs.append((tlie.se3_apply(TR, Tt, Tt), jlie.se3_apply(R, t, t), 1e-5))
    for i, (g, r, tol) in enumerate(pairs):
        assert np.abs(g.numpy() - np.asarray(r)).max() <= tol, f"case {i}: tolerance {tol}"


def test_residuals_and_huber_match():
    R0, t0, Xw, uv, s2, _ = _problem(8)
    uvr = np.concatenate([uv, uv[:, :1] - 20.0], 1).astype(np.float32)
    ref = jres.stereo_reprojection(R0, t0, Xw, uvr, FX, FY, 40.0)
    got = tres.stereo_reprojection(*[torch.from_numpy(x) for x in (R0, t0, Xw, uvr)], FX, FY, 40.0)
    for g, r, tol in zip(got, ref, (1e-3, 1e-3, 1e-3, 1e-5)):
        assert np.abs(g.numpy() - np.asarray(r)).max() <= tol * max(1.0, np.abs(np.asarray(r)).max()), (
            f"tolerance: {tol} relative"
        )
    chi2 = np.random.default_rng(9).uniform(0, 20, 100).astype(np.float32)
    assert np.allclose(tres.huber_weight(torch.from_numpy(chi2), 5.991).numpy(),
                       np.asarray(jres.huber_weight(chi2, 5.991)), rtol=1e-6, atol=0), "tolerance: rtol 1e-6"


def test_camera_matches():
    dist = (-0.28, 0.07, 2e-4, -1.8e-5, 0.01)
    jc = jcam.Camera.pinhole(458.6, 457.3, 367.2, 248.4, dist)
    tc = tcam.Camera.pinhole(458.6, 457.3, 367.2, 248.4, dist)
    rng = np.random.default_rng(10)
    pc = np.stack([rng.uniform(-3, 3, 200), rng.uniform(-2, 2, 200), rng.uniform(2, 9, 200)], 1).astype(np.float32)
    uv = rng.uniform([0, 0], [752, 480], (200, 2)).astype(np.float32)
    for d in (True, False):
        r = np.asarray(jcam.project(jc, pc, distort=d))
        g = tcam.project(tc, torch.from_numpy(pc), distort=d).numpy()
        assert np.abs(g - r).max() <= 1e-3, "tolerance: 1e-3 px"
    r = np.asarray(jcam.unproject(jc, uv))
    g = tcam.unproject(tc, torch.from_numpy(uv)).numpy()
    assert np.abs(g - r).max() <= 1e-5, "tolerance: 1e-5 (normalized plane)"
    r = np.asarray(jcam.undistort_points(jc, uv))
    g = tcam.undistort_points(tc, torch.from_numpy(uv)).numpy()
    assert np.abs(g - r).max() <= 1e-3, "tolerance: 1e-3 px"
