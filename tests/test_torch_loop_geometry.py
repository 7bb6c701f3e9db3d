"""The geometry of loop closing and relocalization, port against reference:
SO(3)/SE(3)/Sim(3) logs and exponentials, the PnP, MLPnP and Sim(3) RANSAC
solvers on the same index sets, Sim(3) refinement (the two cases of
tests/test_loop_opt.py) and the essential graph against the reference's
exact-shape `optimize_pose_graph` with 7 and with 4 free dimensions.

Tolerances: Lie maps 2e-5 (f32, branches at 1e-4/1e-5 rad); RANSAC winners
1e-4 in R, t and s with the inlier count exact; MLPnP's 2e-3 with its final
inlier mask exact (its linear solve is the smallest eigenvector of a 12x12
normal matrix summed in f32 in another order, ~1e-3 apart between the two
libraries, and the inlier set of the linear winner, on which the Gauss-Newton
refinement runs, can differ by a point at the margin); Sim(3) refinement 1e-4; pose
graph 1e-4 in s, R, t and 1e-5 relative in the cost.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_cpp_fork_tpu.ops import ransac as jr
from orbslam3_cpp_fork_tpu.optim import pose_graph as jpg
from orbslam3_cpp_fork_tpu.optim import sim3_opt as jso
from orbslam3_cpp_fork_tpu.utils import lie as jl
from orbslam3_cpp_fork_tpu_torch.ops import ransac as tr
from orbslam3_cpp_fork_tpu_torch.optim import pose_graph as tpg
from orbslam3_cpp_fork_tpu_torch.optim import sim3_opt as tso
from orbslam3_cpp_fork_tpu_torch.utils import lie as tl

from test_loop_opt import _circle_poses, _integrate_odometry, _rand_rot


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small shapes, six test workers: one intra-op thread each is faster
    than teams of OpenMP threads spinning against each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x)))


def _n(x):
    return np.asarray(x)


# ----------------------------------------------------------------- Lie maps


@pytest.mark.parametrize("scale", [1e-6, 1e-3, 0.5, 3.0])
def test_lie_logs_and_exps_match_the_reference(scale):
    rng = np.random.default_rng(int(scale * 1e6) % 97)
    xi = (rng.normal(0, scale, (64, 7))).astype(np.float32)
    xi[:, 3:6] = np.clip(xi[:, 3:6], -1.0, 1.0)
    s_j, R_j, t_j = jl.sim3_exp(jnp.asarray(xi))
    s_t, R_t, t_t = tl.sim3_exp(_t(xi))
    for a, b in ((s_t, s_j), (R_t, R_j), (t_t, t_j)):
        np.testing.assert_allclose(a.numpy(), _n(b), atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(
        tl.sim3_log(_t(_n(s_j)), _t(_n(R_j)), _t(_n(t_j))).numpy(), _n(jl.sim3_log(s_j, R_j, t_j)), atol=2e-5,
    )
    # Round trip.
    np.testing.assert_allclose(tl.sim3_log(s_t, R_t, t_t).numpy(), xi, atol=5e-5)
    w = xi[:, 3:6]
    np.testing.assert_allclose(tl.so3_log(tl.so3_exp(_t(w))).numpy(), _n(jl.so3_log(jl.so3_exp(jnp.asarray(w)))), atol=2e-5)
    np.testing.assert_allclose(tl.so3_right_jacobian_inv(_t(w)).numpy(), _n(jl.so3_right_jacobian_inv(jnp.asarray(w))), atol=2e-5)
    R_se, t_se = tl.se3_exp(_t(xi[:, :6]))
    np.testing.assert_allclose(tl.se3_log(R_se, t_se).numpy(), _n(jl.se3_log(*jl.se3_exp(jnp.asarray(xi[:, :6])))), atol=5e-5)
    np.testing.assert_allclose(tl.vee(tl.hat(_t(w))).numpy(), w, atol=0)
    # Composition and inverse.
    S = tl.sim3_mul(s_t, R_t, t_t, *tl.sim3_inv(s_t, R_t, t_t))
    np.testing.assert_allclose(S[0].numpy(), 1.0, atol=1e-5)
    np.testing.assert_allclose(S[1].numpy(), np.broadcast_to(np.eye(3), (64, 3, 3)), atol=1e-5)


def test_so3_log_near_pi_matches_the_reference():
    w = np.array([[np.pi - 1e-4, 0, 0], [0, 0, -(np.pi - 1e-3)], [1.8, 1.8, 0.3]], np.float32)
    np.testing.assert_allclose(tl.so3_log(tl.so3_exp(_t(w))).numpy(), _n(jl.so3_log(jl.so3_exp(jnp.asarray(w)))), atol=2e-4)


# ------------------------------------------------------------------ RANSAC


def _pnp_problem(seed, n=160, outliers=0.25):
    rng = np.random.default_rng(seed)
    K = np.array([[400, 0, 320], [0, 400, 240], [0, 0, 1]], np.float32)
    R = _n(jl.so3_exp(jnp.asarray(rng.normal(0, 0.3, 3).astype(np.float32))))
    t = np.array([0.2, -0.1, 0.4], np.float32)
    Xc = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(4, 9, n)], 1)
    Xw = ((Xc - t) @ R).astype(np.float32)
    uv = (Xc[:, :2] / Xc[:, 2:3]) * 400 + [320, 240] + rng.normal(0, 0.5, (n, 2))
    bad = rng.random(n) < outliers
    uv[bad] += rng.uniform(20, 60, (bad.sum(), 2))
    valid = rng.random(n) > 0.1
    sig2 = (1.2 ** (2 * rng.integers(0, 4, n))).astype(np.float32)
    return Xw, uv.astype(np.float32), valid, K, sig2, R, t


def _ref_idx(key, n_hyp, k, valid):
    return np.asarray(jr._sample_indices(key, n_hyp, k, jnp.asarray(valid)))


@pytest.mark.parametrize("solver", ["pnp", "mlpnp"])
@pytest.mark.parametrize("seed", [0, 1])
def test_pnp_solvers_match_the_reference(solver, seed):
    Xw, uv, valid, K, sig2, R_gt, t_gt = _pnp_problem(seed)
    key = jax.random.PRNGKey(seed)
    idx = _ref_idx(key, 128, 6, valid)
    jfn, tfn = (jr.pnp_ransac, tr.pnp_ransac) if solver == "pnp" else (jr.mlpnp_ransac, tr.mlpnp_ransac)
    ref = jfn(jnp.asarray(Xw), jnp.asarray(uv), jnp.asarray(valid), jnp.asarray(K), key, sigma2=jnp.asarray(sig2))
    got = tfn(_t(Xw), _t(uv), _t(valid), _t(K), _t(idx).long(), sigma2=_t(sig2))
    assert int(got[3]) == int(ref[3]), "tolerance: the inlier count exactly"
    assert np.array_equal(got[2].numpy(), _n(ref[2])) and bool(got[4]) == bool(ref[4])
    tol = 1e-4 if solver == "pnp" else 2e-3
    np.testing.assert_allclose(got[0].numpy(), _n(ref[0]), atol=tol)
    np.testing.assert_allclose(got[1].numpy(), _n(ref[1]), atol=tol)
    assert bool(got[4]) and np.abs(got[0].numpy() - R_gt).max() < 0.02


@pytest.mark.parametrize("fix_scale", [False, True])
def test_horn_and_sim3_ransac_match_the_reference(fix_scale):
    rng = np.random.default_rng(3)
    n = 120
    R = _n(jl.so3_exp(jnp.asarray(rng.normal(0, 0.4, 3).astype(np.float32))))
    s = 1.0 if fix_scale else 1.7
    pa = (rng.uniform(-2, 2, (n, 3)) + [0, 0, 6]).astype(np.float32)
    pb = (s * pa @ R.T + [0.3, -0.2, 0.5] + rng.normal(0, 0.01, (n, 3))).astype(np.float32)
    bad = rng.random(n) < 0.3
    pb[bad] += rng.uniform(1, 3, (bad.sum(), 3)).astype(np.float32)
    valid = rng.random(n) > 0.15
    sj, Rj, tj = jr.horn_sim3(jnp.asarray(pa[:5]), jnp.asarray(pb[:5]), fix_scale)
    st, Rt, tt_ = tr.horn_sim3(_t(pa[:5]), _t(pb[:5]), fix_scale)
    for a, b in ((st, sj), (Rt, Rj), (tt_, tj)):
        np.testing.assert_allclose(a.numpy(), _n(b), atol=1e-4)
    key = jax.random.PRNGKey(11)
    ref = jr.sim3_ransac(jnp.asarray(pa), jnp.asarray(pb), jnp.asarray(valid), key, fix_scale=fix_scale)
    got = tr.sim3_ransac(_t(pa), _t(pb), _t(valid), _t(_ref_idx(key, 128, 3, valid)).long(), fix_scale=fix_scale)
    assert int(got[4]) == int(ref[4]) and np.array_equal(got[3].numpy(), _n(ref[3])), "tolerance: exact"
    for a, b in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(a.numpy(), _n(b), atol=1e-4)
    assert abs(float(got[0]) - s) < 0.01


def test_indices_from_draws_match_the_reference_sampler():
    valid = np.random.default_rng(0).random(300) > 0.6
    key = jax.random.PRNGKey(5)
    raw = np.asarray(jax.random.randint(key, (128, 3), 0, 300))
    got = tr.indices_from_draws(_t(raw), _t(valid)).numpy()
    assert np.array_equal(got, _ref_idx(key, 128, 3, valid)), "tolerance: exact"
    assert valid[got].all()


# ------------------------------------------------------- Sim(3) refinement


def _sim3_problem(seed, N, s_gt, rot, outliers):
    rng = np.random.default_rng(seed)
    R_gt = _rand_rot(rng, rot)
    t_gt = np.array([0.4, -0.2, 0.3], np.float32) if s_gt != 1.0 else np.array([0.1, 0.3, -0.2], np.float32)
    pc2 = np.stack([rng.uniform(-2, 2, N), rng.uniform(-1.5, 1.5, N), rng.uniform(4, 9, N)], 1).astype(np.float32)
    pc1 = (s_gt * pc2 @ R_gt.T + t_gt).astype(np.float32)
    uv1 = 400.0 * pc1[:, :2] / pc1[:, 2:3]
    uv2 = 400.0 * pc2[:, :2] / pc2[:, 2:3]
    if outliers:
        uv1 += rng.normal(0, 0.3, uv1.shape)
        uv2 += rng.normal(0, 0.3, uv2.shape)
        out = rng.random(N) < 0.15
        uv1[out] += rng.uniform(30, 80, (out.sum(), 2))
    return rng, R_gt, t_gt, pc1, pc2, uv1.astype(np.float32), uv2.astype(np.float32)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_optimize_sim3_matches_the_reference(fix_scale):
    """The two cases of tests/test_loop_opt.py: GT recovery with 15%
    outliers, and the frozen scale."""
    N, s_gt = (80, 1.0) if fix_scale else (120, 1.35)
    rng, R_gt, t_gt, pc1, pc2, uv1, uv2 = _sim3_problem(1 if fix_scale else 0, N, s_gt, 0.2 if fix_scale else 0.3,
                                                        not fix_scale)
    dR = _rand_rot(rng, 0.03 if fix_scale else 0.05)
    s0 = 1.0 if fix_scale else s_gt * 1.1
    R0 = (dR @ R_gt).astype(np.float32)
    t0 = (t_gt + (0.1 if fix_scale else 0.2)).astype(np.float32)
    ones = np.ones(N, np.float32)
    ref = jso.optimize_sim3(
        jnp.float32(s0), jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(pc1), jnp.asarray(pc2), jnp.asarray(uv1),
        jnp.asarray(uv2), jnp.asarray(ones), jnp.asarray(ones), jnp.ones(N, bool), 400.0, 400.0, fix_scale=fix_scale,
    )
    got = tso.optimize_sim3(
        torch.tensor(s0, dtype=torch.float32), _t(R0), _t(t0), _t(pc1), _t(pc2), _t(uv1), _t(uv2), _t(ones), _t(ones),
        torch.ones(N, dtype=torch.bool), 400.0, 400.0, fix_scale=fix_scale,
    )
    np.testing.assert_allclose(float(got.s), float(ref.s), atol=1e-4)
    np.testing.assert_allclose(got.R.numpy(), _n(ref.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), _n(ref.t), atol=1e-4)
    assert int(got.n_inliers) == int(ref.n_inliers) and np.array_equal(got.inliers.numpy(), _n(ref.inliers))
    if fix_scale:
        assert abs(float(got.s) - 1.0) < 1e-5
        assert np.linalg.norm(got.t.numpy() - t_gt) < 0.02
    else:
        assert abs(float(got.s) - s_gt) < 0.01
        assert np.degrees(np.linalg.norm(tl.so3_log(got.R @ _t(R_gt).T).numpy())) < 0.5
        assert int(got.n_inliers) > 0.7 * N


# --------------------------------------------------------- Essential graph


def _graph(K, drift_rot, drift_scale, seed, axes, unit_scale):
    R_gt, t_gt = _circle_poses(K)
    s_est, R_est, t_est = _integrate_odometry(R_gt, t_gt, drift_rot, drift_scale, seed=seed, axes=axes)
    if unit_scale:
        s_est[:] = 1.0
    ei, ej, es, eR, et = [], [], [], [], []
    for k in range(1, K):
        sr, Rr, tr_ = jpg.relative_sim3(s_est, R_est, t_est, k - 1, k)
        ei.append(k - 1); ej.append(k); es.append(float(sr)); eR.append(_n(Rr)); et.append(_n(tr_))  # noqa: E702
    sr, Rr, tr_ = jpg.relative_sim3(np.ones(K, np.float32), R_gt, t_gt, K - 1, 0)
    ei.append(K - 1); ej.append(0); es.append(float(sr)); eR.append(_n(Rr)); et.append(_n(tr_))  # noqa: E702
    return (s_est, R_est, t_est, np.ones(K, bool), np.arange(K) == 0, np.asarray(ei, np.int32), np.asarray(ej, np.int32),
            np.asarray(es, np.float32), np.stack(eR).astype(np.float32), np.stack(et).astype(np.float32),
            np.ones(K, np.float32)), R_gt, t_gt


@pytest.mark.parametrize("mode", ["sim3", "4dof"])
def test_pose_graph_matches_the_exact_shape_reference(mode):
    """ROADMAP R4: held against the reference's exact-shape solver (no
    padding), with the gates of tests/test_loop_opt.py."""
    if mode == "sim3":
        args, R_gt, t_gt = _graph(24, 0.01, 0.01, 0, (1, 1, 1), False)
    else:
        args, R_gt, t_gt = _graph(16, 0.012, 0.0, 3, (0, 0, 1), True)
    fd = jpg.FREE_DIMS[mode]
    ref = jpg.optimize_pose_graph(*[jnp.asarray(a) for a in args], jnp.asarray(fd))
    got = tpg.optimize_pose_graph(*[_t(a) for a in args], _t(fd))
    np.testing.assert_allclose(got.s.numpy(), _n(ref.s), atol=1e-4)
    np.testing.assert_allclose(got.R.numpy(), _n(ref.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), _n(ref.t), atol=1e-4)
    np.testing.assert_allclose(float(got.cost), float(ref.cost), rtol=1e-5, atol=1e-9)
    assert float(got.cost) < 1e-2
    c_new = -np.einsum("kji,kj->ki", got.R.numpy(), got.t.numpy()) / got.s.numpy()[:, None]
    c_gt = -np.einsum("kji,kj->ki", R_gt, t_gt)
    c_est = -np.einsum("kji,kj->ki", args[1], args[2]) / args[0][:, None]
    assert np.linalg.norm(c_new - c_gt, axis=1).mean() < 0.75 * np.linalg.norm(c_est - c_gt, axis=1).mean()
    if mode == "4dof":
        assert np.abs(got.s.numpy() - 1.0).max() < 1e-5
        assert np.abs(got.R.numpy()[:, 2, 2] - args[1][:, 2, 2]).max() < 1e-5


def test_batched_jacobian_matches_per_edge_jacfwd():
    rng = np.random.default_rng(2)
    E = 5
    S = [tl.sim3_exp(_t(rng.normal(0, 0.4, (E, 7)).astype(np.float32))) for _ in range(3)]

    def f(delta):
        a = tl.sim3_mul(*S[0], *tl.sim3_exp(delta[:, :7]))
        b = tl.sim3_mul(*S[1], *tl.sim3_exp(delta[:, 7:]))
        return tpg._edge_residual(*a, *b, *S[2])

    x = torch.zeros(E, 14)
    J = tpg._batched_jacobian(f, x)
    for e in range(E):
        Je = torch.func.jacfwd(lambda d: f(torch.cat([x[:e], d[None], x[e + 1:]]))[e])(x[e])
        np.testing.assert_allclose(J[e].numpy(), Je.numpy(), atol=1e-6)
