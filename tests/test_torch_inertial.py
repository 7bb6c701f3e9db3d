"""Parity of the port's visual-inertial optimizers (optim/inertial.py) with
the JAX reference on the CPU, on tests/test_inertial.py's exact circle:
the linear alignment, `inertial_init` in its three overloads,
`gravity_seed`, `pose_inertial_optimization` in both variants, the
closed-form edge Jacobians against forward-mode autodiff, and a probe with
a covariance that is not positive definite."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_cpp_fork_tpu.optim import inertial as jvi
from orbslam3_cpp_fork_tpu.optim import residuals as jres
from orbslam3_cpp_fork_tpu.utils import lie as jlie
from orbslam3_cpp_fork_tpu_torch import convert
from orbslam3_cpp_fork_tpu_torch.optim import inertial as tvi
from orbslam3_cpp_fork_tpu_torch.optim import residuals as tres

from test_inertial import G_W, _landmark_obs, circle_state, make_imu_between, make_kf_chain, preintegrate_np

TOL_STATE = 1e-4  # Rwg, scale, biases, velocities, poses
TOL_BIAS = 1e-5  # biases of the pose optimization
TOL_H = 1e-3  # the marginal prior, relative to its largest entry


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small shapes: one intra-op thread is faster than a team that spins
    against the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(*xs):
    out = [torch.from_numpy(np.ascontiguousarray(np.asarray(x))) for x in xs]
    return out if len(out) > 1 else out[0]


def _tpre(pre):
    return convert.preintegrated_from_numpy(convert.preintegrated_to_numpy(pre), "cpu")


def _rot(w):
    return np.asarray(jlie.so3_exp(jnp.asarray(w, jnp.float32)))


def _err(got, ref):
    return float(np.abs(got.numpy().astype(np.float64) - np.asarray(ref, np.float64)).max())


def _init_case(case):
    """Inputs of the three overloads of tests/test_inertial.py and
    tests/test_imu_ladder.py: the full init in a rotated world at 1/2.5
    scale, the bias-only overload with an injected gyro bias, and the
    ScaleRefinement overload on a map 12% too small."""
    n_kf, kf_dt = (10, 0.5) if case != "bias" else (8, 0.5)
    if case == "bias":
        bg_true = np.array([0.02, -0.015, 0.03], np.float32)
        states = [circle_state(0.6 * i * kf_dt) for i in range(n_kf)]
        Rwb = np.stack([s[0] for s in states])
        p = np.stack([s[1] for s in states])
        v = np.stack([s[2] for s in states])
        import jax

        pres = [preintegrate_np(*make_imu_between(i * kf_dt, (i + 1) * kf_dt, bg=bg_true)) for i in range(n_kf - 1)]
        pre = jax.tree.map(lambda *xs: jnp.stack(xs), *pres)
        kw = dict(prior_g=0.0, prior_a=1e5, iters=60, fix_scale=True, fix_gravity=True)
        return Rwb, p, v, pre, kw, bg_true
    Rwb, p, v, pre = make_kf_chain(n_kf=n_kf, kf_dt=kf_dt)
    if case == "full":
        s_true = 2.5
        Rpert = _rot([0.25, -0.4, 0.1])
        Rwb_in = np.einsum("ij,kjl->kil", Rpert, Rwb).astype(np.float32)
        p_in = (p @ Rpert.T / s_true).astype(np.float32)
        v0 = np.gradient(p_in, kf_dt, axis=0).astype(np.float32)
        return Rwb_in, p_in, v0, pre, dict(prior_g=1e2, prior_a=1e5, iters=80), (s_true, Rpert)
    s_true = 1.12
    kw = dict(prior_g=0.0, prior_a=0.0, iters=30, fix_bias=True, fix_vel=True)
    return Rwb, (p / s_true).astype(np.float32), (v / s_true).astype(np.float32), pre, kw, s_true


@pytest.mark.parametrize("case", ["full", "bias", "scale_refinement"])
def test_inertial_init_matches(case):
    """Rwg, scale, biases and velocities to 1e-4 of the reference's, and the
    port's estimate passes the reference test's own bars."""
    Rwb, p, v0, pre, kw, truth = _init_case(case)
    n = len(Rwb)
    ei = np.arange(n - 1)
    extra = dict(bg0=np.zeros(3, np.float32), ba0=np.zeros(3, np.float32)) if case == "scale_refinement" else {}
    pg, pa = kw.pop("prior_g"), kw.pop("prior_a")
    ref = jvi.inertial_init(
        jnp.asarray(Rwb), jnp.asarray(p), jnp.asarray(v0), jnp.asarray(ei, jnp.int32), jnp.asarray(ei + 1, jnp.int32),
        jnp.ones(n - 1, bool), pre, jnp.float32(pg), jnp.float32(pa), **{k: jnp.asarray(x) for k, x in extra.items()},
        **kw,
    )
    got = tvi.inertial_init(
        *_t(Rwb, p, v0), _t(ei), _t(ei + 1), torch.ones(n - 1, dtype=torch.bool), _tpre(pre), pg, pa,
        **{k: _t(x) for k, x in extra.items()}, **kw,
    )
    for k in ("Rwg", "scale", "bg", "ba", "vel"):
        assert _err(getattr(got, k), getattr(ref, k)) <= TOL_STATE, k
    if case == "full":
        s_true, Rpert = truth
        assert abs(float(got.scale) - s_true) / s_true < 0.05
        g_est = got.Rwg.numpy() @ np.array([0.0, 0.0, -1.0])
        assert np.dot(g_est, Rpert @ np.array([0.0, 0.0, -1.0])) > 0.999
    elif case == "bias":
        np.testing.assert_allclose(got.bg.numpy(), truth, atol=3e-3)
    else:
        assert abs(float(got.scale) - truth) < 0.02


def test_linear_init_and_gravity_seed_match():
    """The closed-form alignment (host numpy on both sides) and the gravity
    seed: scale, gravity and velocities to 1e-4."""
    n_kf = 8
    Rwb, p, v, pre = make_kf_chain(n_kf=n_kf, kf_dt=0.4)
    Rpert = _rot([0.3, -0.2, 0.15])
    p_in = (p @ Rpert.T / 4.0).astype(np.float32)
    Rwb_in = np.einsum("ij,kjl->kil", Rpert, Rwb).astype(np.float32)
    ei = np.arange(n_kf - 1)
    s_r, g_r, v_r = jvi.linear_inertial_init(Rwb_in, p_in, ei, ei + 1, pre)
    s_t, g_t, v_t = tvi.linear_inertial_init(_t(Rwb_in), _t(p_in), _t(ei), _t(ei + 1), _tpre(pre))
    assert abs(s_t - s_r) <= TOL_STATE and np.abs(g_t - g_r).max() <= TOL_STATE and np.abs(v_t - v_r).max() <= TOL_STATE
    assert abs(s_t - 4.0) / 4.0 < 0.02
    np.testing.assert_allclose(g_t, Rpert @ G_W, atol=0.15)
    ref = jvi.gravity_seed(jnp.asarray(Rwb_in), jnp.asarray(ei, jnp.int32), jnp.ones(n_kf - 1, bool), pre)
    got = tvi.gravity_seed(_t(Rwb_in), _t(ei), torch.ones(n_kf - 1, dtype=torch.bool), _tpre(pre))
    assert _err(got, ref) <= TOL_STATE


def _pose_problem(anchor_fixed, seed=0):
    """tests/test_inertial.py's pose problem with 10% outlier rows and, for
    the last-frame variant, a perturbed anchor with a seeded marginal
    prior."""
    kf_dt = 0.4
    rng = np.random.default_rng(seed)
    R1, p1, v1, _, _ = circle_state(0.0)
    R2, p2, v2, _, _ = circle_state(0.6 * kf_dt)
    pre = preintegrate_np(*make_imu_between(0.0, kf_dt))
    Xw, uvr, fx, fy = _landmark_obs(R2, p2)
    N = len(Xw)
    bad = rng.uniform(size=N) < 0.1
    uvr[bad, :2] += rng.uniform(-40, 40, (bad.sum(), 2))
    is_st = np.zeros(N, bool)
    R2p = (R2 @ _rot([0.02, -0.03, 0.02])).astype(np.float32)
    p2p = (p2 + np.array([0.05, -0.04, 0.06])).astype(np.float32)
    v2p = (v2 + np.array([0.2, -0.1, 0.15])).astype(np.float32)
    H = None
    if not anchor_fixed:
        A = rng.normal(0, 1, (15, 15))
        H = (A @ A.T * 20.0 + np.eye(15) * 50.0).astype(np.float32)
        R1 = (R1 @ _rot([0.004, 0.0, -0.003])).astype(np.float32)
        p1 = (p1 + np.array([0.01, 0.0, -0.01])).astype(np.float32)
    z = np.zeros(3, np.float32)
    sig = np.full(N, 1.0, np.float32)
    args = (R1, p1, v1, z, z, R2p, p2p, v2p, z, z)
    obs = (Xw, uvr, sig, np.ones(N, bool), is_st)
    return args, pre, obs, (fx, fy), H, (R2, p2, v2)


@pytest.mark.parametrize("anchor_fixed", [True, False])
def test_pose_inertial_optimization_matches(anchor_fixed):
    """Both variants from the same inputs: pose and velocity to 1e-4,
    biases to 1e-5, inliers exact, the marginal prior to 1e-3 relative; and
    the reference test's bars on the port's result."""
    args, pre, obs, (fx, fy), H, (R2, p2, v2) = _pose_problem(anchor_fixed)
    ref = jvi.pose_inertial_optimization(
        *map(jnp.asarray, args), pre, *map(jnp.asarray, obs), jnp.eye(3), jnp.zeros(3), jnp.float32(fx),
        jnp.float32(fy), jnp.float32(0.0), H_prior=None if H is None else jnp.asarray(H), anchor_fixed=anchor_fixed,
    )
    got = tvi.pose_inertial_optimization(
        *_t(*args), _tpre(pre), *_t(*obs), torch.eye(3), torch.zeros(3), fx, fy, 0.0,
        H_prior=None if H is None else _t(H), anchor_fixed=anchor_fixed,
    )
    for k in ("Rwb", "p", "v"):
        assert _err(getattr(got, k), getattr(ref, k)) <= TOL_STATE, k
    for k in ("bg", "ba"):
        assert _err(getattr(got, k), getattr(ref, k)) <= TOL_BIAS, k
    assert np.array_equal(got.inliers.numpy(), np.asarray(ref.inliers))
    Hr = np.asarray(ref.H_marg, np.float64)
    assert _err(got.H_marg, Hr) <= TOL_H * np.abs(Hr).max()
    assert int(got.n_inliers) > 100
    np.testing.assert_allclose(got.Rwb.numpy(), R2, atol=5e-3)
    np.testing.assert_allclose(got.p.numpy(), p2, atol=2e-2)
    assert np.linalg.eigvalsh(got.H_marg.numpy().astype(np.float64)).min() > -1e-3 * np.abs(Hr).max()


def test_closed_form_jacobians_match_autodiff():
    """The closed-form EdgeInertial Jacobians against `torch.func.jacfwd` of
    the residual through the retraction, at seeded states and biases away
    from the linearization point: within 1e-4 of the largest entry."""
    rng = np.random.default_rng(3)
    acc, gyr, dts = make_imu_between(0.0, 0.3)
    bg0 = rng.normal(0, 0.01, 3).astype(np.float32)
    pre = _tpre(preintegrate_np(acc, gyr, dts, bg=bg0))
    E = 4
    st = [torch.from_numpy(x.astype(np.float32)) for x in (
        np.stack([_rot(rng.normal(0, 0.5, 3)) for _ in range(E)]), rng.normal(0, 1, (E, 3)), rng.normal(0, 1, (E, 3)),
        bg0 + rng.normal(0, 0.005, (E, 3)), rng.normal(0, 0.05, (E, 3)),
        np.stack([_rot(rng.normal(0, 0.5, 3)) for _ in range(E)]), rng.normal(0, 1, (E, 3)), rng.normal(0, 1, (E, 3)),
    )]
    preE = pre.map(lambda x: x.expand(E, *x.shape))
    r, J1, J2 = tvi._inertial_jacobians(*st, preE)
    z = torch.zeros((1, 15))
    eye = torch.eye(3)

    def res(d1, d2):
        a = tvi._retract(st[0], st[1], st[2], st[3], st[4], d1)
        b = tvi._retract(st[5], st[6], st[7], st[3], st[4], d2)
        return tvi._inertial_residual_gs(a[0], a[1], a[2], b[0], b[1], b[2], a[3], a[4], preE, eye, 1.0)

    A1 = torch.func.jacfwd(lambda d: res(d, z))(z)[:, :, 0]
    A2 = torch.func.jacfwd(lambda d: res(z, d))(z)[:, :, 0]
    assert torch.allclose(r, res(z, z), atol=1e-6)
    assert (J1 - A1).abs().max() <= 1e-4 * A1.abs().max()
    assert (J2 - A2).abs().max() <= 1e-4 * A2.abs().max()


def test_singular_covariance_probe():
    """A preintegration whose 9x9 covariance is not positive definite: the
    reference's Cholesky and inverse give NaN, and its LM rejects every step;
    the port's `_ex` calls give NaN instead of raising, and it rejects every
    step the same way (the frame state comes back unchanged), and the
    9-dim residual's information is NaN on both sides."""
    args, pre, obs, (fx, fy), _, _ = _pose_problem(True)
    d = convert.preintegrated_to_numpy(pre)
    d["C"][:9, :9] = -np.eye(9, dtype=np.float32)  # not positive definite
    tpre = convert.preintegrated_from_numpy(d, "cpu")
    jpre = type(pre)(**{k: jnp.asarray(v) for k, v in d.items()})
    ref = jvi.pose_inertial_optimization(
        *map(jnp.asarray, args), jpre, *map(jnp.asarray, obs), jnp.eye(3), jnp.zeros(3), jnp.float32(fx),
        jnp.float32(fy), jnp.float32(0.0), anchor_fixed=True,
    )
    got = tvi.pose_inertial_optimization(
        *_t(*args), tpre, *_t(*obs), torch.eye(3), torch.zeros(3), fx, fy, 0.0, anchor_fixed=True,
    )
    for k, i in (("Rwb", 5), ("p", 6), ("v", 7)):
        assert np.array_equal(np.asarray(getattr(ref, k)), args[i]), k
        assert np.array_equal(getattr(got, k).numpy(), args[i]), k
    assert np.isnan(np.asarray(ref.H_marg)).any() and torch.isnan(got.H_marg).any()
    d["C"][:9, :9] = -1e-9 * np.eye(9, dtype=np.float32)  # C + 1e-9 I = 0: singular
    jpre = type(pre)(**{k: jnp.asarray(v) for k, v in d.items()})
    st = args[:3] + args[5:8]
    _, info_r = jres.inertial_residual(*map(jnp.asarray, st[:3]), jnp.zeros(3), jnp.zeros(3),
                                       *map(jnp.asarray, st[3:]), jpre)
    _, info_t = tres.inertial_residual(*_t(*st[:3]), torch.zeros(3), torch.zeros(3), *_t(*st[3:]),
                                       convert.preintegrated_from_numpy(d, "cpu"))
    assert not np.isfinite(np.asarray(info_r)).all()
    assert torch.isnan(info_t).all()


def test_frame_helpers_residuals_and_one_step_match():
    """The body/camera frame helpers, the whitening and walk informations,
    the 9-dim residual with its information, the stereo residual over a body
    pose (mono and stereo rows) and one `integrate` step, on seeded inputs:
    1e-5 of each output's largest entry (the information: 1e-4)."""
    from orbslam3_cpp_fork_tpu.ops import imu as jimu
    from orbslam3_cpp_fork_tpu_torch.ops import imu as timu

    rng = np.random.default_rng(9)
    Rcw, Tbc_R = _rot(rng.normal(0, 0.5, 3)), _rot(rng.normal(0, 0.2, 3))
    tcw, Tbc_t = rng.normal(0, 1, 3).astype(np.float32), rng.normal(0, 0.1, 3).astype(np.float32)
    pre = preintegrate_np(*make_imu_between(0.0, 0.3))
    tpre = _tpre(pre)
    R1, p1, v1, _, _ = circle_state(0.0)
    R2, p2, v2, _, _ = circle_state(0.2)
    bg, ba = rng.normal(0, 0.01, 3).astype(np.float32), rng.normal(0, 0.05, 3).astype(np.float32)
    Xw = rng.normal(0, 3, (32, 3)).astype(np.float32) + np.array([0, 0, 8], np.float32)
    uvr = rng.normal(0, 50, (32, 3)).astype(np.float32)
    pairs = [
        (jvi.cam_to_body(Rcw, tcw, Tbc_R, Tbc_t), tvi.cam_to_body(*_t(Rcw, tcw, Tbc_R, Tbc_t))),
        (jvi.body_to_cam(Rcw, tcw, Tbc_R, Tbc_t), tvi.body_to_cam(*_t(Rcw, tcw, Tbc_R, Tbc_t))),
        (jvi.body_to_cam_frame(jnp.asarray(Tbc_R), jnp.asarray(Tbc_t)), tvi.body_to_cam_frame(*_t(Tbc_R, Tbc_t))),
        ((jvi._edge_sqrt_info(pre),), (tvi._edge_sqrt_info(tpre),)),
        (jvi._walk_infos(pre), tvi._walk_infos(tpre)),
        (jres.inertial_residual(R1, p1, v1, bg, ba, R2, p2, v2, pre)[:1],
         tres.inertial_residual(*_t(R1, p1, v1, bg, ba, R2, p2, v2), tpre)[:1]),
        (jres.stereo_reprojection_body(R2, p2, Xw, uvr, Tbc_R, Tbc_t, 400.0, 410.0, 80.0),
         tres.stereo_reprojection_body(*_t(R2, p2, Xw, uvr, Tbc_R, Tbc_t), 400.0, 410.0, 80.0)),
    ]
    step_r = jimu.integrate(jimu.Preintegrated.identity(jnp.asarray(bg), jnp.asarray(ba)), jnp.asarray([0.1, 0.2, 9.8]),
                            jnp.asarray([0.3, -0.1, 0.2]), jnp.float32(0.005), jnp.bool_(True), jimu.ImuCalib.create(
                                1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0))
    step_t = timu.integrate(timu.Preintegrated.identity(*_t(bg, ba)), torch.tensor([0.1, 0.2, 9.8]),
                            torch.tensor([0.3, -0.1, 0.2]), torch.tensor(0.005),
                            timu.ImuCalib.create(1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0, device="cpu"))
    pairs.append(tuple(zip(*[(getattr(step_r, f), getattr(step_t, f)) for f in convert.PREINT_FIELDS])))
    for refs, gots in pairs:
        for r, g in zip(refs, gots):
            r = np.asarray(r, np.float64)
            assert _err(g, r) <= 1e-5 * max(1.0, float(np.abs(r).max()))
    info_r = np.asarray(jvi._edge_info9(pre), np.float64)
    assert _err(tvi._edge_info9(tpre), info_r) <= 1e-4 * np.abs(info_r).max()
    info_r = np.asarray(jres.inertial_residual(R1, p1, v1, bg, ba, R2, p2, v2, pre)[1], np.float64)
    info_t = tres.inertial_residual(*_t(R1, p1, v1, bg, ba, R2, p2, v2), tpre)[1]
    assert _err(info_t, info_r) <= 1e-4 * np.abs(info_r).max()
