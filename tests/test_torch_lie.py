"""The port's Lie groups (utils/lie.py) against the JAX reference: the 13
cases of tests/test_lie.py, each fed the same seeded numpy inputs on both
sides. Tolerance: the port's outputs within 1e-5 (absolute, f32) of the
reference's; each case also keeps the reference test's own property bar on
the port's outputs.
"""

import jax.numpy as jnp
import numpy as np
import torch

from orbslam3_cpp_fork_tpu.utils import lie as jlie
from orbslam3_cpp_fork_tpu_torch.utils import lie as tlie

TOL = 1e-5


def rand_w(rng, n=64, scale=2.0, max_norm=3.0):
    """Random tangents with norm clipped below pi (tests/test_lie.py)."""
    w = rng.normal(size=(n, 3)) * scale
    nrm = np.linalg.norm(w, axis=-1, keepdims=True)
    return np.where(nrm > max_norm, w * (max_norm / nrm), w).astype(np.float32)


def both(name, *args):
    """(port, reference) outputs of lie.<name> as numpy."""
    got = getattr(tlie, name)(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args))
    ref = getattr(jlie, name)(*(jnp.asarray(a) for a in args))
    if isinstance(got, tuple):
        return tuple(g.numpy() for g in got), tuple(np.asarray(r) for r in ref)
    return got.numpy(), np.asarray(ref)


def close(got, ref, tol=TOL):
    if isinstance(got, tuple):
        for g, r in zip(got, ref):
            close(g, r, tol)
        return
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol)


def test_so3_exp_orthonormal():
    w = rand_w(np.random.default_rng(0))
    R, R_ref = both("so3_exp", w)
    close(R, R_ref)
    assert np.abs(R @ np.swapaxes(R, -1, -2) - np.eye(3)).max() < 1e-5
    np.testing.assert_allclose(np.linalg.det(R), 1.0, atol=1e-5)


def test_so3_exp_log_roundtrip():
    w = rand_w(np.random.default_rng(1), scale=1.0)
    R = tlie.so3_exp(torch.from_numpy(w)).numpy()
    w2, w2_ref = both("so3_log", R)
    close(w2, w2_ref)
    np.testing.assert_allclose(w2, w, atol=1e-4)


def test_so3_log_exp_roundtrip_near_pi():
    rng = np.random.default_rng(2)
    axis = rng.normal(size=(32, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    w = (axis * (np.pi - np.abs(rng.normal(size=(32, 1))) * 1e-3)).astype(np.float32)
    R, R_ref = both("so3_exp", w)
    close(R, R_ref)
    w2, w2_ref = both("so3_log", R)
    # Near pi the sign of the tangent is free; compare the rotations.
    R2, R2_ref = both("so3_exp", w2)[0], np.asarray(jlie.so3_exp(jnp.asarray(w2_ref)))
    close(R2, R2_ref)
    np.testing.assert_allclose(R2, R, atol=1e-4)


def test_so3_exp_small_angle():
    w = rand_w(np.random.default_rng(3), scale=1e-6)
    R, R_ref = both("so3_exp", w)
    close(R, R_ref, 1e-9)
    np.testing.assert_allclose(R, np.eye(3) + tlie.hat(torch.from_numpy(w)).numpy(), atol=1e-9)
    w2, w2_ref = both("so3_log", R)
    close(w2, w2_ref, 1e-9)
    np.testing.assert_allclose(w2, w, atol=1e-8)


def test_right_jacobian_identity():
    rng = np.random.default_rng(4)
    w, dw = rand_w(rng, 8, scale=1.0), rand_w(rng, 8, scale=1e-4)
    Jr, Jr_ref = both("so3_right_jacobian", w)
    close(Jr, Jr_ref)
    lhs = tlie.so3_exp(torch.from_numpy(w + dw)).numpy()
    rhs = (tlie.so3_exp(torch.from_numpy(w)) @ tlie.so3_exp(torch.einsum("...ij,...j->...i", torch.from_numpy(Jr),
                                                                          torch.from_numpy(dw)))).numpy()
    np.testing.assert_allclose(lhs, rhs, atol=1e-6)


def test_right_jacobian_inverse():
    w = rand_w(np.random.default_rng(5), 16, scale=1.5)
    J = tlie.so3_right_jacobian(torch.from_numpy(w)).numpy()
    Jinv, Jinv_ref = both("so3_right_jacobian_inv", w)
    close(Jinv, Jinv_ref)
    np.testing.assert_allclose(J @ Jinv, np.broadcast_to(np.eye(3), (16, 3, 3)), atol=1e-4)


def test_quat_roundtrip():
    R = tlie.so3_exp(torch.from_numpy(rand_w(np.random.default_rng(6), scale=2.5))).numpy()
    q, q_ref = both("rot_to_quat", R)
    close(q, q_ref)
    R2, R2_ref = both("quat_to_rot", q)
    close(R2, R2_ref)
    np.testing.assert_allclose(R2, R, atol=1e-5)
    assert np.all(q[..., 3] >= 0)


def test_se3_exp_log_roundtrip():
    rng = np.random.default_rng(7)
    xi = np.concatenate([rng.normal(size=(32, 3)), rand_w(rng, 32, 1.0)], axis=1).astype(np.float32)
    (R, t), ref = both("se3_exp", xi)
    close((R, t), ref)
    xi2, xi2_ref = both("se3_log", R, t)
    close(xi2, xi2_ref)
    np.testing.assert_allclose(xi2, xi, atol=1e-4)


def test_se3_mul_inv():
    xa = np.random.default_rng(8).normal(size=(8, 6)).astype(np.float32)
    (Ra, ta), _ = both("se3_exp", xa)
    (Ri, ti), inv_ref = both("se3_inv", Ra, ta)
    close((Ri, ti), inv_ref)
    (Re, te), mul_ref = both("se3_mul", Ra, ta, Ri, ti)
    close((Re, te), mul_ref)
    np.testing.assert_allclose(Re, np.broadcast_to(np.eye(3), (8, 3, 3)), atol=1e-6)
    np.testing.assert_allclose(te, 0.0, atol=1e-6)
    # The identity the reference's sim3_identity builds on.
    for shape in ((), (5,)):
        (Rid, tid), ref = tlie.se3_identity(shape), jlie.se3_identity(shape)
        assert Rid.shape == (*shape, 3, 3) and tid.shape == (*shape, 3) and Rid.dtype == torch.float32
        assert np.array_equal(Rid.numpy(), np.asarray(ref[0])) and np.array_equal(tid.numpy(), np.asarray(ref[1]))


def test_se3_apply_matches_matrix():
    rng = np.random.default_rng(9)
    xi = rng.normal(size=(6,)).astype(np.float32)
    (R, t), _ = both("se3_exp", xi)
    x = rng.normal(size=(10, 3)).astype(np.float32)
    y, y_ref = both("se3_apply", R, t, x)
    close(y, y_ref)
    np.testing.assert_allclose(y, (R @ x.T).T + t, atol=1e-6)


def test_sim3_exp_log_roundtrip():
    rng = np.random.default_rng(10)
    xi = np.concatenate([rng.normal(size=(32, 3)), rand_w(rng, 32, 0.8, 2.5), rng.normal(size=(32, 1)) * 0.8],
                        axis=1).astype(np.float32)
    (s, R, t), ref = both("sim3_exp", xi)
    # t grows with e^sigma: relative to its size.
    close((s, R), ref[:2])
    np.testing.assert_allclose(t, ref[2], rtol=0, atol=TOL * max(1.0, np.abs(ref[2]).max()))
    xi2, xi2_ref = both("sim3_log", s, R, t)
    close(xi2, xi2_ref)
    np.testing.assert_allclose(xi2, xi, atol=2e-4)


def test_sim3_mul_inv_apply():
    rng = np.random.default_rng(11)
    xi = (rng.normal(size=(8, 7)) * 0.5).astype(np.float32)
    (s, R, t), _ = both("sim3_exp", xi)
    (si, Ri, ti), inv_ref = both("sim3_inv", s, R, t)
    close((si, Ri, ti), inv_ref)
    (se, Re, te), mul_ref = both("sim3_mul", s, R, t, si, Ri, ti)
    close((se, Re, te), mul_ref)
    np.testing.assert_allclose(se, 1.0, atol=1e-5)
    np.testing.assert_allclose(Re, np.broadcast_to(np.eye(3), (8, 3, 3)), atol=1e-5)
    np.testing.assert_allclose(te, 0.0, atol=1e-4)
    x = rng.normal(size=(8, 3)).astype(np.float32)
    y, y_ref = both("sim3_apply", s, R, t, x)
    close(y, y_ref)
    x2 = tlie.sim3_apply(*(torch.from_numpy(a) for a in (si, Ri, ti, y))).numpy()
    np.testing.assert_allclose(x2, x, atol=1e-4)


def test_sim3_reduces_to_se3():
    xi6 = np.random.default_rng(12).normal(size=(16, 6)).astype(np.float32)
    xi7 = np.concatenate([xi6, np.zeros((16, 1), np.float32)], axis=-1)
    (s, R, t), ref = both("sim3_exp", xi7)
    close((s, R, t), ref)
    (R_se3, t_se3), _ = both("se3_exp", xi6)
    np.testing.assert_allclose(s, 1.0, atol=1e-6)
    np.testing.assert_allclose(R, R_se3, atol=1e-5)
    np.testing.assert_allclose(t, t_se3, atol=1e-4)
