"""Parity of the port's multi-view geometry (ops/geometry.py) with the JAX
reference on the CPU, same seeded numpy inputs on both sides. Singular
vectors are defined up to sign, so F and H are compared after normalizing
scale and sign; everything else within the f32 tolerance stated."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_cpp_fork_tpu.ops import geometry as jg
from orbslam3_cpp_fork_tpu.utils import lie as jlie
from orbslam3_cpp_fork_tpu_torch.ops import geometry as tg

K = np.array([[420.0, 0.0, 320.0], [0.0, 415.0, 240.0], [0.0, 0.0, 1.0]], np.float32)


def T(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


def _rot(w):
    return np.asarray(jlie.so3_exp(jnp.asarray(w, jnp.float32)))


def two_views(seed, n=200, noise=0.3, planar=False, baseline=0.4):
    """Pixels of n points in two views; returns x1, x2, R21, t21, X (cam 1)."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 8, n)], 1)
    if planar:
        X[:, 2] = 5.0 + 0.1 * X[:, 0]
    R = _rot(rng.normal(0, 0.05, 3))
    t = np.array([baseline, 0.05, 0.02]) * np.sign(rng.normal(size=3) + 3)
    X2 = X @ R.T + t
    x1 = (X / X[:, 2:]) @ K.T
    x2 = (X2 / X2[:, 2:]) @ K.T
    x1 = x1[:, :2] + rng.normal(0, noise, (n, 2))
    x2 = x2[:, :2] + rng.normal(0, noise, (n, 2))
    return x1.astype(np.float32), x2.astype(np.float32), R.astype(np.float32), t.astype(np.float32), X.astype(np.float32)


def unit_signed(M):
    """Scale to unit Frobenius norm, sign so that the largest entry is > 0."""
    M = np.asarray(M, np.float64)
    M = M / np.linalg.norm(M, axis=(-2, -1), keepdims=True)
    flat = M.reshape(*M.shape[:-2], 9)
    big = np.take_along_axis(flat, np.abs(flat).argmax(-1)[..., None], -1)
    return M * np.sign(big)[..., None]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_triangulate_dlt(seed):
    x1, x2, R, t, X = two_views(seed, noise=0.0)
    P1 = K @ np.concatenate([np.eye(3, dtype=np.float32), np.zeros((3, 1), np.float32)], 1)
    P2 = K @ np.concatenate([R, t[:, None]], 1)
    n = len(x1)
    ref = np.asarray(jg.triangulate_dlt(np.broadcast_to(P1, (n, 3, 4)), np.broadcast_to(P2, (n, 3, 4)), x1, x2))
    got = tg.triangulate_dlt(*T(P1, P2, x1, x2)).numpy()
    assert np.abs(got - ref).max() <= 1e-4 * np.abs(ref).max(), "tolerance: 1e-4 relative"
    assert np.abs(got - X).max() <= 2e-2, "noise-free points are recovered"


def test_projection_and_fundamental_from_poses():
    rng = np.random.default_rng(3)
    R1, R2 = _rot(rng.normal(0, 0.2, 3)), _rot(rng.normal(0, 0.2, 3))
    t1, t2 = rng.normal(0, 0.5, 3).astype(np.float32), rng.normal(0, 0.5, 3).astype(np.float32)
    ref_p = np.asarray(jg.projection_matrix(K, R1, t1))
    assert np.abs(tg.projection_matrix(*T(K, R1, t1)).numpy() - ref_p).max() <= 1e-4, "tolerance: 1e-4"
    ref = np.asarray(jg.fundamental_from_poses(R1, t1, R2, t2, K, K))
    got = tg.fundamental_from_poses(*T(R1, t1, R2, t2, K, K)).numpy()
    assert np.abs(got - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max()), "tolerance: 1e-4"
    # Batched over a leading dimension, as the mapping programs use it.
    R2s, t2s = np.stack([R2, R1]), np.stack([t2, t1 + 0.3])
    got_b = tg.fundamental_from_poses(*T(R1, t1, R2s, t2s, K, K)).numpy()
    assert np.abs(got_b[0] - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max())


@pytest.mark.parametrize("seed", [0, 1])
def test_normalize_points(seed):
    x1, _, _, _, _ = two_views(seed)
    valid = np.random.default_rng(seed).uniform(size=len(x1)) < 0.8
    rx, rT = jg.normalize_points(x1, valid)
    gx, gT = tg.normalize_points(*T(x1, valid))
    assert np.abs(gx.numpy() - np.asarray(rx)).max() <= 1e-4, "tolerance: 1e-4"
    assert np.abs(gT.numpy() - np.asarray(rT)).max() <= 1e-4, "tolerance: 1e-4"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fundamental_8pt_batched(seed):
    x1, x2, *_ = two_views(seed, noise=0.0)
    v = np.ones(len(x1), bool)
    x1n, x2n = np.asarray(jg.normalize_points(x1, v)[0]), np.asarray(jg.normalize_points(x2, v)[0])
    # Distinct indices per set: a repeated point leaves a 2-dim null space, whose basis is arbitrary.
    idx = np.stack([np.random.default_rng(seed + 10 * j).permutation(len(x1))[:8] for j in range(16)])
    ref = np.asarray(jax.vmap(jg.fundamental_8pt)(x1n[idx], x2n[idx]))
    got = tg.fundamental_8pt(*T(x1n[idx], x2n[idx])).numpy()
    assert got.shape == (16, 3, 3)
    err = np.abs(unit_signed(got) - unit_signed(ref)).reshape(16, -1).max(1)
    # An ill-conditioned minimal set amplifies the f32 rounding of either SVD.
    assert np.sum(err <= 1e-4) >= 14 and err.max() <= 1e-3, (
        "tolerance: 1e-4 up to sign and scale on >= 14 of 16 sets, 1e-3 on all"
    )
    assert np.abs(np.linalg.det(unit_signed(got))).max() <= 1e-4, "rank 2"


@pytest.mark.parametrize("seed", [0, 1])
def test_weighted_fits(seed):
    x1, x2, *_ = two_views(seed, planar=True)
    v = np.ones(len(x1), bool)
    x1n, x2n = np.asarray(jg.normalize_points(x1, v)[0]), np.asarray(jg.normalize_points(x2, v)[0])
    w = (np.random.default_rng(seed).uniform(size=len(x1)) < 0.7).astype(np.float32)
    ref_h = np.asarray(jg.homography_weighted(x1n, x2n, w))
    got_h = tg.homography_weighted(*T(x1n, x2n, w)).numpy()
    assert np.abs(unit_signed(got_h) - unit_signed(ref_h)).max() <= 1e-4, "tolerance: 1e-4 up to sign and scale"
    x1, x2, *_ = two_views(seed)
    x1n, x2n = np.asarray(jg.normalize_points(x1, v)[0]), np.asarray(jg.normalize_points(x2, v)[0])
    ref_f = np.asarray(jg.fundamental_weighted(x1n, x2n, w))
    got_f = tg.fundamental_weighted(*T(x1n, x2n, w)).numpy()
    assert np.abs(unit_signed(got_f) - unit_signed(ref_f)).max() <= 1e-4, "tolerance: 1e-4 up to sign and scale"


@pytest.mark.parametrize("seed", [0, 1])
def test_homography_dlt_batched(seed):
    x1, x2, *_ = two_views(seed, noise=0.0, planar=True)
    v = np.ones(len(x1), bool)
    x1n, x2n = np.asarray(jg.normalize_points(x1, v)[0]), np.asarray(jg.normalize_points(x2, v)[0])
    # Distinct indices per set: a repeated point leaves a 2-dim null space, whose basis is arbitrary.
    idx = np.stack([np.random.default_rng(seed + 10 * j).permutation(len(x1))[:8] for j in range(16)])
    ref = np.asarray(jax.vmap(jg.homography_dlt)(x1n[idx], x2n[idx]))
    got = tg.homography_dlt(*T(x1n[idx], x2n[idx])).numpy()
    err = np.abs(unit_signed(got) - unit_signed(ref)).reshape(16, -1).max(1)
    assert np.sum(err <= 1e-4) >= 14 and err.max() <= 1e-3, (
        "tolerance: 1e-4 up to sign and scale on >= 14 of 16 sets, 1e-3 on all"
    )


def test_error_functions():
    x1, x2, R, t, _ = two_views(4, planar=True)
    F = np.linalg.inv(K).T @ np.asarray(jlie.hat(jnp.asarray(t))) @ R @ np.linalg.inv(K)
    F = (F / np.linalg.norm(F)).astype(np.float32)
    re1, re2 = jg.epipolar_sq_errors(F, x1, x2)
    ge1, ge2 = tg.epipolar_sq_errors(*T(F, x1, x2))
    for g, r in ((ge1, re1), (ge2, re2)):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= 1e-4 * max(1.0, r.max()), "tolerance: 1e-4 relative"
    # Batched F: (2,3,3) -> (2,N)
    gb1, _ = tg.epipolar_sq_errors(*T(np.stack([F, 2 * F]), x1, x2))
    assert gb1.shape == (2, len(x1)) and np.abs(gb1[0].numpy() - np.asarray(re1)).max() <= 1e-4 * max(1.0, np.asarray(re1).max())
    H = np.asarray(jg.homography_dlt(x1[:12], x2[:12]))
    H = (H / H[2, 2]).astype(np.float32)
    rh1, rh2 = jg.homography_sq_errors(H, x1, x2)
    gh1, gh2 = tg.homography_sq_errors(*T(H, x1, x2))
    for g, r in ((gh1, rh1), (gh2, rh2)):
        r = np.asarray(r)
        assert np.abs(g.numpy() - r).max() <= 1e-3 * max(1.0, r.max()), "tolerance: 1e-3 relative (H is inverted in f32)"


@pytest.mark.parametrize("seed", [0, 1])
def test_decompose_essential(seed):
    _, _, R, t, _ = two_views(seed)
    E = (np.asarray(jlie.hat(jnp.asarray(t))) @ R).astype(np.float32)
    ref = [np.asarray(x) for x in jg.decompose_essential(E)]
    got = [x.numpy() for x in tg.decompose_essential(*T(E))]
    # The two rotations may come out swapped and t negated (SVD sign).
    for g in got[:2]:
        assert min(np.abs(g - ref[0]).max(), np.abs(g - ref[1]).max()) <= 1e-4, "tolerance: 1e-4 as a set"
        assert abs(np.linalg.det(g) - 1) <= 1e-4
    assert min(np.abs(got[2] - ref[2]).max(), np.abs(got[2] + ref[2]).max()) <= 1e-4, "tolerance: 1e-4 up to sign"


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_check_rt(seed):
    x1, x2, R, t, _ = two_views(seed)
    valid = np.random.default_rng(seed).uniform(size=len(x1)) < 0.9
    tn = (t / np.linalg.norm(t)).astype(np.float32)
    cands = [(R, tn), (R, -tn), (R.T.copy(), tn)]
    outs = tg.check_rt(*T(np.stack([c[0] for c in cands]), np.stack([c[1] for c in cands]), x1, x2, K, valid), 4.0)
    for j, (Rc, tc) in enumerate(cands):
        n_ref, good_ref, par_ref, X_ref = [np.asarray(v) for v in jg.check_rt(Rc, tc, x1, x2, K, valid, 4.0)]
        n, good, par, X = [v[j].numpy() for v in outs]
        assert int(n) == int(n_ref), "counts equal"
        assert np.array_equal(good, good_ref)
        if j:  # a wrong motion's few "good" points are ill-conditioned: counts and masks only
            continue
        g = good_ref
        assert np.abs(X[g] - X_ref[g]).max() <= 1e-4 * np.abs(X_ref[g]).max(), "tolerance: points 1e-4 relative"
        assert np.abs(par[g] - par_ref[g]).max() <= 1e-2, "tolerance: parallax 1e-2 deg (acos near 1 in f32)"
    assert int(outs[0][0]) > 100 and int(outs[0][1]) == 0, "the true motion wins, its mirror has no point in front"
