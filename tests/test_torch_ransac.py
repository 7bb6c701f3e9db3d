"""Parity of the port's two-view reconstruction (ops/ransac.py) with the JAX
reference on the CPU: both sides get the same seeded correspondences and the
same (n_hyp, 8) index sets, drawn by the reference's `_sample_indices`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_cpp_fork_tpu.ops import ransac as jr
from orbslam3_cpp_fork_tpu_torch.ops import ransac as tr

from test_torch_geometry import K, T, two_views

N_HYP = 64


def _pad(x1, x2, cap, seed, outliers=0.2):
    """Fixed-capacity arrays: real matches first, some gross outliers, the
    rest invalid padding."""
    rng = np.random.default_rng(seed)
    n = len(x1)
    bad = rng.uniform(size=n) < outliers
    x2 = x2.copy()
    x2[bad] += rng.uniform(-80, 80, (int(bad.sum()), 2)).astype(np.float32)
    a = np.zeros((cap, 2), np.float32)
    b = np.zeros((cap, 2), np.float32)
    a[:n], b[:n] = x1, x2
    valid = np.zeros(cap, bool)
    valid[:n] = True
    perm = rng.permutation(cap)
    return a[perm], b[perm], valid[perm]


def _both(x1, x2, valid, seed):
    idx = np.asarray(jr._sample_indices(jax.random.PRNGKey(seed), N_HYP, 8, jnp.asarray(valid)))
    ref = jr.reconstruct_two_views(x1, x2, valid, K, jax.random.PRNGKey(seed), n_hyp=N_HYP)
    got = tr.reconstruct_two_views(*T(x1, x2, valid, K, idx.astype(np.int64)))
    return ref, got


@pytest.mark.parametrize("seed", [0, 2, 3, 4])
def test_reconstruct_two_views_matches(seed):
    x1, x2, R, t, _ = two_views(seed, n=220)
    x1, x2, valid = _pad(x1, x2, 300, seed)
    ref, got = _both(x1, x2, valid, seed)
    assert bool(got.success) == bool(ref.success) and bool(ref.success)
    assert np.abs(got.R.numpy() - np.asarray(ref.R)).max() <= 1e-4, "tolerance: R within 1e-4"
    tg_, tr_ = got.t.numpy(), np.asarray(ref.t)
    assert np.abs(tg_ / np.linalg.norm(tg_) - tr_ / np.linalg.norm(tr_)).max() <= 1e-4, "tolerance: t direction 1e-4"
    same = np.mean(got.good.numpy() == np.asarray(ref.good))
    assert same >= 0.99, f"tolerance: good equal on >= 99% of slots, got {same}"
    assert abs(float(got.parallax) - float(ref.parallax)) <= 1e-3, "tolerance: parallax 1e-3 deg"
    g = got.good.numpy() & np.asarray(ref.good)
    assert np.abs(got.points.numpy()[g] - np.asarray(ref.points)[g]).max() <= 1e-3, "tolerance: points 1e-3"
    # And the motion is the true one.
    assert np.abs(got.R.numpy() - R).max() <= 2e-2
    assert np.abs(tg_ / np.linalg.norm(tg_) - t / np.linalg.norm(t)).max() <= 5e-2


@pytest.mark.parametrize("seed", [5, 9])
def test_planar_scene(seed):
    """A planar scene through the whole solver. With the reference's RH > 0.5
    rule a noisy plane scores RH ~ 0.49 (F explains planar data as well as H
    and is scored on a 1-dof residual), so both sides stay on the F branch
    and, two motions being nearly equally good, neither claims success; the
    H branch itself is held by test_faugeras_solutions_match."""
    x1, x2, R, t, _ = two_views(seed, n=220, planar=True)
    x1, x2, valid = _pad(x1, x2, 300, seed, outliers=0.1)
    ref, got = _both(x1, x2, valid, seed)
    assert bool(got.success) == bool(ref.success)
    assert np.abs(got.R.numpy() - np.asarray(ref.R)).max() <= 1e-3, "tolerance: R within 1e-3"
    assert np.abs(got.t.numpy() - np.asarray(ref.t)).max() <= 1e-3, "tolerance: t within 1e-3"
    assert np.mean(got.good.numpy() == np.asarray(ref.good)) >= 0.99
    assert np.abs(got.R.numpy() - R).max() <= 0.1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_faugeras_solutions_match(seed):
    """The H branch: the 8 (R, t) candidates of a plane-induced homography
    agree with the reference's as a set, and the true motion is among them."""
    rng = np.random.default_rng(seed)
    _, _, R, t, _ = two_views(seed)
    n = rng.normal(0, 0.1, 3) + np.array([0.0, 0.0, 1.0])
    n /= np.linalg.norm(n)
    H = (K @ (R + np.outer(t, n) / 5.0) @ np.linalg.inv(K)).astype(np.float32)
    Rr, tr_ = [np.asarray(v) for v in jr._faugeras_solutions(jnp.asarray(H), jnp.asarray(K))]
    Rg, tg_ = [v.numpy() for v in tr._faugeras_solutions(*T(H, K))]
    assert Rg.shape == (8, 3, 3) and tg_.shape == (8, 3)
    for i in range(8):
        # SVD sign choices permute the candidates and flip t together with n.
        d = [max(np.abs(Rg[i] - Rr[j]).max(), min(np.abs(tg_[i] - tr_[j]).max(), np.abs(tg_[i] + tr_[j]).max()))
             for j in range(8)]
        assert min(d) <= 1e-3, f"tolerance: each candidate within 1e-3 of a reference candidate, got {min(d)}"
    tn = t / np.linalg.norm(t)
    assert min(max(np.abs(Rg[i] - R).max(), np.abs(tg_[i] - tn).max()) for i in range(8)) <= 1e-2


def test_zero_baseline_must_not_succeed():
    x1, x2, *_ = two_views(6, n=220, baseline=0.0)
    x2 = x1 + np.random.default_rng(6).normal(0, 0.3, x1.shape).astype(np.float32)
    x1, x2, valid = _pad(x1, x2, 300, 6, outliers=0.0)
    ref, got = _both(x1, x2, valid, 6)
    assert not bool(ref.success) and not bool(got.success)
    assert torch.isfinite(got.R).all() and torch.isfinite(got.parallax)


def test_fewer_than_8_valid_matches():
    x1, x2, *_ = two_views(7, n=5)
    x1, x2, valid = _pad(x1, x2, 64, 7, outliers=0.0)
    ref, got = _both(x1, x2, valid, 7)
    assert not bool(ref.success) and not bool(got.success)


@pytest.mark.parametrize("fill", [3, 20, 64])
def test_port_sampler_draws_valid_slots_and_is_reproducible(fill):
    valid = np.zeros(64, bool)
    valid[np.random.default_rng(fill).choice(64, fill, replace=False)] = True
    v = torch.from_numpy(valid)
    a = tr.sample_indices(torch.Generator().manual_seed(5), 32, 8, v)
    b = tr.sample_indices(torch.Generator().manual_seed(5), 32, 8, v)
    c = tr.sample_indices(torch.Generator().manual_seed(6), 32, 8, v)
    assert a.shape == (32, 8) and torch.equal(a, b) and not torch.equal(a, c)
    assert bool(v[a].all()), "only valid slots are drawn"
    assert len(torch.unique(a)) > min(fill, 8) // 2, "the draw spreads over the valid slots"
    # Same rule as the reference: positions modulo the valid count through
    # the valid-first stable permutation.
    order = np.argsort(~valid, kind="stable")
    raw = torch.randint(0, 64, (32, 8), generator=torch.Generator().manual_seed(5)).numpy()
    assert np.array_equal(a.numpy(), order[raw % fill])
