"""Parity of the port's window bundle adjustment (optim/local_ba.py) with
the JAX reference on the CPU: a synthetic window (6 free + 2 fixed
keyframes, 256 landmark slots, 2048 observation slots) with noise on poses
and points goes through both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_cpp_fork_tpu.optim import local_ba as jba
from orbslam3_cpp_fork_tpu.utils import lie as jlie
from orbslam3_cpp_fork_tpu_torch import convert
from orbslam3_cpp_fork_tpu_torch.optim import local_ba as tba

FX, FY = 420.0, 415.0
K_N, L_N, O_N = 8, 256, 2048


def _rot(w):
    return np.asarray(jlie.so3_exp(jnp.asarray(w, jnp.float32)))


def window(seed, n_lm=220, outliers=0.05):
    """A BA problem as a dict of numpy arrays, plus the true poses/points."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 3, n_lm), rng.uniform(-2, 2, n_lm), rng.uniform(4, 9, n_lm)], 1).astype(np.float32)
    Rs = np.stack([_rot([0.0, 0.04 * k, 0.0]) for k in range(K_N)]).astype(np.float32)
    ts = np.stack([[-0.25 * k, 0.02 * k, 0.0] for k in range(K_N)]).astype(np.float32)
    o_kf, o_lm, o_uv, o_s2 = [], [], [], []
    for k in range(K_N):
        pc = X @ Rs[k].T + ts[k]
        uv = np.stack([FX * pc[:, 0] / pc[:, 2], FY * pc[:, 1] / pc[:, 2]], 1)
        seen = (np.abs(uv[:, 0]) < 320) & (np.abs(uv[:, 1]) < 240) & (rng.uniform(size=n_lm) < 0.9)
        lvl = rng.integers(0, 4, n_lm)
        s2 = (1.2 ** (2.0 * lvl)).astype(np.float32)
        uv = uv + rng.normal(0, 0.5, uv.shape) * np.sqrt(s2)[:, None]
        bad = rng.uniform(size=n_lm) < outliers
        uv[bad] += rng.uniform(-40, 40, (int(bad.sum()), 2))
        ids = np.nonzero(seen)[0]
        o_kf += [k] * len(ids)
        o_lm += list(ids)
        o_uv.append(uv[ids])
        o_s2.append(s2[ids])
    n_obs = len(o_kf)
    assert n_obs <= O_N
    pad_o, pad_l = O_N - n_obs, L_N - n_lm
    kf_fixed = np.zeros(K_N, bool)
    kf_fixed[[0, K_N - 1]] = True
    R0 = np.stack([(_rot(rng.normal(0, 0.01, 3)) @ Rs[k]) if not kf_fixed[k] else Rs[k] for k in range(K_N)])
    t0 = ts + (~kf_fixed)[:, None] * rng.normal(0, 0.03, ts.shape)
    d = dict(
        R=R0.astype(np.float32), t=t0.astype(np.float32),
        kf_valid=np.ones(K_N, bool), kf_fixed=kf_fixed,
        Xw=np.concatenate([X + rng.normal(0, 0.05, X.shape), np.zeros((pad_l, 3))]).astype(np.float32),
        lm_valid=np.concatenate([np.ones(n_lm, bool), np.zeros(pad_l, bool)]),
        obs_kf=np.concatenate([o_kf, np.zeros(pad_o)]).astype(np.int32),
        obs_lm=np.concatenate([o_lm, np.zeros(pad_o)]).astype(np.int32),
        obs_uvr=np.concatenate(
            [np.concatenate([np.concatenate(o_uv), np.zeros((n_obs, 1))], 1), np.zeros((pad_o, 3))]
        ).astype(np.float32),
        obs_sigma2=np.concatenate([np.concatenate(o_s2), np.ones(pad_o)]).astype(np.float32),
        obs_stereo=np.zeros(O_N, bool),
        obs_valid=np.concatenate([np.ones(n_obs, bool), np.zeros(pad_o, bool)]),
        fx=np.float32(FX), fy=np.float32(FY), bf=np.float32(0.0),
    )
    return d, Rs, ts, X


def jax_problem(d):
    return jba.BAProblem(**{k: jnp.asarray(v) for k, v in d.items()})


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_inv3x3_sym(seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(50, 3, 3)).astype(np.float32)
    H = A @ A.transpose(0, 2, 1) + 0.5 * np.eye(3, dtype=np.float32)
    ref = np.asarray(jba._inv3x3_sym(jnp.asarray(H)))
    got = tba._inv3x3_sym(torch.from_numpy(H)).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max(), "tolerance: 1e-5 relative"
    assert np.abs(got @ H - np.eye(3)).max() <= 1e-3


@pytest.mark.parametrize("seed,iters", [(0, 6), (1, 6), (2, 10)])
def test_local_ba_matches(seed, iters):
    d, Rs, ts, X = window(seed)
    ref = jba.local_ba(jax_problem(d), iters=iters, gate_at=iters // 2)
    got = tba.local_ba(convert.ba_problem_from_numpy(d, "cpu"), iters=iters, gate_at=iters // 2)
    assert np.abs(got.R.numpy() - np.asarray(ref.R)).max() <= 1e-4, "tolerance: R within 1e-4"
    assert np.abs(got.t.numpy() - np.asarray(ref.t)).max() <= 1e-4, "tolerance: t within 1e-4"
    lv = d["lm_valid"]
    ov = d["obs_valid"]
    n_obs = np.bincount(d["obs_lm"][ov], minlength=L_N)
    n_in = np.bincount(d["obs_lm"][ov & np.asarray(ref.inlier_carry)], minlength=L_N)
    clean = lv & (n_obs >= 4) & (n_in == n_obs)
    dX = np.abs(got.Xw.numpy() - np.asarray(ref.Xw)).max(1)
    assert clean.sum() > 100
    assert dX[clean].max() <= 1e-4, "tolerance: Xw within 1e-4 for landmarks with >= 4 observations, all inliers"
    assert dX[lv].max() <= 1e-3, "tolerance: Xw within 1e-3 for landmarks left with few inlier observations"
    same = np.mean(got.obs_inlier.numpy() == np.asarray(ref.obs_inlier))
    assert same >= 0.99, f"tolerance: obs_inlier equal on >= 99%, got {same}"
    assert abs(float(got.cost) - float(ref.cost)) <= 1e-3 * float(ref.cost), "tolerance: cost 1e-3 relative"
    # The solve moved the free poses towards the truth.
    free = ~d["kf_fixed"]
    assert np.abs(got.t.numpy()[free] - ts[free]).max() < np.abs(d["t"][free] - ts[free]).max()


def test_fixed_keyframes_do_not_move():
    d, *_ = window(3)
    got = tba.local_ba(convert.ba_problem_from_numpy(d, "cpu"), iters=6, gate_at=3)
    fixed = d["kf_fixed"]
    assert np.array_equal(got.R.numpy()[fixed], d["R"][fixed]) or np.abs(got.R.numpy()[fixed] - d["R"][fixed]).max() <= 1e-6, (
        "tolerance: 1e-6 (a zero step still passes through the re-orthonormalization)"
    )
    assert np.array_equal(got.t.numpy()[fixed], d["t"][fixed])
    assert np.abs(got.t.numpy()[~fixed] - d["t"][~fixed]).max() > 1e-4
    pad = ~d["lm_valid"]
    assert np.array_equal(got.Xw.numpy()[pad], d["Xw"][pad])


@pytest.mark.parametrize("seed", [0, 4])
def test_sliced_equals_unsliced_bitwise(seed):
    d, *_ = window(seed)
    p = convert.ba_problem_from_numpy(d, "cpu")
    whole = tba.local_ba(p, iters=6, gate_at=3)
    res = None
    for it0 in (0, 2, 4):
        import dataclasses

        q = p if res is None else dataclasses.replace(p, R=res.R, t=res.t, Xw=res.Xw)
        res = tba.local_ba(
            q, iters=2, gate_at=3, it0=it0,
            inlier0=None if res is None else res.inlier_carry, lam0=None if res is None else res.lam,
        )
    for a, b in ((whole.R, res.R), (whole.t, res.t), (whole.Xw, res.Xw), (whole.obs_inlier, res.obs_inlier)):
        assert torch.equal(a, b), "sliced 2+2+2 equals unsliced bitwise"
    assert torch.equal(whole.lam, res.lam) and torch.equal(whole.cost, res.cost)


def test_all_observations_invalid_is_a_no_op():
    d, *_ = window(5)
    d["obs_valid"][:] = False
    got = tba.local_ba(convert.ba_problem_from_numpy(d, "cpu"), iters=3, gate_at=1)
    assert torch.isfinite(got.R).all() and torch.isfinite(got.Xw).all()
    assert np.abs(got.t.numpy() - d["t"]).max() <= 1e-6 and int(got.obs_inlier.sum()) == 0
