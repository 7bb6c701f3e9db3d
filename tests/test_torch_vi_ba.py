"""Parity of the port's visual-inertial bundle adjustment with the JAX
reference on the CPU: `visual_inertial_ba` (the dense window solver) and
`sparse_vi_ba` (the map-scale PCG-Schur solver) on tests/test_sparse_ba.py's
FullInertialBA problem, with padding rows and with a bias prior, states to
1e-4 and landmarks to 1e-3; the reference's dense-vs-sparse agreement test
mirrored on the port; the sharded form refused by name."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_cpp_fork_tpu.optim import inertial as jvi
from orbslam3_cpp_fork_tpu.optim.sparse_ba import sparse_vi_ba as jsparse
from orbslam3_cpp_fork_tpu_torch import convert
from orbslam3_cpp_fork_tpu_torch.optim import inertial as tvi
from orbslam3_cpp_fork_tpu_torch.optim.sparse_ba import sparse_vi_ba as tsparse

from test_sparse_ba import _make_vi_problem

TOL_STATE = 1e-4  # poses, velocities, biases
TOL_LM = 1e-3  # landmark positions
STATES = ("Rwb", "twb", "vel", "bg", "ba")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small shapes: one intra-op thread is faster than a team that spins
    against the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _problem(variant):
    prob, p, pp, v, vp = _make_vi_problem(pad_obs_to=1024 if variant == "padded" else None)
    if variant == "prior":
        # FullInertialBA at IMU initialization: the bias prior on the newest
        # keyframe, with biases away from zero.
        rng = np.random.default_rng(4)
        K = prob.Rwb.shape[0]
        prob = dataclasses.replace(
            prob, bg=jnp.asarray(rng.normal(0, 0.01, (K, 3)), jnp.float32),
            ba=jnp.asarray(rng.normal(0, 0.05, (K, 3)), jnp.float32),
            prior_kf=jnp.int32(K - 1), prior_g=jnp.float32(1e2), prior_a=jnp.float32(1e5),
        )
    return prob, p, pp, v, vp


def _check(got, ref):
    for k in STATES:
        err = float(np.abs(getattr(got, k).numpy() - np.asarray(getattr(ref, k))).max())
        assert err <= TOL_STATE, (k, err)
    assert float(np.abs(got.Xw.numpy() - np.asarray(ref.Xw)).max()) <= TOL_LM
    assert np.array_equal(got.obs_inlier.numpy(), np.asarray(ref.obs_inlier))


@pytest.mark.parametrize("variant", ["plain", "padded", "prior"])
def test_visual_inertial_ba_matches(variant):
    prob = _problem(variant)[0]
    ref = jvi.visual_inertial_ba(prob, iters=12, gate_at=6)
    _check(tvi.visual_inertial_ba(convert.vi_problem_from_numpy(prob, "cpu"), iters=12, gate_at=6), ref)


@pytest.mark.parametrize("variant", ["plain", "prior"])
def test_sparse_vi_ba_matches(variant):
    prob = _problem(variant)[0]
    ref = jsparse(prob, iters=12, gate_at=6, cg_iters=80)
    _check(tsparse(convert.vi_problem_from_numpy(prob, "cpu"), iters=12, gate_at=6, cg_iters=80), ref)


def test_sparse_vi_ba_matches_dense():
    """tests/test_sparse_ba.py::test_sparse_vi_ba_matches_dense on the port:
    the two solvers agree on the same temporal-window problem, and both pull
    the perturbed window back (LocalInertialBA semantics)."""
    prob, p, pp, v, vp = _make_vi_problem()
    tp = convert.vi_problem_from_numpy(prob, "cpu")
    res_d = tvi.visual_inertial_ba(tp, iters=12, gate_at=6)
    res_s = tsparse(tp, iters=12, gate_at=6, cg_iters=80)
    err_d = np.linalg.norm(res_d.twb.numpy() - p, axis=-1).mean()
    err_s = np.linalg.norm(res_s.twb.numpy() - p, axis=-1).mean()
    err_0 = np.linalg.norm(pp - p, axis=-1).mean()
    assert err_d < 0.4 * err_0 and err_s < 0.4 * err_0, (err_0, err_d, err_s)
    assert abs(err_s - err_d) < 0.5 * err_0 + 5e-3
    assert np.linalg.norm(res_s.twb.numpy() - res_d.twb.numpy(), axis=-1).mean() < 2e-2
    v_err_0 = np.linalg.norm(vp - v, axis=-1).mean()
    for res in (res_d, res_s):
        assert np.linalg.norm(res.vel.numpy() - v, axis=-1).mean() < 0.6 * v_err_0


def test_sharded_vi_ba_is_refused():
    """The sharded solve is ported (tests/test_torch_dist_vi_ba.py); what it
    still refuses, as the reference does, is an observation count that the
    world size does not divide (here 2 ranks and an odd count)."""
    from orbslam3_cpp_fork_tpu_torch.parallel import dist_ba, launch

    tp = convert.vi_problem_from_numpy(_make_vi_problem()[0], "cpu")
    O = tp.obs_kf.shape[0]
    if O % 2 == 0:
        tp = dataclasses.replace(tp, **{k: getattr(tp, k)[:-1] for k in dist_ba.OBS_FIELDS})
    with pytest.raises(ValueError, match="not divisible by world size 2"):
        launch.run_ranks(launch.solve_sharded, 2, [(launch.to_host(tp), dict(iters=2, gate_at=1))], device="cpu")


def test_vi_ba_is_deterministic():
    """Two runs of either solver give the same bits (ordered segment sums)."""
    tp = convert.vi_problem_from_numpy(_problem("prior")[0], "cpu")
    for solve in (lambda: tvi.visual_inertial_ba(tp, iters=6, gate_at=3), lambda: tsparse(tp, iters=6, gate_at=3)):
        a, b = solve(), solve()
        for k in (*STATES, "Xw"):
            assert torch.equal(getattr(a, k), getattr(b, k)), k
