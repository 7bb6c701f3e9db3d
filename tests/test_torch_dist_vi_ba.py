"""Sharded visual-inertial whole-map BA over `torch.distributed`
(parallel/dist_ba.py: `sparse_vi_ba_sharded`): tests/test_dist_ba.py's
visual-inertial case over 2 and 4 gloo ranks on the CPU.

Held, on `_make_vi_problem` padded to a multiple of 8: port-sharded against
port-local and against the reference's `sparse_vi_ba_sharded` on conftest's
8-device CPU mesh within the reference test's bars (twb and Xw 5e-3); every
rank bitwise equal to every other, a second run bitwise equal to the first,
and the local solve's bits (the fixed order of the sums); the perturbed
positions pulled back (the reference's bar). One spawn of 4 ranks serves
both rank counts. The inertial
chain is replicated: its cost and blocks are computed on every rank without
a collective, so the all-reduces a solve are those of the visual solver.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from orbslam3_cpp_fork_tpu.parallel import dist_ba as jdist
from orbslam3_cpp_fork_tpu_torch import convert
from orbslam3_cpp_fork_tpu_torch.optim.sparse_ba import sparse_vi_ba
from orbslam3_cpp_fork_tpu_torch.parallel import launch

from test_sparse_ba import _make_vi_problem

SCHEDULE = dict(iters=8, gate_at=4, cg_iters=60)  # tests/test_dist_ba.py's
FIELDS = ("Rwb", "twb", "vel", "bg", "ba", "Xw", "cost", "obs_inlier")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem():
    prob = _make_vi_problem(pad_obs_to=None)[0]
    pad_to = -(-int(prob.obs_kf.shape[0]) // 8) * 8
    prob, p_gt, p_perturbed, _, _ = _make_vi_problem(pad_obs_to=pad_to)
    mesh = Mesh(np.array(jax.devices()[:8]), ("obs",))
    tp = convert.vi_problem_from_numpy(prob, "cpu")
    return dict(
        port=tp, p_gt=p_gt, p_perturbed=p_perturbed, local=sparse_vi_ba(tp, **SCHEDULE),
        ref_sharded=jdist.sparse_vi_ba_sharded(mesh, prob, **SCHEDULE),
    )


@pytest.fixture(scope="module")
def four_ranks(problem):
    """One spawn of 4 gloo ranks: two runs over ranks 0 and 1, then two over
    all four."""
    host = launch.to_host(problem["port"])
    return launch.run_ranks(launch.solve_sharded, 4, [(host, SCHEDULE, n) for n in (2, 2, 4, 4)], device="cpu")


@pytest.fixture(params=[2, 4], ids=["2ranks", "4ranks"])
def sharded(request, four_ranks):
    """(n, each of the n ranks' two runs)."""
    n = request.param
    first = 0 if n == 2 else 2
    return n, [r[first:first + 2] for r in four_ranks[:n]]


def test_vi_sharded_matches_single_device(problem, sharded):
    _, ranks = sharded
    res, loc = ranks[0][0]["result"], problem["local"]
    np.testing.assert_allclose(res.twb, loc.twb.numpy(), rtol=0, atol=5e-3)
    np.testing.assert_allclose(res.Xw, loc.Xw.numpy(), rtol=0, atol=5e-3)
    for k in FIELDS:  # the fixed order of the sums: bit for bit
        assert np.array_equal(getattr(res, k), getattr(loc, k).numpy()), k
    # And it solved the problem.
    err_s = np.linalg.norm(res.twb - problem["p_gt"], axis=-1).mean()
    err_0 = np.linalg.norm(problem["p_perturbed"] - problem["p_gt"], axis=-1).mean()
    assert err_s < 0.5 * err_0, (err_0, err_s)


def test_vi_sharded_matches_the_reference_sharded(problem, sharded):
    _, ranks = sharded
    res, ref = ranks[0][0]["result"], problem["ref_sharded"]
    np.testing.assert_allclose(res.twb, np.asarray(ref.twb), rtol=0, atol=5e-3)
    np.testing.assert_allclose(res.Xw, np.asarray(ref.Xw), rtol=0, atol=5e-3)


def test_vi_ranks_and_runs_are_bitwise_equal(sharded):
    n, ranks = sharded
    first = ranks[0][0]["result"]
    for r in range(n):
        for run in range(2):
            got = ranks[r][run]["result"]
            for k in FIELDS:
                assert np.array_equal(getattr(got, k), getattr(first, k)), (r, run, k)
    # Per LM iteration: the blocks, the reduced right-hand side with the
    # preconditioner, two per CG iteration, the back-substitution and the
    # new cost; the initial, post-gate and final costs; the inlier mask.
    it, cg = SCHEDULE["iters"], SCHEDULE["cg_iters"]
    assert ranks[0][0]["all_reduces"] == it * (4 + 2 * cg) + 4
