"""Sharded whole-map visual BA over `torch.distributed`
(parallel/dist_ba.py): tests/test_dist_ba.py's cases over 2 and 4 gloo ranks
on the CPU, each rank a spawned process that imports torch and the port only
(parallel/launch.py).

Held, on `_make_ba_problem(K_n=6, L_n=120)` padded to a multiple of 8:
port-sharded against port-local and against the reference's
`sparse_ba_sharded` on conftest's 8-device CPU mesh, within the reference
test's bars (t and R 2e-3, Xw 5e-3; the sums run in another order); every
rank bitwise equal to every other, and a second run bitwise equal to the
first. The map-scale problem (64 keyframes, 2048 landmarks, 256
observations a keyframe) converges sharded and is not pathologically slower
than the local solve (the reference's relative bar). The sharded solve is the
local one bit for bit (the sums' fixed order). `default_group()` is None
without a group; a count the world size does not divide is refused; the
tracker's `_global_ba` on the dry run's map takes the sharded path. One
spawn of 4 ranks serves both rank counts (the 2-rank solves on a subgroup).
"""

import dataclasses
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from orbslam3_cpp_fork_tpu.parallel import dist_ba as jdist
from orbslam3_cpp_fork_tpu_torch import convert
from orbslam3_cpp_fork_tpu_torch.entry import dryrun_map, dryrun_multichip
from orbslam3_cpp_fork_tpu_torch.optim import sparse_ba as tsb
from orbslam3_cpp_fork_tpu_torch.parallel import dist_ba, launch
from orbslam3_cpp_fork_tpu_torch.utils import lie as tl

from test_dist_ba import _pad_obs
from test_optim import _make_ba_problem
from test_sparse_ba import _make_map_scale_problem

SMALL = dict(iters=8, gate_at=4, cg_iters=40)  # tests/test_dist_ba.py's schedules
MAP = dict(iters=8, gate_at=4, cg_iters=60)
TIMED = dict(iters=2, gate_at=1, cg_iters=20)
FIELDS = ("R", "t", "Xw", "cost", "obs_inlier")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small shapes, six test workers: one intra-op thread, as every rank."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(prob):
    d = {f.name: np.asarray(getattr(prob, f.name)) for f in dataclasses.fields(prob)}
    return convert.ba_problem_from_numpy(d, "cpu")


@pytest.fixture(scope="module")
def problems():
    small, _, t_gt, _ = _make_ba_problem(K_n=6, L_n=120)
    small = _pad_obs(small, 8)
    big, _, t_gt_big, _ = _make_map_scale_problem(K_n=64, L_n=2048, obs_per_kf=256)
    big = _pad_obs(big, 8)
    mesh = Mesh(np.array(jax.devices()[:8]), ("obs",))
    p_small, p_big = _port(small), _port(big)
    t0 = time.perf_counter()
    tsb.sparse_ba(p_big, **TIMED)
    local_ms = (time.perf_counter() - t0) * 1e3
    return dict(
        small=p_small, big=p_big, t_gt=t_gt, t_gt_big=t_gt_big, local_ms=local_ms,
        local=tsb.sparse_ba(p_small, **SMALL), ref_sharded=jdist.sparse_ba_sharded(mesh, small, **SMALL),
    )


@pytest.fixture(scope="module")
def four_ranks(problems):
    """One spawn of 4 gloo ranks for both rank counts: per count, the small
    problem twice (a second run), the map-scale one, and the map-scale one
    on the timed schedule; the 2-rank jobs run on ranks 0 and 1."""
    small, big = launch.to_host(problems["small"]), launch.to_host(problems["big"])
    jobs = [job + (n,) for n in (2, 4) for job in ((small, SMALL), (small, SMALL), (big, MAP), (big, TIMED))]
    return launch.run_ranks(launch.solve_sharded, 4, jobs, device="cpu")


@pytest.fixture(params=[2, 4], ids=["2ranks", "4ranks"])
def sharded(request, four_ranks):
    """(n, each of the n ranks' results of its four jobs)."""
    n = request.param
    first = 0 if n == 2 else 4
    return n, [r[first:first + 4] for r in four_ranks[:n]]


def _rot_err(Ra, Rb):
    return float(torch.linalg.norm(tl.so3_log(torch.as_tensor(Ra).transpose(-1, -2) @ torch.as_tensor(Rb)), dim=-1).max())


def _hold(res, ref_R, ref_t, ref_Xw):
    np.testing.assert_allclose(res.t, np.asarray(ref_t), atol=2e-3)
    assert _rot_err(np.asarray(ref_R), res.R) < 2e-3
    np.testing.assert_allclose(res.Xw, np.asarray(ref_Xw), atol=5e-3)


def test_sharded_matches_single_device(problems, sharded):
    _, ranks = sharded
    res, loc = ranks[0][0]["result"], problems["local"]
    _hold(res, loc.R.numpy(), loc.t.numpy(), loc.Xw.numpy())
    # The sums run in one fixed order whatever the split (optim/sparse_ba.py):
    # the sharded solve is the local one, bit for bit.
    for k in FIELDS:
        assert np.array_equal(getattr(res, k), getattr(loc, k).numpy()), k
    # And both solved the problem.
    for k in range(2, 6):
        np.testing.assert_allclose(res.t[k], problems["t_gt"][k], atol=3e-2)


def test_sharded_matches_the_reference_sharded(problems, sharded):
    _, ranks = sharded
    ref = problems["ref_sharded"]
    _hold(ranks[0][0]["result"], ref.R, ref.t, ref.Xw)


def test_ranks_and_runs_are_bitwise_equal(sharded):
    n, ranks = sharded
    for job in range(4):
        # Jobs 0 and 1 are two runs of the same solve.
        first = ranks[0][0 if job < 2 else job]["result"]
        for r in range(n):
            got = ranks[r][job]["result"]
            for k in FIELDS:
                assert np.array_equal(getattr(got, k), getattr(first, k)), (job, r, k)
    # One all-reduce for the inlier mask, one for the final cost, and per LM
    # iteration four plus two per CG iteration.
    it, cg = SMALL["iters"], SMALL["cg_iters"]
    assert ranks[0][0]["all_reduces"] == it * (4 + 2 * cg) + 2


def test_sharded_map_scale_converges_and_scales(problems, sharded):
    _, ranks = sharded
    res = ranks[0][2]["result"]
    t0 = problems["big"].t.numpy()
    t_gt = problems["t_gt_big"]
    before = np.linalg.norm(t0 - t_gt, axis=1).mean()
    after = np.linalg.norm(res.t - t_gt, axis=1).mean()
    assert after < 0.3 * before, (before, after)
    # Relative timing only (the ranks share this host): the sharded solve is
    # not pathologically slower than the local one of the same schedule.
    shard_ms = max(r[3]["ms"] for r in ranks)
    assert shard_ms < 8.0 * problems["local_ms"] + 1000.0, (problems["local_ms"], shard_ms)


def test_default_group_is_none_without_a_group():
    assert not torch.distributed.is_initialized()
    assert dist_ba.default_group() is None


def test_an_indivisible_count_is_refused(problems):
    """The check `shard_problem` makes on every rank before any collective
    (tests/test_torch_vi_ba.py::test_sharded_vi_ba_is_refused sees it raised
    from spawned ranks): a count the world size does not divide, and a world
    size that does not divide the solver's observation chunks."""
    p = problems["small"]
    odd = dataclasses.replace(p, **{k: getattr(p, k)[:-1] for k in dist_ba.OBS_FIELDS})
    assert odd.obs_kf.shape[0] % 2 == 1
    with pytest.raises(ValueError, match="not divisible by world size 2"):
        dist_ba.check_shardable(odd, 2)
    cut = p.obs_kf.shape[0] % 3  # a count 3 ranks divide
    three = dataclasses.replace(p, **{k: getattr(p, k)[:p.obs_kf.shape[0] - cut] for k in dist_ba.OBS_FIELDS})
    with pytest.raises(ValueError, match="world size 3 does not divide the 8 observation chunks"):
        dist_ba.check_shardable(three, 3)
    assert dist_ba.check_shardable(p, 4) == p.obs_kf.shape[0]


def test_global_ba_takes_the_sharded_path():
    """`Tracker._global_ba` on the dry run's map, two ranks: the sharded
    path taken on both (the tracker's count), the ranks bitwise equal, and
    the keyframes where the same tracker's local solve puts them."""
    out = dryrun_multichip(2, device="cpu")
    assert [o["sharded_solves"] for o in out] == [1, 1]
    for k in ("kf_R", "kf_t", "lm_pos", "vi_twb", "vi_Xw"):
        assert np.array_equal(out[0][k], out[1][k]), k
    tr, _, _ = dryrun_map(torch.device("cpu"), 2)
    tr._global_ba(iters=4)
    m = tr.map
    assert tr.n_sharded_solves == 0
    np.testing.assert_allclose(out[0]["kf_t"], m.kf_t[m.kf_valid], atol=2e-3)
    assert _rot_err(m.kf_R[m.kf_valid], out[0]["kf_R"]) < 2e-3
    np.testing.assert_allclose(out[0]["lm_pos"], m.lm_pos[m.lm_valid], atol=5e-3)
