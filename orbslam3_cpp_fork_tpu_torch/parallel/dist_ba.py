"""Distributed bundle adjustment over a `torch.distributed` process group
(port of parallel/dist_ba.py).

The reference shards the observation set of a whole-map BA problem over a
device mesh with `shard_map`, and every normal-equation reduction of the
matrix-free PCG-Schur solver (optim/sparse_ba.py) becomes a `psum` over
the mesh. Its PyTorch counterpart is SPMD over a process group: every rank
calls the same function on the same problem, cuts out its own contiguous
slice of the padded observation rows (rank r takes rows [r*O/n, (r+1)*O/n),
the layout of the reference's P('obs')), and the solver all-reduces its
per-rank sums in the fixed order of optim/sparse_ba.py, so that the sharded
solve computes the local solve's bits. The keyframe and landmark state, the CG
vectors and, for the visual-inertial solve, the inertial chain are
replicated: every rank holds the same values and computes the same update.

Contract: every rank runs the same program on the same input, as
`shard_map` and multi-process JAX do; there is no server rank. The result
is replicated, the observation inlier mask gathered to its full length.
The world size must divide `sparse_ba.CHUNKS` (8) and the observation
count; tests/test_torch_dist_ba.py holds sharded and local solves bit for
bit.

Collectives per LM iteration, each carrying one slot a rank beyond two ranks: one
all-reduce of the normal-equation blocks (K,6,6)+(K,6)+(L,3,3)+(L,3) with
the cost, one of the reduced right-hand side and the preconditioner's
(K,6,6), two per CG iteration ((L,3) and (K,6)), one for the landmark
back-substitution and one for the new cost.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

from ..optim.inertial import VIBAProblem, VIBAResult
from ..optim.local_ba import BAProblem, BAResult
from ..optim.sparse_ba import CHUNKS, _psum, sparse_ba, sparse_vi_ba

OBS_FIELDS = ("obs_kf", "obs_lm", "obs_uvr", "obs_sigma2", "obs_stereo", "obs_valid")


def default_group():
    """The default process group when one is initialized over more than one
    rank (the counterpart of a mesh over every visible device); None
    otherwise."""
    if dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1:
        return dist.group.WORLD
    return None


def _world(group):
    """(group, its size, this rank in it); None means the default group."""
    group = dist.group.WORLD if group is None else group
    return group, dist.get_world_size(group), dist.get_rank(group)


def check_shardable(p, n: int) -> int:
    """The observation count of `p`; a ValueError unless n ranks can shard
    it (n divides the count and the solver's observation chunks)."""
    O = int(p.obs_kf.shape[0])
    if O % n != 0:
        raise ValueError(f"obs count {O} not divisible by world size {n}; pad the problem")
    if CHUNKS % n != 0:
        raise ValueError(f"world size {n} does not divide the {CHUNKS} observation chunks")
    return O


def shard_problem(p: BAProblem | VIBAProblem, group=None) -> BAProblem | VIBAProblem:
    """This rank's shard of problem `p`: its contiguous slice of every
    observation array; the rest shared. The observation count must be
    divisible by the group's size."""
    group, n, r = _world(group)
    s = check_shardable(p, n) // n
    return dataclasses.replace(p, **{k: getattr(p, k)[r * s:(r + 1) * s] for k in OBS_FIELDS})


def _gather_inliers(local: torch.Tensor, group, n: int, r: int) -> torch.Tensor:
    """Every rank's slice of the inlier mask in one (O,) mask on every rank
    (an all-reduce of a zero-filled vector: gloo reduces CUDA tensors, it
    does not gather them)."""
    s = local.shape[0]
    full = torch.zeros(s * n, dtype=torch.int32, device=local.device)
    full[r * s:(r + 1) * s] = local.to(torch.int32)
    return _psum(group, full).bool()


def sparse_ba_sharded(group, p: BAProblem, iters: int = 12, gate_at: int = 6, cg_iters: int = 60) -> BAResult:
    """The sparse PCG-Schur LM solve with the observations sharded over
    `group` (None: the default group). Every rank passes the same problem;
    every rank gets the same result, equal up to the order of the float sums
    to `sparse_ba(p, ...)` on one device."""
    group, n, r = _world(group)
    res = sparse_ba(shard_problem(p, group), iters=iters, gate_at=gate_at, cg_iters=cg_iters, group=group)
    return dataclasses.replace(res, obs_inlier=_gather_inliers(res.obs_inlier, group, n, r))


def sparse_vi_ba_sharded(group, p: VIBAProblem, iters: int = 12, gate_at: int = 6, cg_iters: int = 80) -> VIBAResult:
    """FullInertialBA with the reprojection observations sharded over
    `group` (the visual-inertial counterpart of `sparse_ba_sharded`): each
    rank reduces its shard's normal-equation blocks by all-reduce; the
    inertial chain (O(K) edges, replicated) is computed on every rank
    without a collective."""
    group, n, r = _world(group)
    res = sparse_vi_ba(shard_problem(p, group), iters=iters, gate_at=gate_at, cg_iters=cg_iters, group=group)
    return dataclasses.replace(res, obs_inlier=_gather_inliers(res.obs_inlier, group, n, r))
