"""Parity of the port's Hamming matching with the JAX reference
(ops/matching.py) on the CPU: distances are integers and argmin takes the
first index, so every comparison here is exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_cpp_fork_tpu.ops import matching as jm
from orbslam3_cpp_fork_tpu_torch.ops import matching as tm
from orbslam3_cpp_fork_tpu_torch.ops import orb as torb


def _bits(n, seed, base=None, flips=0):
    rng = np.random.default_rng(seed)
    if base is None:
        return rng.integers(0, 2, (n, 256)).astype(np.int8)
    b = base[rng.integers(0, len(base), n)].copy()
    for row in b:
        row[rng.choice(256, flips, replace=False)] ^= 1
    return b


@pytest.mark.parametrize("n,m,seed", [(64, 90, 0), (256, 300, 1), (1, 7, 2)])
def test_hamming_matrix_exact(n, m, seed):
    a, b = _bits(n, seed), _bits(m, seed + 100)
    ref = np.asarray(jm.hamming_matrix(jnp.asarray(a), jnp.asarray(b)))
    got = tm.hamming_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert got.dtype == np.int32
    assert np.array_equal(got, ref), "tolerance: exact integer distances"


def test_popcount_hamming_exact():
    a, b = _bits(40, 3), _bits(50, 4)
    wa = np.packbits(a.astype(np.uint8), axis=-1, bitorder="little").view(np.uint32)
    wb = np.packbits(b.astype(np.uint8), axis=-1, bitorder="little").view(np.uint32)
    ref = np.asarray(jm.popcount_hamming(jnp.asarray(wa), jnp.asarray(wb)))
    got = tm.popcount_hamming(
        torch.from_numpy(wa.astype(np.int64)), torch.from_numpy(wb.astype(np.int64))
    ).numpy()
    assert np.array_equal(got, ref), "tolerance: exact"
    assert np.array_equal(got, tm.hamming_matrix(torch.from_numpy(a), torch.from_numpy(b)).numpy())


def _problem(seed, n=200, m=300):
    """Map bits that are noisy copies of frame bits (so matches exist),
    duplicates (distance ties), projected positions and levels."""
    rng = np.random.default_rng(seed)
    fb = _bits(m, seed)
    fb[5] = fb[6]  # identical frame descriptors: ties in the column direction
    mb = _bits(n, seed + 1, base=fb, flips=20)
    mb[10] = mb[11]  # identical map descriptors: ties in the row direction
    uv = rng.uniform(0, 320, (n, 2)).astype(np.float32)
    xy = rng.uniform(0, 320, (m, 2)).astype(np.float32)
    lvl_m = rng.integers(0, 8, n).astype(np.int32)
    lvl_f = rng.integers(0, 8, m).astype(np.int32)
    va = rng.uniform(size=n) < 0.9
    vb = rng.uniform(size=m) < 0.9
    radius = (15.0 * 1.2 ** lvl_m.astype(np.float32) * rng.uniform(1, 20, n)).astype(np.float32)
    return mb, fb, uv, xy, lvl_m, lvl_f, va, vb, radius


def _t(*xs):
    return [torch.from_numpy(np.array(x)) for x in xs]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_window_penalty_exact(seed):
    _, _, uv, xy, lvl_m, lvl_f, _, _, radius = _problem(seed)
    ref = np.asarray(jax.jit(jm.window_penalty)(uv, xy, radius, lvl_f, lvl_m - 1, lvl_m + 1))
    got = tm.window_penalty(*_t(uv, xy, radius, lvl_f, lvl_m - 1, lvl_m + 1)).numpy()
    assert np.array_equal(got, ref), "tolerance: exact"


@pytest.mark.parametrize("seed,ratio,cross", [(0, 0.9, True), (1, 1.0, True), (2, 0.8, False)])
def test_match_nn_exact(seed, ratio, cross):
    mb, fb, uv, xy, lvl_m, lvl_f, va, vb, radius = _problem(seed)
    dist = np.asarray(jm.hamming_matrix(jnp.asarray(mb), jnp.asarray(fb)))
    pen = np.asarray(jax.jit(jm.window_penalty)(uv, xy, radius, lvl_f, lvl_m - 1, lvl_m + 1))
    ri, rok = jm.match_nn(dist, va, vb, 100, ratio, cross_check=cross, extra_penalty=pen)
    gi, gok = tm.match_nn(*_t(dist, va, vb), 100, ratio, cross_check=cross, extra_penalty=torch.from_numpy(pen.copy()))
    assert np.array_equal(gi.numpy(), np.asarray(ri)), "tolerance: exact idx"
    assert np.array_equal(gok.numpy(), np.asarray(rok)), "tolerance: exact ok"
    assert np.asarray(rok).sum() > 10


@pytest.mark.parametrize("seed", [3, 4])
def test_search_by_projection_exact(seed):
    mb, fb, uv, xy, lvl_m, lvl_f, va, vb, radius = _problem(seed)
    ri, rok = jm.search_by_projection(mb, va, uv, lvl_m, fb, xy, lvl_f, vb, radius, 100, 0.9, 1)
    gi, gok = tm.search_by_projection(*_t(mb, va, uv, lvl_m, fb, xy, lvl_f, vb, radius), 100, 0.9, 1)
    assert np.array_equal(gi.numpy(), np.asarray(ri)), "tolerance: exact idx"
    assert np.array_equal(gok.numpy(), np.asarray(rok)), "tolerance: exact ok"


def test_unpack_matches_reference_layout():
    # The reference unpacks map words on device with the same shifts
    # (device_step.py); np.unpackbits(little) is the host layout.
    words = np.random.default_rng(6).integers(0, 2**32, (33, 8), dtype=np.uint64).astype(np.uint32)
    ref = np.unpackbits(words.view(np.uint8), axis=-1, bitorder="little").astype(np.int8)
    got = torb.unpack_bits(torch.from_numpy(words.astype(np.int64))).numpy()
    assert np.array_equal(got, ref), "tolerance: exact"


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_rotation_consistency_exact(seed):
    rng = np.random.default_rng(seed)
    n, m = 200, 260
    idx = rng.integers(0, m, n)
    angle_b = rng.uniform(-np.pi, np.pi, m).astype(np.float32)
    # Most matches share one rotation, some another, the rest are random.
    rot = np.where(rng.uniform(size=n) < 0.6, 0.4, np.where(rng.uniform(size=n) < 0.5, 2.1, rng.uniform(0, 6, n)))
    angle_a = (angle_b[idx] + rot + rng.normal(0, 0.03, n)).astype(np.float32)
    ok = rng.uniform(size=n) < 0.8
    ref = np.asarray(jm.rotation_consistency(jnp.asarray(angle_a), jnp.asarray(angle_b), jnp.asarray(idx), jnp.asarray(ok)))
    got = tm.rotation_consistency(*[torch.from_numpy(x) for x in (angle_a, angle_b, idx, ok)]).numpy()
    assert np.array_equal(got, ref), "tolerance: exact"
    assert 0 < got.sum() < ok.sum()


def test_rotation_consistency_ties_and_empty():
    # Two bins with equal counts: the lower bin ranks first on both sides;
    # and no valid match at all keeps nothing.
    angle_b = np.zeros(8, np.float32)
    angle_a = np.array([0.1, 0.1, 1.0, 1.0, 3.0, 3.0, 5.0, 5.0], np.float32)
    idx = np.arange(8)
    for ok in (np.ones(8, bool), np.zeros(8, bool)):
        ref = np.asarray(jm.rotation_consistency(jnp.asarray(angle_a), jnp.asarray(angle_b), jnp.asarray(idx), jnp.asarray(ok)))
        got = tm.rotation_consistency(*[torch.from_numpy(x) for x in (angle_a, angle_b, idx, ok)]).numpy()
        assert np.array_equal(got, ref), "tolerance: exact"


@pytest.mark.parametrize("seed", [0, 1])
def test_epipolar_penalty_exact(seed):
    rng = np.random.default_rng(seed)
    F = rng.normal(0, 1e-3, (3, 3)).astype(np.float32)
    F[2, 2] = 1.0
    xy1 = rng.uniform(0, 600, (120, 2)).astype(np.float32)
    xy2 = rng.uniform(0, 600, (150, 2)).astype(np.float32)
    s2 = (1.2 ** (2.0 * rng.integers(0, 8, 150))).astype(np.float32) * 400
    ref = np.asarray(jm.epipolar_penalty(jnp.asarray(F), jnp.asarray(xy1), jnp.asarray(xy2), jnp.asarray(s2)))
    got = tm.epipolar_penalty(*[torch.from_numpy(x) for x in (F, xy1, xy2, s2)]).numpy()
    # The mask may differ only where the squared distance sits on the
    # threshold to the last f32 bits; on these inputs it does not.
    assert np.array_equal(got, ref), "tolerance: exact"
    assert 0 < (got == 0).sum() < got.size
