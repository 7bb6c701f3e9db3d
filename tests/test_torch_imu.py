"""Parity of the port's IMU preintegration (ops/imu.py) with the JAX
reference on the CPU: the same seeded rows through `preintegrate`, a masked
window, a continued preintegration, the bias-corrected getters and
`predict_state`; and the reference's own checks against analytic
trajectories, mirrored on the port (tests/test_imu.py)."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_cpp_fork_tpu.ops import imu as jimu
from orbslam3_cpp_fork_tpu_torch.ops import imu as timu
from orbslam3_cpp_fork_tpu_torch.utils import lie as tlie

from test_imu import simulate

NOISE = (1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0)
JCAL = jimu.ImuCalib.create(*NOISE)
TCAL = timu.ImuCalib.create(*NOISE, device="cpu")
FIELDS = [f.name for f in dataclasses.fields(timu.Preintegrated)]
RTOL = 1e-5  # every field, relative to the field's largest magnitude


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Small shapes: one intra-op thread is faster than a team that spins
    against the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rows(seed, n):
    rng = np.random.default_rng(seed)
    acc = (rng.normal(0, 1.0, (n, 3)) + [0.0, 0.0, 9.81]).astype(np.float32)
    gyro = rng.normal(0, 0.5, (n, 3)).astype(np.float32)
    dts = rng.uniform(0.004, 0.006, n).astype(np.float32)
    bg = rng.normal(0, 0.01, 3).astype(np.float32)
    ba = rng.normal(0, 0.05, 3).astype(np.float32)
    return acc, gyro, dts, bg, ba


def _t(*xs):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in xs]


def _close(got, ref, rtol=RTOL, fields=FIELDS):
    for k in fields:
        g = getattr(got, k).numpy()
        r = np.asarray(getattr(ref, k))
        scale = max(float(np.abs(r).max()), 1e-30)
        err = float(np.abs(g - r).max())
        assert err <= rtol * scale, f"{k}: |port - JAX| {err:.3g} > {rtol} x {scale:.3g}"


@pytest.mark.parametrize("seed", [0, 1])
def test_preintegrate_64_rows_matches(seed):
    """64 rows at biases: every field to 1e-5 relative."""
    acc, gyro, dts, bg, ba = _rows(seed, 64)
    ref = jimu.preintegrate(*map(jnp.asarray, (acc, gyro, dts)), jnp.ones(64, bool), JCAL, bg, ba)
    got = timu.preintegrate(*_t(acc, gyro, dts), TCAL, *_t(bg, ba))
    _close(got, ref)


def test_masked_window_and_continued_init_match():
    """A padded window with a validity mask (the reference's form) and a
    preintegration continued from `init`: both to 1e-5 relative, and the
    port's masked steps leave the state unchanged bit for bit."""
    acc, gyro, dts, bg, ba = _rows(2, 64)
    valid = np.arange(64) < 40
    ref = jimu.preintegrate(*map(jnp.asarray, (acc, gyro, dts)), jnp.asarray(valid), JCAL, bg, ba)
    got_masked = timu.preintegrate(*_t(acc, gyro, dts), TCAL, *_t(bg, ba), valid=torch.from_numpy(valid))
    got_short = timu.preintegrate(*_t(acc[:40], gyro[:40], dts[:40]), TCAL, *_t(bg, ba))
    _close(got_masked, ref)
    for k in FIELDS:
        assert torch.equal(getattr(got_masked, k), getattr(got_short, k)), k
    # Continue the first 40 rows by the last 24.
    ref_init = jimu.preintegrate(*map(jnp.asarray, (acc[:40], gyro[:40], dts[:40])), jnp.ones(40, bool), JCAL, bg, ba)
    ref_cont = jimu.preintegrate(*map(jnp.asarray, (acc[40:], gyro[40:], dts[40:])), jnp.ones(24, bool), JCAL,
                                 bg, ba, init=ref_init)
    got_cont = timu.preintegrate(*_t(acc[40:], gyro[40:], dts[40:]), TCAL, *_t(bg, ba), init=got_short)
    _close(got_cont, ref_cont)


def test_getters_and_predict_state_match():
    """delta_rotation / velocity / position at shifted biases and
    predict_state from a seeded body state: 1e-5."""
    acc, gyro, dts, bg, ba = _rows(3, 50)
    ref = jimu.preintegrate(*map(jnp.asarray, (acc, gyro, dts)), jnp.ones(50, bool), JCAL, bg, ba)
    got = timu.preintegrate(*_t(acc, gyro, dts), TCAL, *_t(bg, ba))
    rng = np.random.default_rng(4)
    bg2 = (bg + rng.normal(0, 0.003, 3)).astype(np.float32)
    ba2 = (ba + rng.normal(0, 0.02, 3)).astype(np.float32)
    pairs = [
        (jimu.delta_rotation(ref, bg2), timu.delta_rotation(got, *_t(bg2))),
        (jimu.delta_velocity(ref, bg2, ba2), timu.delta_velocity(got, *_t(bg2, ba2))),
        (jimu.delta_position(ref, bg2, ba2), timu.delta_position(got, *_t(bg2, ba2))),
    ]
    R1 = np.asarray(tlie.so3_exp(torch.tensor([0.3, -0.2, 0.5])))
    p1 = np.array([1.0, -2.0, 0.5], np.float32)
    v1 = np.array([0.4, 0.1, -0.2], np.float32)
    pairs += list(zip(jimu.predict_state(R1, p1, v1, ref, bg2, ba2),
                      timu.predict_state(*_t(R1, p1, v1), got, *_t(bg2, ba2))))
    for r, g in pairs:
        assert np.abs(g.numpy() - np.asarray(r)).max() <= 1e-5 * max(1.0, float(np.abs(np.asarray(r)).max()))


def _pre(acc, gyro, dts, bg=None, ba=None):
    z = torch.zeros(3)
    return timu.preintegrate(*_t(acc, gyro, dts), TCAL, z if bg is None else bg, z if ba is None else ba)


def test_analytic_trajectories():
    """tests/test_imu.py on the port: pure rotation, constant acceleration,
    the predict_state round trip and the first-order bias correction."""
    w = np.array([0.3, -0.2, 0.5])
    acc, gyro, dts, (Rs, _, _) = simulate(w, np.zeros(3))
    p = _pre(acc, gyro, dts)
    np.testing.assert_allclose(p.dR.numpy(), Rs[-1], atol=1e-4)
    assert abs(float(p.dT) - len(dts) / 200.0) < 1e-5

    a_w = np.array([0.5, -0.3, 9.81 + 0.2])
    acc, gyro, dts, _ = simulate(np.zeros(3), a_w - np.array([0, 0, 9.81]))
    p = _pre(acc, gyro, dts)
    T = float(p.dT)
    expect_dV = (a_w - np.array([0, 0, 9.81]) - np.array([0.0, 0.0, -timu.GRAVITY])) * T
    np.testing.assert_allclose(p.dV.numpy(), expect_dV, atol=1e-3)
    np.testing.assert_allclose(p.dP.numpy(), expect_dV * T / 2, atol=1e-2)

    acc, gyro, dts, (Rs, vs, ps) = simulate(np.array([0.2, 0.1, -0.4]), np.array([0.3, 0.2, 0.1]), duration=0.5)
    p = _pre(acc, gyro, dts)
    z = torch.zeros(3)
    R2, p2, v2 = timu.predict_state(torch.eye(3), z, z, p, z, z)
    np.testing.assert_allclose(R2.numpy(), Rs[-1], atol=1e-3)
    np.testing.assert_allclose(v2.numpy(), vs[-1], atol=1e-3)
    np.testing.assert_allclose(p2.numpy(), ps[-1], atol=1e-3)

    acc, gyro, dts, bg, ba = _rows(11, 100)
    p0 = _pre(acc, gyro, dts)
    db_g = torch.tensor([0.002, -0.001, 0.0015])
    db_a = torch.tensor([0.01, 0.02, -0.015])
    p1 = _pre(acc, gyro, dts, db_g, db_a)
    np.testing.assert_allclose(timu.delta_rotation(p0, db_g).numpy(), p1.dR.numpy(), atol=5e-4)
    np.testing.assert_allclose(timu.delta_velocity(p0, db_g, db_a).numpy(), p1.dV.numpy(), atol=2e-3)
    np.testing.assert_allclose(timu.delta_position(p0, db_g, db_a).numpy(), p1.dP.numpy(), atol=2e-3)


def test_batched_preintegration_matches_one_by_one():
    """A stacked window of three intervals through one call equals the
    three calls (the map stacks keyframe windows)."""
    rows = [_rows(20 + i, 30) for i in range(3)]
    acc, gyro, dts, bg, ba = (np.stack(x) for x in zip(*rows))
    got = timu.preintegrate(*_t(acc, gyro, dts), TCAL, *_t(bg, ba))
    for i in range(3):
        one = timu.preintegrate(*_t(acc[i], gyro[i], dts[i]), TCAL, *_t(bg[i], ba[i]))
        for k in FIELDS:
            np.testing.assert_allclose(getattr(got, k)[i].numpy(), getattr(one, k).numpy(), rtol=0, atol=1e-6)
