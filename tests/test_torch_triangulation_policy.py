"""The new-landmark geometry policy (`runtime.tracker.triangulate_and_check`)
of the port against the reference's: the five cases of
tests/test_triangulation_policy.py, each run through both functions on the
same numpy inputs. Tolerances: the accepted masks equal; accepted points
within 1e-4 m + 1e-5 relative; each case keeps the reference test's own bar
on the port's output.
"""

import jax.numpy as jnp
import numpy as np
import torch

from orbslam3_cpp_fork_tpu.runtime.tracker import triangulate_and_check as jtac
from orbslam3_cpp_fork_tpu_torch.runtime.tracker import triangulate_and_check as ttac

FX = 459.0
K = np.array([[FX, 0, 320.0], [0, FX, 240.0], [0, 0, 1.0]], np.float32)
BF = 0.11 * FX


def _project(R, t, X):
    pc = X @ R.T + t
    uv = pc @ K.T
    return (uv[:, :2] / uv[:, 2:3]).astype(np.float32), pc[:, 2]


def _setup(kf_baseline, z, n=64, noise=0.0, seed=0):
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(z - 1, z + 1, n)],
                 -1).astype(np.float32)
    R1, t1 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    R2, t2 = np.eye(3, dtype=np.float32), np.array([-kf_baseline, 0, 0], np.float32)
    uv1, z1 = _project(R1, t1, X)
    uv2, z2 = _project(R2, t2, X)
    uv1 += rng.normal(0, noise, uv1.shape).astype(np.float32)
    uv2 += rng.normal(0, noise, uv2.shape).astype(np.float32)
    return X, R1, t1, R2, t2, uv1, uv2, z1, z2


def _both(R1, t1, R2, t2, uv1, uv2, z_st1, z_st2, ur1, ur2):
    """Both implementations on the same inputs; the port's (Xo, good),
    held against the reference's."""
    n = len(uv1)
    ones = np.ones(n, np.float32)
    args = (R1, t1, R2, t2, K, uv1, uv2, ones, ones, z_st1, z_st2, ur1, ur2)
    Xr, gr = jtac(*(jnp.asarray(a) for a in args), jnp.float32(BF), jnp.ones(n, jnp.float32), jnp.ones(n, bool))
    Xo, good = ttac(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args), torch.tensor(BF, dtype=torch.float32),
                    torch.ones(n), torch.ones(n, dtype=torch.bool))
    Xo, good, Xr, gr = Xo.numpy(), good.numpy(), np.asarray(Xr), np.asarray(gr)
    assert np.array_equal(good, gr), "tolerance: the same accepted points"
    np.testing.assert_allclose(Xo[good], Xr[good], rtol=1e-5, atol=1e-4)
    return Xo, good


def _run(kf_baseline, z, z_st_err=0.0, stereo=True, noise=0.0):
    X, R1, t1, R2, t2, uv1, uv2, z1, z2 = _setup(kf_baseline, z, noise=noise)
    n = len(X)
    neg = np.full(n, -1.0, np.float32)
    z_st1 = (z1 * (1 + z_st_err)).astype(np.float32) if stereo else neg
    z_st2 = (z2 * (1 + z_st_err)).astype(np.float32) if stereo else neg
    ur1 = (uv1[:, 0] - BF / np.maximum(z_st1, 1e-6)).astype(np.float32) if stereo else neg
    ur2 = (uv2[:, 0] - BF / np.maximum(z_st2, 1e-6)).astype(np.float32) if stereo else neg
    return (X, *_both(R1, t1, R2, t2, uv1, uv2, z_st1, z_st2, ur1, ur2))


def test_low_parallax_uses_rig_depth():
    X, Xo, good = _run(kf_baseline=0.03, z=6.0, z_st_err=0.05)
    assert good.sum() > 40
    np.testing.assert_allclose((Xo[good, 2] - X[good, 2]) / X[good, 2], 0.05, atol=0.01)


def test_high_parallax_uses_dlt():
    X, Xo, good = _run(kf_baseline=1.0, z=6.0, z_st_err=0.05)
    assert good.sum() > 40
    assert np.median(np.abs(Xo[good, 2] - X[good, 2]) / X[good, 2]) < 0.005


def test_mono_features_still_triangulate():
    X, Xo, good = _run(kf_baseline=1.0, z=6.0, stereo=False)
    assert good.sum() > 40
    np.testing.assert_allclose(Xo[good], X[good], rtol=1e-2, atol=1e-2)


def test_mono_low_parallax_rejected():
    _, _, good = _run(kf_baseline=1e-5, z=6.0, stereo=False)
    assert good.sum() == 0


def test_stereo_chi2_gate_rejects_bad_ur():
    X, R1, t1, R2, t2, uv1, uv2, z1, z2 = _setup(1.0, 6.0)
    z_st1, z_st2 = z1.astype(np.float32), z2.astype(np.float32)
    ur1 = (uv1[:, 0] - BF / z_st1 + 25.0).astype(np.float32)
    ur2 = (uv2[:, 0] - BF / z_st2).astype(np.float32)
    _, good = _both(R1, t1, R2, t2, uv1, uv2, z_st1, z_st2, ur1, ur2)
    assert good.sum() == 0
