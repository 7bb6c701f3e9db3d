"""The whole ported slice against the JAX reference on the CPU.

The same seeded local map (numpy, through convert.py) and the same
rendered 240x320 frames go through the JAX `fused_frame_program`, chained
as the reference's pipelined tracker chains it, and through the port's
`LocalizationTracker`. Per frame: pose within 1 mm / 0.05 deg, n_inliers
within 3%, bound mask equal on >= 98% of the rows bound on either side.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_cpp_fork_tpu.ops.camera import Camera as JCamera
from orbslam3_cpp_fork_tpu.ops.orb import OrbParams as JOrbParams
from orbslam3_cpp_fork_tpu.runtime import device_step as jds
from orbslam3_cpp_fork_tpu.runtime.tracker import project_landmarks as j_project
from orbslam3_cpp_fork_tpu_torch import convert
from orbslam3_cpp_fork_tpu_torch.datasets import synthetic
from orbslam3_cpp_fork_tpu_torch.ops.orb import OrbParams
from orbslam3_cpp_fork_tpu_torch.runtime import device_step as tds
from orbslam3_cpp_fork_tpu_torch.runtime.localization import LocalizationTracker
from orbslam3_cpp_fork_tpu_torch.runtime.tracker import project_landmarks as t_project

H, W, NF, L, T = 240, 320, 300, 256, 3
KEYS = ("R", "t", "n_inliers", "bound", "ok", "idx", "visible", "n_stage1")


@pytest.fixture(scope="module")
def seq():
    scene = synthetic.make_ring_scene(seed=7, n_points=1200, size_range=(9, 15), width=W, height=H)
    Rs, ts = synthetic.circle_trajectory(n_frames=300, radius=2.5, total_angle=2.3 * np.pi)
    Rs, ts = Rs[:6], ts[:6]
    snap = synthetic.seed_local_map(scene, Rs, ts, capacity=L, kf_every=2, orb_params=OrbParams(n_features=NF),
                                    device="cpu")
    frames = [synthetic.to_u8(synthetic.render_frame(scene, Rs[i], ts[i])) for i in range(T)]
    return scene, Rs, ts, snap, frames


@pytest.fixture(scope="module")
def runs(seq):
    scene, Rs, ts, snap, frames = seq
    K = scene.K
    R0, t0 = Rs[0].T, -Rs[0].T @ ts[0]
    cam = convert.camera_from_numpy(K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    trk = LocalizationTracker(cam, OrbParams(n_features=NF), convert.local_map_from_numpy(snap, "cpu"), "cpu",
                              initial_pose=(R0, t0))
    port = []
    for i, f in enumerate(frames):
        trk.track(f, 0.05 * i)
        port.append({k: trk.last[k].numpy().copy() for k in KEYS})

    jcam = JCamera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    J = {k: jnp.asarray(v) for k, v in snap.items()}
    Rp, tp, Rq, tq, b = jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(R0), jnp.asarray(t0), jnp.zeros(L, bool)
    ref = []
    for f in frames:
        o = jds.fused_frame_program(
            jnp.asarray(f), jcam, Rp, tp, Rq, tq,
            J["pos"], J["normal"], J["mind"], J["maxd"], J["desc"], J["valid"], b,
            jnp.arange(L, dtype=jnp.int32), jnp.int32(20), jnp.int32(30),
            float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2]), float(W), float(H),
            orb_params=JOrbParams(n_features=NF),
        )
        Rp, tp, Rq, tq, b = o["R_pred_next"], o["t_pred_next"], o["R"], o["t"], o["bound"]
        ref.append({k: np.asarray(o[k]) for k in KEYS})
    return port, ref, trk


@pytest.mark.parametrize("frame", range(T))
def test_pose_matches(runs, frame):
    port, ref, _ = runs
    p, r = port[frame], ref[frame]
    C_p, C_r = -p["R"].T @ p["t"], -r["R"].T @ r["t"]
    assert np.linalg.norm(C_p - C_r) <= 1e-3, "tolerance: camera centre within 1 mm"
    cos = (np.trace(p["R"] @ r["R"].T) - 1.0) / 2.0
    assert np.degrees(np.arccos(np.clip(cos, -1, 1))) <= 0.05, "tolerance: rotation within 0.05 deg"
    assert bool(p["ok"]) == bool(r["ok"]) and bool(r["ok"]), "tolerance: exact acceptance flag"


@pytest.mark.parametrize("frame", range(T))
def test_inliers_and_bound_match(runs, frame):
    port, ref, _ = runs
    p, r = port[frame], ref[frame]
    n_p, n_r = int(p["n_inliers"]), int(r["n_inliers"])
    assert abs(n_p - n_r) <= 0.03 * n_r, f"tolerance: n_inliers within 3% ({n_p} vs {n_r})"
    either = p["bound"] | r["bound"]
    agree = (p["bound"] == r["bound"])[either].mean()
    assert agree >= 0.98, f"tolerance: bound equal on >= 98% of bound rows; got {agree:.4f}"
    same = p["bound"] & r["bound"]
    assert np.array_equal(p["idx"][same], r["idx"][same]), "tolerance: exact feature index on rows bound by both"


def test_trajectory_tracks_ground_truth(runs, seq):
    _, Rs, ts, _, _ = seq
    stamps, Tcw, ok = runs[2].trajectory()
    assert Tcw.shape == (T, 4, 4) and ok.all() and np.isfinite(Tcw).all()
    C = np.stack([-Tcw[i, :3, :3].T @ Tcw[i, :3, 3] for i in range(T)])
    assert np.abs(C - ts[:T]).max() < 0.05, "tolerance: camera centres within 5 cm of ground truth"


def test_project_landmarks_matches(seq):
    scene, Rs, ts, snap, _ = seq
    K = scene.K
    R, t = Rs[1].T, -Rs[1].T @ ts[1]
    args = [snap[k] for k in ("pos", "normal", "mind", "maxd", "valid")]
    intr = (float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2]), float(W), float(H))
    ref = [np.asarray(x) for x in j_project(R, t, *args, *intr)]
    got = [x.numpy() for x in t_project(*[torch.from_numpy(np.asarray(a)) for a in (R, t, *args)], *intr)]
    assert np.abs(got[0] - ref[0]).max() <= 1e-3, "tolerance: uv within 1e-3 px"
    assert np.abs(got[2] - ref[2]).max() <= 1e-5, "tolerance: dist within 1e-5 m"
    assert (got[1] == ref[1]).mean() >= 0.99 and (got[3] == ref[3]).mean() >= 0.99, (
        "tolerance: level and frustum mask equal on >= 99% of landmarks"
    )


def test_fused_track_step_matches(seq):
    scene, Rs, ts, snap, frames = seq
    K = scene.K
    R, t = Rs[1].T.astype(np.float32), (-Rs[1].T @ ts[1]).astype(np.float32)
    bits = np.unpackbits(snap["desc"].view(np.uint8), axis=-1, bitorder="little").astype(np.int8)
    lm = [snap[k] for k in ("pos", "normal", "mind", "maxd")]
    intr = (float(K[0, 0]), float(K[1, 1]), float(K[0, 2]), float(K[1, 2]), float(W), float(H))
    img = frames[1].astype(np.float32)
    ref = jds.fused_track_step(img, R, t, *lm, bits, snap["valid"], *intr, orb_params=JOrbParams(n_features=NF))
    got = tds.fused_track_step(
        *[torch.from_numpy(np.asarray(a)) for a in (img, R, t, *lm, bits, snap["valid"])], *intr,
        orb_params=OrbParams(n_features=NF),
    )
    assert np.abs(got[1].numpy() - np.asarray(ref[1])).max() <= 1e-5, "tolerance: R within 1e-5"
    assert np.abs(got[2].numpy() - np.asarray(ref[2])).max() <= 1e-4, "tolerance: t within 1e-4 m"
    assert abs(int(got[6]) - int(ref[6])) <= 0.03 * int(ref[6]), "tolerance: n_inliers within 3%"
    # The batch form is the same step in a loop.
    Rs_s, ts_s, ns = tds.fused_track_scan(
        torch.from_numpy(np.stack([img, img])), *[torch.from_numpy(np.asarray(a)) for a in (R, t, *lm, bits, snap["valid"])],
        *intr, orb_params=OrbParams(n_features=NF),
    )
    assert torch.equal(Rs_s[0], got[1]) and int(ns[0]) == int(got[6])


def test_convert_keeps_descriptor_bits():
    rng = np.random.default_rng(0)
    d = dict(
        pos=rng.normal(size=(5, 3)).astype(np.float32), normal=rng.normal(size=(5, 3)).astype(np.float32),
        mind=np.ones(5, np.float32), maxd=np.ones(5, np.float32),
        desc=np.array([[0xFFFFFFFF, 0x80000000, 0, 1, 0x7FFFFFFF, 0xDEADBEEF, 2**31 + 5, 12345]] * 5, np.uint32),
        valid=np.array([1, 1, 0, 1, 0], bool),
    )
    lm = convert.local_map_from_numpy(d, "cpu")
    assert lm.desc.dtype == torch.int64 and np.array_equal(lm.desc.numpy().astype(np.uint32), d["desc"])
    assert np.array_equal(lm.valid.numpy(), d["valid"]) and lm.capacity == 5
    with pytest.raises(ValueError):
        convert.local_map_from_numpy({**d, "desc": d["desc"].astype(np.int64)}, "cpu")
    cam = convert.camera_from_numpy(400.0, 401.0, 160.0, 120.0, np.array([0.1, -0.01, 0.0, 0.0]))
    assert cam.dist == (np.float32(0.1), np.float32(-0.01), 0.0, 0.0, 0.0) and cam.fx == 400.0
