"""Entry points of the port (port of __graft_entry__.py): the per-frame
tracking step at the reference's shapes, and a multi-rank dry run of the
runtime's sharded whole-map bundle adjustment.

    from orbslam3_cpp_fork_tpu_torch.entry import entry, dryrun_multichip
    fn, args = entry()          # on the card; entry("cpu") on the CPU
    R2, t2, n_in = fn(*args)    # one describe-kernel launch a call
    dryrun_multichip(2)         # two ranks; see `dryrun_multichip`
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .device import get_device

WIDTH, HEIGHT = 640, 480
CAPACITY = 2048  # local-map landmark capacity L
N_FEATURES = 1000


def entry(device: str | torch.device = "cuda"):
    """(fn, args) for the per-frame tracking step
    (runtime/device_step.py:fused_track_step): ORB extraction -> local-map
    projection matching -> motion-only pose optimization, on a 640x480 image
    against L = 2048 landmarks with 1000 features, the inputs drawn from
    `numpy.random.default_rng(0)` in the reference's order. `fn(*args)`
    returns (R2, t2, n_in)."""
    from .ops.orb import OrbParams
    from .runtime.device_step import fused_track_step

    dev = get_device(device)
    H, W, L = HEIGHT, WIDTH, CAPACITY
    rng = np.random.default_rng(0)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    img = put(rng.uniform(0, 255, (H, W)).astype(np.float32))
    R = torch.eye(3, dtype=torch.float32, device=dev)
    t = torch.zeros(3, dtype=torch.float32, device=dev)
    lm_pos = put(np.concatenate([rng.uniform(-3, 3, (L, 2)), rng.uniform(3, 10, (L, 1))], axis=1).astype(np.float32))
    lm_normal = put(np.tile(np.array([0, 0, -1], np.float32), (L, 1)))
    lm_min = torch.full((L,), 0.1, dtype=torch.float32, device=dev)
    lm_max = torch.full((L,), 100.0, dtype=torch.float32, device=dev)
    lm_bits = put(rng.integers(0, 2, (L, 256)).astype(np.int8))
    lm_valid = torch.ones(L, dtype=torch.bool, device=dev)
    p = OrbParams(n_features=N_FEATURES)

    def fn(img, R, t, lm_pos, lm_normal, lm_min, lm_max, lm_bits, lm_valid):
        feats, R2, t2, idx, mok, inl, n_in = fused_track_step(
            img, R, t, lm_pos, lm_normal, lm_min, lm_max, lm_bits, lm_valid,
            400.0, 400.0, 320.0, 240.0, float(W), float(H), orb_params=p,
        )
        return R2, t2, n_in

    return fn, (img, R, t, lm_pos, lm_normal, lm_min, lm_max, lm_bits, lm_valid)


def dryrun_multichip(n_devices: int, device: str = "cuda") -> list[dict]:
    """The runtime's whole-map BA with its observations sharded over
    `n_devices` ranks (parallel/launch.py lays them out: NCCL with a card
    per rank, gloo with every rank on cuda:0 when there are fewer cards,
    gloo on the CPU for `device="cpu"`). Each rank builds the same tiny map
    from the same seed through the public mutators and calls
    `Tracker._global_ba(iters=4)`, which must take the sharded path; then it
    preintegrates a gravity-only IMU window and solves a FullInertialBA
    problem with 16 x n observations by `sparse_vi_ba_sharded`. Returns
    each rank's results (numpy), which are checked finite here."""
    from .parallel import launch

    out = launch.run_ranks(_dryrun_rank, n_devices, device=device)
    for r, o in enumerate(out):
        for k in ("kf_t", "lm_pos", "vi_twb", "vi_Xw"):
            if not np.all(np.isfinite(o[k])):
                raise RuntimeError(f"rank {r}: {k} is not finite")
    return out


def dryrun_map(dev: torch.device, n_ranks: int):
    """The dry run's tracker and its tiny map (6 keyframes along x, 128
    landmarks ahead, perturbed), built through the public mutators from
    `numpy.random.default_rng(0)`; returns (tracker, landmark positions,
    the generator for what follows)."""
    from .ops.camera import Camera
    from .ops.orb import OrbParams
    from .runtime.tracker import Sensor, Tracker, TrackerConfig

    fx = fy = 400.0
    cx, cy = 320.0, 240.0
    cfg = TrackerConfig(
        camera=Camera.pinhole(fx, fy, cx, cy), width=640, height=480,
        sensor=Sensor.MONOCULAR, orb=OrbParams(n_features=128),
        enable_loop_closing=False, async_mapping=False,
        gba_obs_bucket=8 * n_ranks,
    )
    tr = Tracker(cfg, dev)
    m = tr.map
    rng = np.random.default_rng(0)

    # A tiny consistent map: cameras along x, landmarks ahead.
    K_n, L_n, nf = 6, 128, 128
    Xw = np.stack([rng.uniform(-2, 2, L_n), rng.uniform(-1.5, 1.5, L_n), rng.uniform(4, 9, L_n)], 1).astype(np.float32)
    ids = m.add_landmarks(
        pos=Xw,
        desc_packed=rng.integers(0, 2**32, (L_n, 8), dtype=np.uint32),
        desc_i8=np.zeros((L_n, 256), np.int8),
        first_kf=0, level=np.zeros(L_n, np.int32),
        normal=np.tile(np.array([0, 0, -1], np.float32), (L_n, 1)),
        min_dist=np.full(L_n, 0.1, np.float32),
        max_dist=np.full(L_n, 100.0, np.float32),
    )
    for k in range(K_n):
        R = np.eye(3, dtype=np.float32)
        t = np.array([-0.1 * k, 0, 0], np.float32)
        take = rng.permutation(L_n)[:nf]
        pc = Xw[take] @ R.T + t
        uv = np.stack([fx * pc[:, 0] / pc[:, 2] + cx, fy * pc[:, 1] / pc[:, 2] + cy], 1).astype(np.float32)
        m.add_keyframe(
            R=R, t=t + rng.normal(0, 0.01, 3).astype(np.float32),
            xy=uv, level=np.zeros(nf, np.int32), angle=np.zeros(nf, np.float32),
            desc_packed=rng.integers(0, 2**32, (nf, 8), dtype=np.uint32),
            feat_valid=np.ones(nf, bool), lm_idx=ids[take].astype(np.int32),
            timestamp=float(k), frame_id=k,
        )
    m.lm_pos[ids] += rng.normal(0, 0.03, (L_n, 3)).astype(np.float32)
    return tr, Xw, rng


def _dryrun_rank(rank: int, dev: torch.device) -> dict:
    """One rank of `dryrun_multichip` (__graft_entry__.py:46-164)."""
    import torch.distributed as dist

    from .ops import imu as imu_ops
    from .optim import sparse_ba
    from .optim.inertial import VIBAProblem
    from .parallel.dist_ba import sparse_vi_ba_sharded

    n = dist.get_world_size()
    tr, Xw, rng = dryrun_map(dev, n)
    m = tr.map
    fx = fy = 400.0
    L_n = Xw.shape[0]
    n0 = sparse_ba.n_all_reduces
    tr._global_ba(iters=4)  # -> sparse_ba_sharded over the group
    if tr.n_sharded_solves != 1:
        raise RuntimeError("the global BA did not take the sharded path")
    gba_all_reduces = sparse_ba.n_all_reduces - n0

    # Visual-inertial: FullInertialBA with its reprojection observations
    # sharded over the same group; body states at rest, gravity-only IMU,
    # landmarks ahead.
    calib = imu_ops.ImuCalib.create(1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0, device=dev)
    n_kf, steps = 4, 8
    acc = torch.tensor([[0.0, 0.0, 9.81]], device=dev).repeat(steps, 1)
    gyr = torch.zeros((steps, 3), device=dev)
    dts = torch.full((steps,), 0.05, device=dev)
    zero3 = torch.zeros(3, device=dev)
    one = imu_ops.preintegrate(acc, gyr, dts, calib, zero3, zero3, valid=torch.ones(steps, dtype=torch.bool, device=dev))
    pre = imu_ops.Preintegrated(**{
        f.name: torch.stack([getattr(one, f.name)] * (n_kf - 1)) for f in dataclasses.fields(one)
    })
    O_vi = 16 * n
    obs_kf = rng.integers(0, n_kf, O_vi).astype(np.int64)
    obs_lm = rng.integers(0, L_n, O_vi).astype(np.int64)
    pc = Xw[obs_lm]
    uv = np.stack([fx * pc[:, 0] / pc[:, 2], fy * pc[:, 1] / pc[:, 2]], 1).astype(np.float32)

    def put(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    kf_fixed = torch.zeros(n_kf, dtype=torch.bool, device=dev)
    kf_fixed[0] = True
    prob = VIBAProblem(
        Rwb=torch.eye(3, device=dev).repeat(n_kf, 1, 1),
        twb=torch.zeros((n_kf, 3), device=dev), vel=torch.zeros((n_kf, 3), device=dev),
        bg=torch.zeros((n_kf, 3), device=dev), ba=torch.zeros((n_kf, 3), device=dev),
        kf_valid=torch.ones(n_kf, dtype=torch.bool, device=dev), kf_fixed=kf_fixed,
        Xw=put(Xw), lm_valid=torch.ones(L_n, dtype=torch.bool, device=dev),
        obs_kf=put(obs_kf), obs_lm=put(obs_lm),
        obs_uvr=put(np.concatenate([uv, np.zeros((O_vi, 1), np.float32)], 1)),
        obs_sigma2=torch.ones(O_vi, device=dev), obs_stereo=torch.zeros(O_vi, dtype=torch.bool, device=dev),
        obs_valid=torch.ones(O_vi, dtype=torch.bool, device=dev),
        edge_i=torch.arange(n_kf - 1, device=dev), edge_j=torch.arange(1, n_kf, device=dev),
        edge_valid=torch.ones(n_kf - 1, dtype=torch.bool, device=dev), pre=pre,
        Rcb=torch.eye(3, device=dev), tcb=torch.zeros(3, device=dev), fx=fx, fy=fy, bf=0.0,
    )
    res = sparse_vi_ba_sharded(None, prob, iters=2, gate_at=1, cg_iters=20)
    return dict(
        kf_R=m.kf_R[m.kf_valid].copy(), kf_t=m.kf_t[m.kf_valid].copy(), lm_pos=m.lm_pos[m.lm_valid].copy(),
        vi_twb=res.twb.cpu().numpy(), vi_Xw=res.Xw.cpu().numpy(), gba_all_reduces=gba_all_reduces,
        sharded_solves=tr.n_sharded_solves,
    )
