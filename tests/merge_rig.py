"""A two-map Atlas state for the merge tests (port only, no JAX: the card
tests import it too): a map of rendered keyframes with landmarks from exact
depth, and a second one over an overlapping arc of the ring in a
Sim(3)-moved world with seeded noise, as the state just before a merge,
with the merge proposal from the ground truth of the two views.

Cut to size: 320x240, 400 features, maps of 12 and 14 keyframes on a ring
of 4-7 m around a 2.5 m circle (a well-conditioned welding BA).
"""

import numpy as np
import torch

from orbslam3_cpp_fork_tpu_torch import convert
from orbslam3_cpp_fork_tpu_torch.datasets import synthetic
from orbslam3_cpp_fork_tpu_torch.models import atlas as tatlas
from orbslam3_cpp_fork_tpu_torch.models import map_state as tms
from orbslam3_cpp_fork_tpu_torch.ops import orb as torb
from orbslam3_cpp_fork_tpu_torch.runtime import tracker as tt

W, H, N_FEAT = 320, 240, 400
MAP_CFG = dict(max_keyframes=48, max_landmarks=8192)
CAPS = dict(local_lm_cap=1024, ba_lm_cap=1024, ba_obs_cap=8192)


def circle_pose(deg, radius=2.5):
    th = np.radians(deg)
    z = np.array([np.cos(th), np.sin(th), 0.0])
    x = np.array([-np.sin(th), np.cos(th), 0.0])
    R_wc = np.stack([x, np.cross(z, x), z], 1)
    return R_wc, radius * z


def gt_map(m, scene, degs, frame0, S=None, noise=None):
    """A map of rendered keyframes at the given angles, with landmarks from
    exact depth: a feature within 1.2% of its depth and 80 bits of a landmark
    seen before binds to it, any other one makes a new landmark; landmarks
    seen by one keyframe only are dropped at the end (a tracked map
    triangulates from two views at least). With S = (s, R, t) the map's world
    is X' = s R X + t (a drifted map); `noise` perturbs the positions and the
    keyframe translations."""
    fx, fy, cx, cy = (float(v) for v in (scene.K[0, 0], scene.K[1, 1], scene.K[0, 2], scene.K[1, 2]))
    s0, R0, t0 = S if S is not None else (1.0, np.eye(3), np.zeros(3))
    pos = np.zeros((m.cfg.max_landmarks, 3))
    bits_all = np.zeros((m.cfg.max_landmarks, 256), np.int8)
    n = 0
    for j, deg in enumerate(degs):
        R_wc, t_wc = circle_pose(deg)
        img = synthetic.to_u8(synthetic.render_frame(scene, R_wc.astype(np.float32), t_wc.astype(np.float32)))
        f = torb.extract_orb(torch.from_numpy(img).to(torch.float32), torb.OrbParams(n_features=N_FEAT))
        valid, xy, lvl = f.valid.numpy(), f.xy.numpy(), f.level.numpy()
        desc = f.desc_numpy()
        bits = np.unpackbits(desc.view(np.uint8), axis=-1, bitorder="little").astype(np.int8)
        depth = synthetic.render_depth(scene, R_wc.astype(np.float32), t_wc.astype(np.float32))
        px = np.clip(np.round(xy).astype(np.int64), 0, [W - 1, H - 1])
        z = depth[px[:, 1], px[:, 0]]
        lm_idx = np.full(N_FEAT, -1, np.int32)
        new = []
        for i in np.nonzero(valid & (z > 0))[0]:
            xc = np.array([(xy[i, 0] - cx) / fx * z[i], (xy[i, 1] - cy) / fy * z[i], z[i]])
            X = R_wc @ xc + t_wc
            if n:
                d = np.linalg.norm(pos[:n] - X, axis=1)
                b = int(np.argmin(d))
                if d[b] < 0.012 * z[i] and int((bits_all[b] != bits[i]).sum()) < 80 and b not in lm_idx:
                    lm_idx[i] = b
                    continue
            pos[n], bits_all[n] = X, bits[i]
            new.append((i, n))
            n += 1
        # Landmarks first (in map coordinates), then the keyframe binding them.
        if new:
            fi = np.asarray([i for i, _ in new])
            Xw = np.asarray([pos[p] for _, p in new])
            Xm = (s0 * Xw @ np.asarray(R0).T + t0).astype(np.float32)
            if noise is not None:
                Xm = Xm + noise.normal(0, 0.002 * s0, Xm.shape).astype(np.float32)
            ids = m.add_landmarks(
                pos=Xm, desc_packed=desc[fi], desc_i8=bits[fi], first_kf=-1, level=lvl[fi],
                normal=np.zeros((len(fi), 3), np.float32), min_dist=np.full(len(fi), 0.1, np.float32),
                max_dist=np.full(len(fi), 50.0, np.float32),
            )
            assert np.array_equal(ids, [p for _, p in new]), "landmark slots follow creation order"
            lm_idx[fi] = ids
        R_cw = R_wc.T
        t_cw = -R_cw @ t_wc
        # In the moved world: R' = R_cw R0^T, t' = s0 t_cw - R' t0.
        R_m = (R_cw @ np.asarray(R0).T).astype(np.float32)
        t_m = (s0 * t_cw - R_m @ t0).astype(np.float32)
        if noise is not None and j > 0:
            t_m = t_m + noise.normal(0, 0.005 * s0, 3).astype(np.float32)
        m.add_keyframe(R_m, t_m, xy, lvl, f.angle.numpy(), desc, valid, lm_idx, 0.05 * (frame0 + j), frame0 + j)
    # A tracked map triangulates its landmarks from two views at least.
    m.remove_landmarks(np.nonzero(m.lm_valid & (m.lm_obs_count < 2))[0])
    m.update_landmark_stats(np.nonzero(m.lm_valid)[0])
    return m


A_DEGS = np.arange(12) * 4.0  # map 0: 0-44 degrees
B_DEGS = 32.0 + np.arange(14) * 4.0  # map 1: 32-84 degrees, in a moved world
K_B, C_A = 1, 9  # keyframe 1 of map 1 and keyframe 9 of map 0, both at 36 degrees
S_B = (1.3, None, np.array([0.4, -0.2, 0.1]))


def ring_scene():
    """The rig's scene: blobs on a ring of 4-7 m around the 2.5 m circle."""
    return synthetic.make_ring_scene(seed=7, n_points=900, r_inner=4.0, r_outer=7.0, size_range=(5, 9), width=W,
                                     height=H)


def two_map_state():
    """The Atlas state just before the merge (map 1 active), as numpy, and
    the merge proposal: S_kc from the ground truth of the two views (the
    same pose: S_kc = (s, I, 0)) with a seeded perturbation."""
    scene = ring_scene()
    rng = np.random.default_rng(3)
    w = np.array([0.05, -0.1, 0.2])
    R0 = np.asarray(so3(w))
    cfg = tms.MapConfig(n_features=N_FEAT, **MAP_CFG)
    atlas = tatlas.Atlas(cfg)
    gt_map(atlas.maps[0], scene, A_DEGS, 0)
    atlas.create_new_map()
    gt_map(atlas.maps[1], scene, B_DEGS, 40, S=(S_B[0], R0, S_B[2]), noise=rng)
    Rp = np.asarray(so3(rng.normal(0, 0.002, 3)), np.float32)
    S_kc = (S_B[0] * 1.002, Rp, rng.normal(0, 0.003, 3).astype(np.float32))
    return scene, convert.atlas_to_numpy(atlas), S_kc


def so3(w):
    from orbslam3_cpp_fork_tpu_torch.utils import lie

    return lie.so3_exp(torch.as_tensor(np.asarray(w, np.float32))).numpy()


def port_tracker(scene, device="cpu", **kw):
    K = scene.K
    return tt.Tracker(tt.TrackerConfig(
        camera=convert.camera_from_numpy(K[0, 0], K[1, 1], K[0, 2], K[1, 2]), width=W, height=H,
        orb=torb.OrbParams(n_features=N_FEAT), async_mapping=False, map_cfg=tms.MapConfig(**MAP_CFG), **CAPS, **kw,
    ), device)


def live_frame(mod, d, k):
    """The live frame: keyframe k of map `d` (a `map_state_to_numpy` dict) as
    a tracked frame of the tracker module `mod`."""
    return mod.FrameData(
        frame_id=100, timestamp=5.0, R=d["kf_R"][k].copy(), t=d["kf_t"][k].copy(), xy=d["kf_xy"][k].copy(),
        level=d["kf_level"][k].copy(), angle=d["kf_angle"][k].copy(), desc=d["kf_desc"][k].copy(),
        valid=d["kf_feat_valid"][k].copy(), lm_idx=d["kf_lm_idx"][k].copy(), ur=d["kf_ur"][k].copy(),
        depth=d["kf_depth"][k].copy(),
    )


def register(trk):
    """Every keyframe of every map in the tracker's database, by (map, slot)."""
    for m in trk.atlas.maps:
        for k in np.nonzero(m.kf_valid)[0]:
            bits = np.unpackbits(m.kf_desc[k].view(np.uint8), axis=-1, bitorder="little").astype(np.int8)
            trk.kfdb.add(trk._gid(int(k), m.map_id), bits, m.kf_feat_valid[k])


def line_map(n_kf=12, n_feat=64):
    """The port's copy of tests/test_merge_eg.py's fixture: keyframes along
    +x, each observing the band of landmarks nearest to it."""
    m = tms.MapState(tms.MapConfig(max_keyframes=32, max_landmarks=512, n_features=n_feat))
    n_lm = 16 * (n_kf + 3)
    rng = np.random.default_rng(0)
    lm_pos = np.stack([np.linspace(0, n_kf * 0.5, n_lm), rng.uniform(-1, 1, n_lm), np.full(n_lm, 5.0)], 1)
    ids = m.add_landmarks(
        pos=lm_pos.astype(np.float32), desc_packed=rng.integers(0, 2**32, (n_lm, 8), dtype=np.uint32),
        desc_i8=np.zeros((n_lm, 256), np.int8), first_kf=0, level=np.zeros(n_lm, np.int32),
        normal=np.tile(np.array([0, 0, -1], np.float32), (n_lm, 1)), min_dist=np.full(n_lm, 0.5, np.float32),
        max_dist=np.full(n_lm, 50.0, np.float32),
    )
    for k in range(n_kf):
        near = np.argsort(np.abs(lm_pos[:, 0] - k * 0.5))[:n_feat]
        m.add_keyframe(
            R=np.eye(3, dtype=np.float32), t=np.array([-k * 0.5, 0, 0], np.float32),
            xy=np.zeros((n_feat, 2), np.float32), level=np.zeros(n_feat, np.int32),
            angle=np.zeros(n_feat, np.float32), desc_packed=np.zeros((n_feat, 8), np.uint32),
            feat_valid=np.ones(n_feat, bool), lm_idx=ids[near].astype(np.int32), timestamp=float(k), frame_id=k,
        )
    return m


def records(atlas_np):
    """Trajectory records: one per keyframe of every map, a small relative
    pose to its keyframe, in frame order (the spawn between the maps)."""
    rng = np.random.default_rng(9)
    recs = []
    for d in atlas_np["maps"]:
        for k in np.nonzero(d["kf_valid"])[0]:
            R = np.asarray(so3(rng.normal(0, 0.01, 3)), np.float32)
            recs.append((int(d["kf_frame_id"][k]) + 1, 0.05 * (int(d["kf_frame_id"][k]) + 1), int(d["map_id"]), int(k),
                         R, rng.normal(0, 0.02, 3).astype(np.float32)))
    return sorted(recs, key=lambda r: r[0])


def loaded_port_tracker(scene, atlas_np, device="cpu", **kw):
    """A port tracker (loop closing on) on the Atlas of `atlas_to_numpy`,
    with one trajectory record per keyframe and every keyframe in its
    database, OK on map 1's keyframe K_B."""
    trk = port_tracker(scene, device, **kw)
    state = dict(
        state="OK", frame_id=100, ref_kf=K_B, last_kf_frame_id=41, n_kf_inserted=14, last_n_in=200, lost_t=0.0,
        velocity=None, last=None, snapshot_ids=None, snapshot_anchor=None, seen_change_idx=0,
        trajectory=records(atlas_np), traj_anchor_ptr=0, lost_frames=0, kf_alias={},
    )
    convert.load_tracker_state(trk, state, atlas=atlas_np, trajectory=True)
    register(trk)
    return trk
