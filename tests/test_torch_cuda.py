"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA card and skips without one. The file imports
neither JAX nor the JAX package, so it also runs where JAX is absent:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py

(`--noconftest` because tests/conftest.py configures JAX.)
"""

import numpy as np
import pytest
import torch

from orbslam3_cpp_fork_tpu_torch import convert
from orbslam3_cpp_fork_tpu_torch.datasets import synthetic
from orbslam3_cpp_fork_tpu_torch.ops import image, orb, patches
from orbslam3_cpp_fork_tpu_torch.runtime.localization import LocalizationTracker

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda", torch.cuda.current_device())


def _frame(h=480, w=752):
    scene = synthetic.make_ring_scene(seed=7, n_points=1200, size_range=(9, 15), width=w, height=h)
    Rs, ts = synthetic.circle_trajectory(n_frames=300, radius=2.5, total_angle=2.3 * np.pi)
    return scene, Rs, ts, synthetic.to_u8(synthetic.render_frame(scene, Rs[0], ts[0]))


def test_kernel_matches_plain_at_every_level(dev):
    p = orb.OrbParams(n_features=1000)
    img = torch.from_numpy(_frame()[3].astype(np.float32)).to(dev)
    for l, lvl in enumerate(image.build_pyramid(img)):
        xy, _, _ = orb.level_keypoints(lvl, orb.level_caps(p)[l], p)
        blur = image.gaussian_blur7(lvl)
        ka, kb = patches.extract_patches_dual(lvl.contiguous(), blur.contiguous(), xy.contiguous())
        assert torch.equal(ka, patches._gather_plain(lvl, xy)), f"level {l}: tolerance bitwise"
        assert torch.equal(kb, patches._gather_plain(blur, xy)), f"level {l}: tolerance bitwise"


@pytest.mark.parametrize("n", [1, 127, 129, 1000])
def test_kernel_matches_plain_edge_cases(dev, n):
    h, w = 133, 211
    g = torch.Generator().manual_seed(n)
    img = (torch.rand((h, w), generator=g) * 255).to(dev)
    xy = torch.stack([torch.randint(-30, w + 30, (n,), generator=g), torch.randint(-30, h + 30, (n,), generator=g)], 1)
    xy[: min(n, 4)] = torch.tensor([[0, 0], [w - 1, h - 1], [0, h - 1], [w - 1, 0]])[: min(n, 4)]
    xy = xy.to(torch.int32).to(dev)
    assert torch.equal(patches.extract_patches(img, xy), patches._gather_plain(img, xy)), "tolerance: bitwise"


def test_kernel_counts_launches_and_rejects_bad_inputs(dev):
    img = torch.zeros((40, 50), device=dev)
    xy = torch.zeros((3, 2), dtype=torch.int32, device=dev)
    before = patches.launches
    patches.extract_patches_dual(img, img, xy)
    assert patches.launches == before + 1
    with pytest.raises(ValueError):
        patches.extract_patches(img.t(), xy)  # not contiguous
    with pytest.raises(ValueError):
        patches.extract_patches(img, xy.cpu())  # devices differ


def test_frame_program_on_card_matches_cpu(dev):
    h, w, nf, L = 240, 320, 300, 256
    scene, Rs, ts, _ = _frame(h, w)
    snap = synthetic.seed_local_map(scene, Rs[:6], ts[:6], L, 2, orb.OrbParams(n_features=nf))
    K = scene.K
    cam = convert.camera_from_numpy(K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    pose0 = (Rs[0].T, -Rs[0].T @ ts[0])
    trk = {d: LocalizationTracker(cam, orb.OrbParams(n_features=nf), convert.local_map_from_numpy(snap, d), d,
                                  initial_pose=pose0) for d in (dev, torch.device("cpu"))}
    before = patches.describe_launches
    patches.describe_counter(dev).zero_()
    for i in range(3):
        f = synthetic.to_u8(synthetic.render_frame(scene, Rs[i], ts[i]))
        Tg = trk[dev].track(f, 0.05 * i).cpu().numpy()
        Tc = trk[torch.device("cpu")].track(f, 0.05 * i).numpy()
        dC = np.linalg.norm(-Tg[:3, :3].T @ Tg[:3, 3] + Tc[:3, :3].T @ Tc[:3, 3])
        assert dC <= 1e-3, f"frame {i}: tolerance 1 mm between card and CPU; got {dC}"
    assert patches.describe_launches - before == 3, "one fused describe launch per frame"
    assert int(patches.describe_counter(dev)) == 3, "the card counted the same launches"


def _frame_levels(dev):
    p = orb.OrbParams(n_features=1000)
    img = torch.from_numpy(_frame()[3].astype(np.float32)).to(dev)
    levels = [l.contiguous() for l in image.build_pyramid(img)]
    blurred = [image.gaussian_blur7(l).contiguous() for l in levels]
    kps = [orb.level_keypoints(l, orb.level_caps(p)[i], p) for i, l in enumerate(levels)]
    return levels, blurred, [k[0] for k in kps], torch.cat([k[2] for k in kps])


def _assert_describe_close(got, ref, gate=None, max_other_bin=0.01):
    """Angle within 1e-5 rad (wrap-aware) on the gated slots, bits and words
    exact wherever both sides quantize to the same bin, and at most
    `max_other_bin` of the gated slots in another bin."""
    gate = torch.ones_like(ref[0], dtype=torch.bool) if gate is None else gate
    d = torch.abs(torch.remainder(got[0].double() - ref[0].double() + np.pi, 2 * np.pi) - np.pi)
    assert float(d[gate].max()) <= 1e-5, f"tolerance 1e-5 rad; got {float(d[gate].max())}"
    same = patches.quantize_angle(got[0]) == patches.quantize_angle(ref[0])
    assert float((~same)[gate].float().mean()) <= max_other_bin
    assert torch.equal(got[1][same], ref[1][same]), "tolerance: exact bits on equal bins"
    assert torch.equal(got[2][same], ref[2][same]), "tolerance: exact words on equal bins"


def test_describe_kernel_matches_plain_on_a_frame(dev):
    levels, blurred, xys, valid = _frame_levels(dev)
    before = patches.launches
    got = patches.describe_keypoints(levels, blurred, xys)
    torch.cuda.synchronize()
    assert patches.launches == before, "the fused kernel replaces the per-level gather launches"
    m = sum(orb.level_caps(orb.OrbParams(n_features=1000)))  # 1247 keypoint slots over the 8 levels
    assert got[0].shape == (m,) and got[1].shape == (m, 256) and got[2].shape == (m, 8)
    assert got[1].dtype == torch.int8 and got[2].dtype == torch.int64
    ref = patches.describe_keypoints_plain(levels, blurred, xys)
    _assert_describe_close(got, ref, gate=valid)
    per_level = patches.describe_keypoints_per_level(levels, blurred, xys)
    _assert_describe_close(per_level, ref, gate=valid)


@pytest.mark.parametrize("n", [1, 127, 129])
def test_describe_kernel_edge_cases(dev, n):
    """Keypoints on and beyond the border, a level with no keypoints, and a
    flat level (zero moments: angle 0, bin 0, all bits 0)."""
    g = torch.Generator().manual_seed(n)
    shapes = [(133, 211), (50, 64), (41, 43), (45, 52)]
    yy, xx = torch.meshgrid(torch.arange(133.0), torch.arange(211.0), indexing="ij")
    ramp = (30 + (1.1 * xx + 0.9 * yy) % 200 + 20 * torch.rand((133, 211), generator=g)).clamp(0, 255)
    levels = [ramp, ramp[:50, :64].contiguous(), ramp[10:51, 20:63].contiguous(), torch.full(shapes[3], 77.25)]
    levels = [l.to(dev) for l in levels]
    blurred = [image.gaussian_blur7(l).contiguous() for l in levels]

    def kps(hw, k):
        h, w = hw
        xy = torch.stack([torch.randint(-20, w + 20, (k,), generator=g), torch.randint(-20, h + 20, (k,), generator=g)], 1)
        fixed = torch.tensor([[0, 0], [w - 1, h - 1], [-5, -7], [w + 3, h + 9]])[: min(k, 4)]
        xy[: len(fixed)] = fixed
        return xy.to(torch.int32).to(dev)

    xys = [kps(shapes[0], n), torch.zeros((0, 2), dtype=torch.int32, device=dev), kps(shapes[2], 7), kps(shapes[3], 5)]
    got = patches.describe_keypoints(levels, blurred, xys)
    torch.cuda.synchronize()
    ref = patches.describe_keypoints_plain(levels, blurred, xys)
    assert got[0].shape == (n + 12,)
    # The plain version's f32 moment sums are off by a few tenths: 1e-5 rad
    # only where the moment vector is longer than ~5e4 (or exactly zero).
    w = patches._device_tables(dev)[2].double()
    norm = torch.cat([
        torch.linalg.norm(patches._gather_plain(l, xy).reshape(-1, 1600).double() @ w, dim=1)
        for l, xy in zip(levels, xys)
    ])
    gate = (norm >= 5e4) | (norm == 0)
    assert int(gate.sum()) >= 0.5 * (n + 12)
    _assert_describe_close(got, ref, gate=gate, max_other_bin=0.0)
    assert not got[0][-5:].any() and not got[1][-5:].any() and not got[2][-5:].any()


def test_describe_counts_on_host_and_card_and_rejects_bad_inputs(dev):
    levels, blurred, xys, _ = _frame_levels(dev)
    counter = patches.describe_counter(dev)
    counter.zero_()
    before = patches.describe_launches
    eager = patches.describe_keypoints(levels, blurred, xys)
    assert patches.describe_launches == before + 1 and int(counter) == 1
    # A launch replayed from a CUDA graph never passes the wrapper: only the
    # card's own counter sees it.
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = patches.describe_keypoints(levels, blurred, xys)
    host = patches.describe_launches
    counter.zero_()
    for _ in range(3):
        graph.replay()
    assert int(counter) == 3 and patches.describe_launches == host
    for a, b in zip(eager, captured):
        assert torch.equal(a, b), "tolerance: exact (the kernel is deterministic)"
    with pytest.raises(ValueError):
        patches.describe_keypoints([levels[0].t()], [blurred[0].t()], xys[:1])  # not contiguous
    with pytest.raises(ValueError):
        patches.describe_keypoints(levels[:1], blurred[:1], [xys[0].cpu()])  # devices differ


def _ba_window(seed, K=8, L=256, O=2048, n_lm=220):
    """A small window-BA problem (numpy dict), made without the reference."""
    rng = np.random.default_rng(seed)
    fx = fy = 420.0
    X = np.stack([rng.uniform(-3, 3, n_lm), rng.uniform(-2, 2, n_lm), rng.uniform(4, 9, n_lm)], 1)
    ts = np.stack([[-0.25 * k, 0.02 * k, 0.0] for k in range(K)])
    o_kf, o_lm, o_uv = [], [], []
    for k in range(K):
        pc = X + ts[k]
        uv = np.stack([fx * pc[:, 0] / pc[:, 2], fy * pc[:, 1] / pc[:, 2]], 1) + rng.normal(0, 0.5, (n_lm, 2))
        ids = np.nonzero((np.abs(uv[:, 0]) < 320) & (np.abs(uv[:, 1]) < 240))[0]
        o_kf += [k] * len(ids)
        o_lm += list(ids)
        o_uv.append(uv[ids])
    n = len(o_kf)
    fixed = np.zeros(K, bool)
    fixed[[0, K - 1]] = True
    return dict(
        R=np.tile(np.eye(3), (K, 1, 1)), t=ts + (~fixed)[:, None] * rng.normal(0, 0.03, ts.shape),
        kf_valid=np.ones(K, bool), kf_fixed=fixed,
        Xw=np.concatenate([X + rng.normal(0, 0.05, X.shape), np.zeros((L - n_lm, 3))]),
        lm_valid=np.arange(L) < n_lm,
        obs_kf=np.concatenate([o_kf, np.zeros(O - n)]), obs_lm=np.concatenate([o_lm, np.zeros(O - n)]),
        obs_uvr=np.concatenate([np.concatenate([np.concatenate(o_uv), np.zeros((n, 1))], 1), np.zeros((O - n, 3))]),
        obs_sigma2=np.ones(O), obs_stereo=np.zeros(O, bool), obs_valid=np.arange(O) < n,
        fx=fx, fy=fy, bf=0.0,
    )


@pytest.mark.parametrize("seed", [0, 1])
def test_local_ba_on_card_is_reproducible_and_matches_cpu(dev, seed):
    from orbslam3_cpp_fork_tpu_torch.optim.local_ba import local_ba

    d = _ba_window(seed)
    a = local_ba(convert.ba_problem_from_numpy(d, dev), iters=6, gate_at=3)
    b = local_ba(convert.ba_problem_from_numpy(d, dev), iters=6, gate_at=3)
    for x, y in ((a.R, b.R), (a.t, b.t), (a.Xw, b.Xw), (a.cost, b.cost)):
        assert torch.equal(x, y), "two runs on the card give the same bits (sorted segment sums)"
    c = local_ba(convert.ba_problem_from_numpy(d, "cpu"), iters=6, gate_at=3)
    assert float((a.t.cpu() - c.t).abs().max()) <= 1e-4, "tolerance: t within 1e-4 of the CPU"
    assert float((a.Xw.cpu() - c.Xw).abs().max()) <= 1e-3, "tolerance: Xw within 1e-3 of the CPU"
    assert bool(torch.isfinite(a.cost)) and abs(float(a.cost) - float(c.cost)) <= 1e-3 * float(c.cost)


def test_fetch_block_round_trip(dev):
    from orbslam3_cpp_fork_tpu_torch import device as device_mod

    g = torch.Generator().manual_seed(0)
    src = [torch.rand((3, 5), generator=g), torch.randint(0, 2**40, (7,), generator=g), torch.rand(4, generator=g) < 0.5,
           torch.tensor(17, dtype=torch.int32), torch.randint(-5, 5, (2, 3), generator=g).to(torch.int32)]
    n0 = device_mod.n_fetches
    out = device_mod.fetch_block([t.to(dev) for t in src])
    assert device_mod.n_fetches == n0 + 1, "one transfer for the whole block"
    for t, a in zip(src, out):
        assert a.dtype == t.numpy().dtype and a.shape == tuple(t.shape) and np.array_equal(a, t.numpy())


def test_async_fetch_on_the_card(dev):
    """The asynchronous block fetch: same arrays as `fetch_block`, through a
    caller-held pinned buffer, without a device-wide synchronization."""
    from orbslam3_cpp_fork_tpu_torch import device as device_mod

    g = torch.Generator().manual_seed(0)
    src = [torch.rand((1000, 2), generator=g), torch.randint(0, 2**40, (1000, 8), generator=g), torch.rand(1000, generator=g) < 0.5,
           torch.tensor(17, dtype=torch.int32), torch.randint(-5, 5, (4096,), generator=g).to(torch.int32)]
    on_card = [t.to(dev) for t in src]
    pinned = torch.empty(device_mod.block_nbytes(on_card) + 64, dtype=torch.uint8, pin_memory=True)
    n_sync = device_mod.n_fetches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # a synchronizing call would raise
    try:
        handle = device_mod.fetch_block_async(on_card, pinned)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    on_card[0].zero_()  # queued behind the copy: the block holds the old values
    out = handle.get()
    assert device_mod.n_fetches == n_sync, "not counted as a synchronizing fetch"
    for t, a in zip(src, out):
        assert a.dtype == t.numpy().dtype and a.shape == tuple(t.shape) and np.array_equal(a, t.numpy()), "tolerance: exact"
    own = device_mod.fetch_block_async([t.to(dev) for t in src]).get()  # allocates its own buffer
    assert all(np.array_equal(a, b) for a, b in zip(own, out))
    with pytest.raises(ValueError):
        device_mod.fetch_block_async(on_card, torch.empty(16, dtype=torch.uint8, pin_memory=True))
    with pytest.raises(ValueError):
        device_mod.fetch_block_async(on_card, torch.empty(1 << 20, dtype=torch.uint8))  # not pinned


def test_pipelined_frame_chain_on_the_card(dev):
    """A chain of pipelined frames (`pipeline_lag=2`, synchronous mapping) on
    the card: frames retire two late from the asynchronous fetch, the describe
    kernel runs once per frame, and the scale-aligned ATE is held against the
    same chain on the CPU (the two initial maps differ in their last bits, so
    the trajectories are compared through the ground truth, not pose by pose)."""
    from orbslam3_cpp_fork_tpu_torch.models.map_state import MapConfig
    from orbslam3_cpp_fork_tpu_torch.runtime import tracker as tt

    h, w, nf, n = 240, 320, 400, 36
    scene = synthetic.make_ring_scene(seed=7, n_points=900, size_range=(5, 9), width=w, height=h)
    Rs, ts = synthetic.circle_trajectory(n_frames=n, radius=2.5, total_angle=0.8 * np.pi * n / 120)
    frames = [synthetic.to_u8(synthetic.render_frame(scene, Rs[i], ts[i])) for i in range(n)]
    K = scene.K
    out = {}
    for d in (dev, torch.device("cpu")):
        cfg = tt.TrackerConfig(
            camera=convert.camera_from_numpy(K[0, 0], K[1, 1], K[0, 2], K[1, 2]), width=w, height=h,
            orb=orb.OrbParams(n_features=nf), async_mapping=False, pipeline_lag=2, pipeline_min_kfs=2,
            enable_loop_closing=False, map_cfg=MapConfig(max_keyframes=48, max_landmarks=4096),
            local_lm_cap=1024, ba_lm_cap=1024, ba_obs_cap=8192,
        )
        trk = tt.MonoTracker(cfg, d)
        if d.type == "cuda":
            patches.describe_counter(dev).zero_()
        for i, f in enumerate(frames):
            trk.track(f, 0.05 * i)
        assert len(trk._pipe) == 2, "two frames in flight"
        out[d.type] = (trk, trk.export_trajectory())
    trk = out["cuda"][0]
    assert trk.state == tt.TrackState.OK and trk.n_pipelined_frames > 15 and trk.n_frames_dropped == 0
    assert len(trk._pipe_bufs) == 3 and all(b.is_pinned() for b in trk._pipe_bufs), "one pinned buffer per pipeline slot"
    assert int(patches.describe_counter(dev)) == n, "one fused describe launch per frame, counted on the card"
    (ts_g, T_g), (ts_c, T_c) = out["cuda"][1], out["cpu"][1]
    from orbslam3_cpp_fork_tpu_torch.utils.evaluation import ate_rmse

    assert len(ts_g) > 0.7 * n and np.all(np.diff(ts_g) > 0)
    stamps = np.arange(n) * 0.05
    ate_g = ate_rmse(ts_g, T_g[:, :3, 3], stamps, ts).rmse_scaled
    ate_c = ate_rmse(ts_c, T_c[:, :3, 3], stamps, ts).rmse_scaled
    assert ate_g <= 2.0 * ate_c + 0.02, f"tolerance: card {ate_g} m against 2 x CPU {ate_c} m + 0.02 m"


def test_stereo_match_on_card_matches_cpu(dev):
    """The rectified stereo match (PyTorch ops, no hand kernel) on the card
    against the CPU on one pair of the stereo phase's scene: mask exact, ur
    and depth 1e-4 relative; two describe launches, one an image."""
    from orbslam3_cpp_fork_tpu_torch.ops import stereo

    scene = synthetic.make_ring_scene(seed=13, n_points=900, size_range=(9, 15), width=640, height=480)
    Rs, ts = synthetic.circle_trajectory(n_frames=220, radius=2.5, total_angle=2.3 * np.pi)
    imgs = [synthetic.to_u8(synthetic.render_frame(scene, Rs[0], ts[0])),
            synthetic.to_u8(synthetic.render_frame(scene, *synthetic.stereo_right_pose(Rs[0], ts[0], 0.2)))]
    bf = 0.2 * float(scene.K[0, 0])
    out = {}
    counter = patches.describe_counter(dev)
    c0 = int(counter)
    for d in (torch.device("cpu"), dev):
        il, ir = (torch.from_numpy(x.astype(np.float32)).to(d) for x in imgs)
        fl, fr = orb.extract_orb(il, orb.OrbParams(n_features=1000)), orb.extract_orb(ir, orb.OrbParams(n_features=1000))
        res = stereo.compute_stereo_matches(il, ir, fl.desc_i8, fl.xy, fl.level, fl.valid, fr.desc_i8, fr.xy, fr.level,
                                            fr.valid, bf, 0.2)
        out[d.type] = [x.cpu().numpy() for x in res]
    assert int(counter) - c0 == 2
    (ur_c, d_c, ok_c), (ur_g, d_g, ok_g) = out["cpu"], out["cuda"]
    assert ok_c.sum() > 100 and np.array_equal(ok_g, ok_c), "mask exact"
    np.testing.assert_allclose(ur_g, ur_c, rtol=1e-4)
    np.testing.assert_allclose(d_g, d_c, rtol=1e-4)


def test_remap_on_card_matches_cpu(dev):
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (480, 752)).astype(np.float32)
    mx = rng.uniform(-3, 755, (480, 752)).astype(np.float32)
    my = rng.uniform(-3, 483, (480, 752)).astype(np.float32)
    ref = image.remap_bilinear(*(torch.from_numpy(a) for a in (img, mx, my))).numpy()
    got = image.remap_bilinear(*(torch.from_numpy(a).to(dev) for a in (img, mx, my))).cpu().numpy()
    assert np.abs(got - ref).max() <= 1e-4 * 255, "tolerance: 1e-4 of the gray range"


def test_merge_on_card_matches_cpu(dev):
    """`_execute_merge` from tests/merge_rig.py's two-map state on the card
    and on the CPU: the fuse's bindings exact; after the welding BA and the
    merge essential graph R within 1e-4, Xw within 1e-3 (the window BA's card
    tolerances), t within 2e-4 (near convergence the LM accept test of the
    welding BA takes another step on the card than on the CPU, as between
    the two implementations in tests/test_torch_merge.py: 1.5e-4 on the
    merged keyframes, NVIDIA H100), the live pose within 1e-4."""
    import merge_rig

    from orbslam3_cpp_fork_tpu_torch.runtime import tracker as tt

    scene, atlas_np, S_kc = merge_rig.two_map_state()
    out = {}
    for d in (dev, torch.device("cpu")):
        trk = merge_rig.loaded_port_tracker(scene, atlas_np, d)
        f = merge_rig.live_frame(tt, atlas_np["maps"][1], merge_rig.K_B)
        trk._execute_merge(merge_rig.K_B, f, 0, merge_rig.C_A, S_kc, 1, merge_rig.K_B)
        out[d.type] = (trk.map, f, trk._kf_alias)
    (a, fa, ala), (b, fb, alb) = out["cuda"], out["cpu"]
    assert ala == alb and len(ala) == 14 and a.n_keyframes() == b.n_keyframes() == 26
    assert np.array_equal(a.kf_lm_idx, b.kf_lm_idx), "bindings after the fuse: tolerance exact"
    assert np.abs(a.kf_R - b.kf_R).max() <= 1e-4, "tolerance: R within 1e-4 of the CPU"
    assert np.abs(a.kf_t - b.kf_t).max() <= 2e-4, "tolerance: t within 2e-4 of the CPU"
    assert np.abs(a.lm_pos - b.lm_pos)[a.lm_valid].max() <= 1e-3, "tolerance: Xw within 1e-3 of the CPU"
    assert np.abs(fa.t - fb.t).max() <= 1e-4 and np.abs(fa.R - fb.R).max() <= 1e-4, "tolerance: live pose 1e-4"


@pytest.mark.parametrize("mode", ["sim3", "se3"])
def test_merge_essential_graph_on_card_matches_cpu(dev, mode):
    import merge_rig

    from orbslam3_cpp_fork_tpu_torch.runtime.loop_closing import optimize_essential_graph_merge

    maps = []
    for d in (dev, "cpu"):
        m = merge_rig.line_map()
        R_snap, t_snap = m.kf_R.copy(), m.kf_t.copy()
        for k in (10, 11):
            m.kf_t[k] -= np.array([0.0, 0.3, 0.0], np.float32)
        optimize_essential_graph_merge(m, list(range(2, 10)), R_snap, t_snap, mode, covis_edge_weight=8, device=d)
        maps.append(m)
    a, b = maps
    assert np.abs(a.kf_t - b.kf_t).max() <= 1e-4 and np.abs(a.kf_R - b.kf_R).max() <= 1e-4, "tolerance: 1e-4"
    assert np.abs(a.lm_pos - b.lm_pos).max() <= 1e-3, "tolerance: landmarks within 1e-3 of the CPU"
    assert -a.kf_R[9].T @ a.kf_t[9] @ np.array([0, 1, 0]) > 0.15, "the correction reached the free keyframes"
