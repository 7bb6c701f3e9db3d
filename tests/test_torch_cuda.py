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


def _gathered_once(levels, blurred, xys):
    """One batched gather launch, with the host and card counts of it."""
    dev = xys[0].device
    counter = patches.gather_counter(dev)
    torch.cuda.synchronize()
    counter.zero_()
    before = patches.launches
    out = patches.extract_patches_levels(levels, blurred, xys)
    torch.cuda.synchronize()
    assert patches.launches - before == 1 and int(counter) == 1, "one launch, counted by the wrapper and the card"
    return out


@pytest.mark.parametrize("hw,n_features", [((480, 752), 1000), ((376, 1241), 2000)], ids=["ring", "kitti"])
def test_kernel_matches_plain_at_every_level(dev, hw, n_features):
    """All levels of a real pyramid in one launch (KITTI's 2,496 slots: two
    waves of blocks)."""
    p = orb.OrbParams(n_features=n_features)
    img = torch.from_numpy(_frame(*hw)[3].astype(np.float32)).to(dev)
    levels = [lvl.contiguous() for lvl in image.build_pyramid(img)]
    blurred = [image.gaussian_blur7(lvl).contiguous() for lvl in levels]
    xys = [orb.level_keypoints(lvl, orb.level_caps(p)[l], p)[0].contiguous() for l, lvl in enumerate(levels)]
    got = _gathered_once(levels, blurred, xys)
    assert got.shape == (2, sum(orb.level_caps(p)), 40, 40)
    start = 0
    for l, (lvl, blur, xy) in enumerate(zip(levels, blurred, xys)):
        end = start + xy.shape[0]
        assert torch.equal(got[0, start:end], patches._gather_plain(lvl, xy)), f"level {l}: tolerance bitwise"
        assert torch.equal(got[1, start:end], patches._gather_plain(blur, xy)), f"level {l}: tolerance bitwise"
        start = end


@pytest.mark.parametrize("n", [1, 127, 129, 1000])
def test_kernel_matches_plain_edge_cases(dev, n):
    """One image and one level (`extract_patches`), then three levels with
    an empty one between: keypoints on and beyond the border."""
    h, w = 133, 211
    g = torch.Generator().manual_seed(n)

    def kps(hh, ww, k):
        xy = torch.stack([torch.randint(-30, ww + 30, (k,), generator=g), torch.randint(-30, hh + 30, (k,), generator=g)], 1)
        xy[: min(k, 4)] = torch.tensor([[0, 0], [ww - 1, hh - 1], [0, hh - 1], [ww - 1, 0]])[: min(k, 4)]
        return xy.to(torch.int32).to(dev)

    img = (torch.rand((h, w), generator=g) * 255).to(dev)
    xy = kps(h, w, n)
    assert torch.equal(patches.extract_patches(img, xy), patches._gather_plain(img, xy)), "tolerance: bitwise"
    levels = [img, img[:50, :64].contiguous(), img[10:51, 20:63].contiguous()]
    blurred = [image.gaussian_blur7(lvl).contiguous() for lvl in levels]
    xys = [xy, torch.zeros((0, 2), dtype=torch.int32, device=dev), kps(41, 43, n)]
    got = _gathered_once(levels, blurred, xys)
    for i, imgs in enumerate((levels, blurred)):
        ref = torch.cat([patches._gather_plain(im, k) for im, k in zip(imgs, xys)])
        assert torch.equal(got[i], ref), "tolerance: bitwise"


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


# ----------------------------------------------------------------- inertial


def _circle(t, r=2.0, w=0.6):
    """Body state on a horizontal circle at angular rate w: Rwb, p, v, world
    acceleration, body rates (tests/test_inertial.py's `circle_state`)."""
    c, s = np.cos(w * t), np.sin(w * t)
    x_b, z_b = np.array([-s, c, 0.0]), np.array([c, s, 0.0])
    Rwb = np.stack([x_b, np.cross(z_b, x_b), z_b], axis=1)
    return (Rwb.astype(np.float32), np.array([r * c, r * s, 0.0], np.float32),
            (r * w * np.array([-s, c, 0.0])).astype(np.float32), -r * w * w * np.array([c, s, 0.0]),
            Rwb.T @ np.array([0.0, 0.0, w]))


def _imu_rows(t0, t1, freq=200.0):
    """Exact IMU rows [dt, acc, gyro] on the circle over [t0, t1]."""
    n = max(int(round((t1 - t0) * freq)), 1)
    dt = (t1 - t0) / n
    rows = []
    for k in range(n):
        Rwb, _, _, a_w, w_b = _circle(t0 + (k + 0.5) * dt)
        rows.append(np.concatenate([[dt], Rwb.T @ (a_w - np.array([0.0, 0.0, -9.81])), w_b]))
    return np.asarray(rows, np.float32)


def _calib(device):
    from orbslam3_cpp_fork_tpu_torch.ops import imu

    return imu.ImuCalib.create(1.7e-4, 2e-3, 1.9e-5, 3e-3, 200.0, device=device)


def _preint(rows, device, bias=None):
    from orbslam3_cpp_fork_tpu_torch.ops import imu

    r = torch.from_numpy(rows).to(device)
    b = torch.zeros(6, device=device) if bias is None else torch.from_numpy(bias).to(device)
    return imu.preintegrate(r[:, 1:4], r[:, 4:7], r[:, 0], _calib(device), b[:3], b[3:])


def test_preintegrate_on_card_matches_cpu(dev):
    """64 seeded rows at seeded biases: every field within 1e-5 of its
    largest magnitude."""
    rng = np.random.default_rng(0)
    rows = np.concatenate([np.full((64, 1), 0.005), rng.normal(0, 1, (64, 3)) + [0, 0, 9.81],
                           rng.normal(0, 0.5, (64, 3))], 1).astype(np.float32)
    bias = rng.normal(0, 0.02, 6).astype(np.float32)
    a, b = _preint(rows, dev, bias), _preint(rows, "cpu", bias)
    for f in convert.PREINT_FIELDS:
        x, y = getattr(a, f).cpu(), getattr(b, f)
        assert float((x - y).abs().max()) <= 1e-5 * max(float(y.abs().max()), 1e-30), f


@pytest.mark.parametrize("anchor_fixed", [True, False])
def test_pose_inertial_optimization_on_card_matches_cpu(dev, anchor_fixed):
    """tests/test_inertial.py's pose problem (made here without the
    reference): the frame state within 1e-4 of the CPU's, biases 1e-5,
    inliers exact, the marginal prior 1e-3 relative."""
    from orbslam3_cpp_fork_tpu_torch.optim import inertial as vi

    rng = np.random.default_rng(1)
    R1, p1, v1, _, _ = _circle(0.0)
    R2, p2, v2, _, _ = _circle(0.4)
    pc = np.concatenate([rng.uniform(-2, 2, (160, 2)), rng.uniform(4, 12, (160, 1))], 1)
    Xw = (pc @ R2.T + p2).astype(np.float32)
    uv = 400.0 * pc[:, :2] / pc[:, 2:] + rng.normal(0, 0.3, (160, 2))
    uvr = np.concatenate([uv, np.zeros((160, 1))], 1).astype(np.float32)
    dR = np.asarray(_circle(0.05)[0] @ _circle(0.0)[0].T, np.float32)
    H = None if anchor_fixed else (np.eye(15) * 50.0).astype(np.float32)
    out = {}
    for d in (dev, "cpu"):
        def T(x):
            return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(d)

        z = torch.zeros(3, device=d)
        res = vi.pose_inertial_optimization(
            T(R1), T(p1), T(v1), z, z, T(R2 @ dR), T(p2 + [0.05, -0.04, 0.06]), T(v2 + [0.2, -0.1, 0.15]), z, z,
            _preint(_imu_rows(0.0, 0.4), d), T(Xw), T(uvr), torch.ones(160, device=d),
            torch.ones(160, dtype=torch.bool, device=d), torch.zeros(160, dtype=torch.bool, device=d),
            torch.eye(3, device=d), z, 400.0, 400.0, 0.0, H_prior=None if H is None else T(H), anchor_fixed=anchor_fixed,
        )
        out[str(d)] = {k: getattr(res, k).cpu() for k in ("Rwb", "p", "v", "bg", "ba", "inliers", "H_marg")}
    g, c = out[str(dev)], out["cpu"]
    for k in ("Rwb", "p", "v"):
        assert float((g[k] - c[k]).abs().max()) <= 1e-4, k
    for k in ("bg", "ba"):
        assert float((g[k] - c[k]).abs().max()) <= 1e-5, k
    assert torch.equal(g["inliers"], c["inliers"]) and int(g["inliers"].sum()) > 100
    assert float((g["H_marg"] - c["H_marg"]).abs().max()) <= 1e-3 * float(c["H_marg"].abs().max())


def _vi_problem(seed=3, n_kf=6, n_lm=96, pad_o=64):
    """A temporal window of the circle with shared landmarks, every state
    but the first perturbed (tests/test_sparse_ba.py's `_make_vi_problem`,
    made here without the reference), as a dict for
    `convert.vi_problem_from_numpy`, with its preintegrations."""
    rng = np.random.default_rng(seed)
    states = [_circle(0.4 * k) for k in range(n_kf)]
    Rwb = np.stack([s[0] for s in states])
    p = np.stack([s[1] for s in states])
    v = np.stack([s[2] for s in states])
    pc0 = np.concatenate([rng.uniform(-2, 2, (n_lm, 2)), rng.uniform(4, 12, (n_lm, 1))], 1)
    Xw = pc0 @ Rwb[0].T + p[0]
    o_kf, o_lm, o_uv = [], [], []
    for k in range(n_kf):
        pc = (Xw - p[k]) @ Rwb[k]
        uv = 400.0 * pc[:, :2] / np.maximum(pc[:, 2:], 1e-6) + rng.normal(0, 0.3, (n_lm, 2))
        ids = np.nonzero((pc[:, 2] > 0.5) & (np.abs(uv) < 400).all(1))[0]
        o_kf += [k] * len(ids)
        o_lm += list(ids)
        o_uv.append(uv[ids])
    O = len(o_kf)
    Rp, pp, vp = Rwb.copy(), p.copy(), v.copy()
    for k in range(1, n_kf):
        w = rng.normal(0, 0.01, 3)
        Rp[k] = Rp[k] @ torch.linalg.matrix_exp(torch.tensor([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])).numpy()
        pp[k] = pp[k] + rng.normal(0, 0.03, 3)
        vp[k] = vp[k] + rng.normal(0, 0.1, 3)
    pres = [convert.preintegrated_to_numpy(_preint(_imu_rows(0.4 * k, 0.4 * (k + 1)), "cpu")) for k in range(n_kf - 1)]
    fixed = np.zeros(n_kf, bool)
    fixed[0] = True
    return dict(
        Rwb=Rp, twb=pp, vel=vp, bg=np.zeros((n_kf, 3)), ba=np.zeros((n_kf, 3)), kf_valid=np.ones(n_kf, bool),
        kf_fixed=fixed, Xw=Xw + rng.normal(0, 0.03, Xw.shape), lm_valid=np.ones(n_lm, bool),
        obs_kf=np.concatenate([o_kf, np.zeros(pad_o)]), obs_lm=np.concatenate([o_lm, np.zeros(pad_o)]),
        obs_uvr=np.concatenate([np.concatenate([np.concatenate(o_uv), np.zeros((O, 1))], 1), np.zeros((pad_o, 3))]),
        obs_sigma2=np.ones(O + pad_o), obs_stereo=np.zeros(O + pad_o, bool), obs_valid=np.arange(O + pad_o) < O,
        edge_i=np.arange(n_kf - 1), edge_j=np.arange(1, n_kf), edge_valid=np.ones(n_kf - 1, bool),
        pre={k: np.stack([d[k] for d in pres]) for k in convert.PREINT_FIELDS},
        Rcb=np.eye(3), tcb=np.zeros(3), fx=400.0, fy=400.0, bf=0.0, prior_kf=n_kf - 1, prior_g=1e2, prior_a=1e5,
    )


@pytest.mark.parametrize("solver", ["dense", "sparse"])
def test_vi_ba_on_card_is_reproducible_and_matches_cpu(dev, solver):
    """`visual_inertial_ba` / `sparse_vi_ba` on the card: two runs give the
    same bits, and the states are within 1e-4 (landmarks 1e-3) of the CPU's."""
    from orbslam3_cpp_fork_tpu_torch.optim.inertial import visual_inertial_ba
    from orbslam3_cpp_fork_tpu_torch.optim.sparse_ba import sparse_vi_ba

    solve = visual_inertial_ba if solver == "dense" else sparse_vi_ba
    d = _vi_problem()
    a = solve(convert.vi_problem_from_numpy(d, dev), iters=10, gate_at=5)
    b = solve(convert.vi_problem_from_numpy(d, dev), iters=10, gate_at=5)
    c = solve(convert.vi_problem_from_numpy(d, "cpu"), iters=10, gate_at=5)
    for k in ("Rwb", "twb", "vel", "bg", "ba", "Xw"):
        assert torch.equal(getattr(a, k), getattr(b, k)), f"{k}: two runs on the card give the same bits"
        tol = 1e-3 if k == "Xw" else 1e-4
        assert float((getattr(a, k).cpu() - getattr(c, k)).abs().max()) <= tol, k
    assert float(np.linalg.norm(a.twb.cpu().numpy() - np.stack([_circle(0.4 * k)[1] for k in range(6)]), axis=1).mean()) \
        < 0.4 * float(np.linalg.norm(d["twb"] - np.stack([_circle(0.4 * k)[1] for k in range(6)]), axis=1).mean())


def test_graphed_calls_replay_the_eager_bits(dev):
    """`device.GraphedCall`: the VI pose optimization and a padded
    preintegration replayed from CUDA graphs give the eager call's bits, for
    a second set of inputs too (the graph's inputs are copied in)."""
    from orbslam3_cpp_fork_tpu_torch.device import GraphedCall
    from orbslam3_cpp_fork_tpu_torch.ops import imu
    from orbslam3_cpp_fork_tpu_torch.optim import inertial as vi

    calib = _calib(dev)
    fields = convert.PREINT_FIELDS

    def preint(b, *state):
        s0 = imu.Preintegrated(*state)
        out = imu.preintegrate(b[:, 1:4], b[:, 4:7], b[:, 0], calib, s0.bias_gyro, s0.bias_acc, init=s0,
                               valid=b[:, 7] > 0)
        return [getattr(out, f) for f in fields]

    z = torch.zeros(3, device=dev)
    call = GraphedCall(preint)
    for t1 in (0.1, 0.3):
        rows = _imu_rows(0.0, t1)[:20]
        buf = np.zeros((24, 8), np.float32)
        buf[: len(rows), :7] = rows
        buf[: len(rows), 7] = 1.0
        b = torch.from_numpy(buf).to(dev)
        init = imu.Preintegrated.identity(z, z)
        got = call(b, *[getattr(init, f) for f in fields])
        ref = preint(b, *[getattr(init, f) for f in fields])
        assert all(torch.equal(g, r) for g, r in zip(got, ref))

    def pose(*a):
        res = vi.pose_inertial_optimization(*a[:10], imu.Preintegrated(*a[10:22]), *a[22:29], 400.0, 400.0, 0.0,
                                            anchor_fixed=True)
        return res.Rwb, res.p, res.v, res.bg, res.ba, res.H_marg, res.inliers

    call = GraphedCall(pose)
    rng = np.random.default_rng(2)
    for shift in (0.0, 0.02):
        R1, p1, v1, _, _ = _circle(0.0)
        R2, p2, v2, _, _ = _circle(0.4)
        pc = np.concatenate([rng.uniform(-2, 2, (256, 2)), rng.uniform(4, 12, (256, 1))], 1)
        Xw = (pc @ R2.T + p2).astype(np.float32)
        uvr = np.concatenate([400.0 * pc[:, :2] / pc[:, 2:], np.zeros((256, 1))], 1).astype(np.float32)

        def T(x):
            return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(dev)

        pre = _preint(_imu_rows(0.0, 0.4), dev)
        a = [T(R1), T(p1), T(v1), z, z, T(R2), T(p2 + shift), T(v2), z, z, *[getattr(pre, f) for f in fields],
             T(Xw), T(uvr), torch.ones(256, device=dev), torch.ones(256, dtype=torch.bool, device=dev),
             torch.zeros(256, dtype=torch.bool, device=dev), torch.eye(3, device=dev), z]
        assert all(torch.equal(g, r) for g, r in zip(call(*a), pose(*a)))


@pytest.mark.parametrize("sensor", ["IMU_STEREO", "IMU_RGBD"])
def test_inertial_system_tracks_on_the_card(dev, sensor):
    """System(settings, IMU_STEREO | IMU_RGBD) on the card: the map starts at
    the first frame and every frame of a short circle with its IMU rows is
    tracked (IMU_MONOCULAR runs in chip_smoke.py's inertial phase)."""
    from orbslam3_cpp_fork_tpu_torch.runtime.system import System
    from orbslam3_cpp_fork_tpu_torch.runtime.tracker import Sensor, TrackState
    from orbslam3_cpp_fork_tpu_torch.utils import settings as tsettings

    scene = synthetic.make_ring_scene(seed=5)
    K = scene.K
    s = tsettings.Settings(
        camera_type="PinHole", camera=convert.camera_from_numpy(K[0, 0], K[1, 1], K[0, 2], K[1, 2]),
        width=scene.width, height=scene.height, fps=10.0, rgb=False, n_features=1000, scale_factor=1.2,
        n_levels=8, ini_th_fast=20, min_th_fast=7, bf=0.2 * K[0, 0], stereo_th_depth=40.0, depth_map_factor=1.0,
        imu=tsettings.ImuSettings(noise_gyro=1.7e-4, noise_acc=2e-3, walk_gyro=1.9e-5, walk_acc=3e-3,
                                  frequency=200.0, Tbc=np.eye(4, dtype=np.float32)),
    )
    system = System(s, Sensor[sensor], async_mapping=False, enable_loop_closing=False, device=dev)
    try:
        for i in range(4):
            t = 0.1 * i
            Rwb, p, _, _, _ = _circle(t)
            img = synthetic.to_u8(synthetic.render_frame(scene, Rwb, p))
            rows = None
            if i:
                r = _imu_rows(t - 0.1, t)
                rows = np.concatenate([(t - 0.1 + np.cumsum(r[:, 0]))[:, None], r[:, 1:]], 1).astype(np.float32)
            if sensor == "IMU_STEREO":
                right = synthetic.to_u8(synthetic.render_frame(scene, *synthetic.stereo_right_pose(Rwb, p, 0.2)))
                T = system.track_stereo(img, right, t, imu=rows)
            else:
                T = system.track_rgbd(img, synthetic.render_depth(scene, Rwb, p), t, imu=rows)
            assert T is not None and np.isfinite(T).all(), i
        assert system.get_tracking_state() == TrackState.OK and system.tracker.inertial
    finally:
        system.shutdown()


def test_sharded_global_ba_over_two_gloo_ranks_on_the_card(dev):
    """The dry run's whole-map BA sharded over two gloo ranks, both on this
    card: the ranks and two runs bitwise equal, within tests/test_dist_ba.py's
    bars of the local solve on the card (t and R 2e-3, Xw 5e-3); and the
    dry run itself takes the tracker's sharded path."""
    from orbslam3_cpp_fork_tpu_torch.entry import dryrun_map, dryrun_multichip
    from orbslam3_cpp_fork_tpu_torch.optim.sparse_ba import sparse_ba
    from orbslam3_cpp_fork_tpu_torch.parallel import launch

    out = dryrun_multichip(2)
    assert [o["sharded_solves"] for o in out] == [1, 1]
    tr, _, _ = dryrun_map(dev, 2)
    prob = tr._gba_problem(tr._gba_gather())
    kw = dict(iters=10, gate_at=5)
    local = launch.to_host(sparse_ba(prob, **kw))
    ranks = launch.run_ranks(launch.solve_sharded, 2, [(launch.to_host(prob), kw)] * 2, backend="gloo")
    first = ranks[0][0]["result"]
    for r in ranks:
        for job in r:
            for k in ("R", "t", "Xw", "cost", "obs_inlier"):
                assert np.array_equal(getattr(job["result"], k), getattr(first, k)), k
    kf = tr.map.kf_valid
    np.testing.assert_allclose(first.t[kf], local.t[kf], atol=2e-3)
    chord = np.linalg.norm(first.R[kf].astype(np.float64) - local.R[kf], axis=(-2, -1))
    assert (2 * np.arcsin(np.clip(chord / (2 * np.sqrt(2)), 0, 1))).max() < 2e-3
    np.testing.assert_allclose(first.Xw, local.Xw, atol=5e-3)


def test_entry_on_the_card(dev):
    """entry(): its inputs on the card, one describe launch a call counted on
    the card, the result finite and within 1e-3 of the same fn on the CPU."""
    from orbslam3_cpp_fork_tpu_torch.entry import entry

    fn, args = entry()
    assert all(a.device == dev for a in args)
    counter = patches.describe_counter(dev)
    torch.cuda.synchronize()
    counter.zero_()
    R2, t2, n_in = fn(*args)
    torch.cuda.synchronize()
    assert int(counter) == 1
    fn_c, args_c = entry("cpu")
    Rc, tc, nc = fn_c(*args_c)
    assert int(n_in) == int(nc) and torch.isfinite(R2).all() and torch.isfinite(t2).all()
    assert float((R2.cpu() - Rc).abs().max()) <= 1e-3 and float((t2.cpu() - tc).abs().max()) <= 1e-3
