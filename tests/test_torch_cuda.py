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
