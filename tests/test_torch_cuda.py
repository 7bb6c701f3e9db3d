"""The port's CUDA kernel against its plain PyTorch version, on the card.

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
        pytest.skip("needs a CUDA card (the patch-gather kernel has no CPU mode)")
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
    before = patches.launches
    for i in range(3):
        f = synthetic.to_u8(synthetic.render_frame(scene, Rs[i], ts[i]))
        Tg = trk[dev].track(f, 0.05 * i).cpu().numpy()
        Tc = trk[torch.device("cpu")].track(f, 0.05 * i).numpy()
        dC = np.linalg.norm(-Tg[:3, :3].T @ Tg[:3, 3] + Tc[:3, :3].T @ Tc[:3, 3])
        assert dC <= 1e-3, f"frame {i}: tolerance 1 mm between card and CPU; got {dC}"
    assert patches.launches - before >= 3 * 8
