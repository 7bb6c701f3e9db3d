"""The port's drivers on the KITTI and TUM RGB-D layouts (the TUM-VI and
EuRoC stereo-inertial ones: test_torch_driver_trees_imu.py), each in-process
on the CPU on a tiny tree written by chip_smoke.py's tree writers (5 frames
at 320x240, 800 features). Each driver runs the synchronous control
(`async_mapping=False` patched into its System) and must write the same
trajectory bytes as the port's `System` driven directly on the same loaded
frames (tests/driver_trees.py). Also ROADMAP R18: the TUM loader's meters
are divided again by the settings' RGBD.DepthMapFactor, in both
implementations.
"""

import numpy as np
import pytest
import torch

import chip_smoke
import driver_trees
from orbslam3_cpp_fork_tpu_torch.datasets import tum
from orbslam3_cpp_fork_tpu_torch.runtime.system import System
from orbslam3_cpp_fork_tpu_torch.runtime.tracker import Sensor


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name, sensor", [
    ("stereo_kitti", Sensor.STEREO),
    ("rgbd_tum", Sensor.RGBD),
])
def test_driver_on_its_layout_equals_system(tmp_path, monkeypatch, name, sensor):
    driver_trees.driver_equals_system(tmp_path, monkeypatch, name, sensor)


def test_tum_depth_factor_applied_twice_r18(tmp_path):
    """ROADMAP R18, in both implementations: datasets/tum.py's load_depth
    returns meters (the PNG over 5000), and System takes the settings'
    RGBD.DepthMapFactor (5000 in the ORB-SLAM3 TUM YAMLs) as a further
    divisor, so a tree with the published factor reaches the tracker at
    1/5000 of its depth. The port copies it; the smoke's trees leave the key
    out."""
    from orbslam3_cpp_fork_tpu.datasets import tum as jtum
    from orbslam3_cpp_fork_tpu.runtime import system as jsystem
    from orbslam3_cpp_fork_tpu.runtime import tracker as jtracker
    from PIL import Image

    d = np.full((4, 6), 2.5, np.float32)
    Image.fromarray(np.round(d * 5000).astype(np.uint16)).save(tmp_path / "d.png")
    assert np.allclose(tum.load_depth(str(tmp_path / "d.png")), 2.5)
    assert np.allclose(jtum.load_depth(str(tmp_path / "d.png")), 2.5)
    sc = chip_smoke.driver_scene("rgbd_tum", small=True, count=1)
    chip_smoke.write_driver_settings(tmp_path / "tum.yaml", "rgbd_tum", sc)
    text = (tmp_path / "tum.yaml").read_text()
    assert "DepthMapFactor" not in text
    (tmp_path / "tum1.yaml").write_text(text + "RGBD.DepthMapFactor: 5000.0\n")
    for slam in (System(str(tmp_path / "tum1.yaml"), Sensor.RGBD, async_mapping=False, device="cpu"),
                 jsystem.System(str(tmp_path / "tum1.yaml"), jtracker.Sensor.RGBD, async_mapping=False)):
        assert slam.tracker.cfg.depth_factor == pytest.approx(1 / 5000.0)
        slam.shutdown()
