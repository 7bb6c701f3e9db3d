"""The port's drivers on the TUM-VI (fisheye stereo, imu0) and EuRoC
stereo-inertial layouts, each in-process on the CPU on a tiny tree written
by chip_smoke.py's tree writers (5 pairs at 256x256 fisheye or 320x240, 800
features), byte for byte against the port's `System` driven directly on the
same loaded frames and IMU rows (tests/driver_trees.py).
"""

import pytest
import torch

import driver_trees
from orbslam3_cpp_fork_tpu_torch.runtime.tracker import Sensor


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", ["stereo_inertial_tumvi", "stereo_inertial_euroc"])
def test_driver_on_its_layout_equals_system(tmp_path, monkeypatch, name):
    driver_trees.driver_equals_system(tmp_path, monkeypatch, name, Sensor.IMU_STEREO)
