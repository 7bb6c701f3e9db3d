"""Shared by tests/test_torch_driver_trees*.py: a port driver run in-process
on the CPU on a tiny tree written by chip_smoke.py, against the port's
`System` driven directly on the same loaded frames (and IMU rows)."""

import functools
import importlib

import numpy as np

import chip_smoke
from orbslam3_cpp_fork_tpu_torch.datasets import euroc, kitti, tum, tumvi
from orbslam3_cpp_fork_tpu_torch.runtime.system import System


def _rows(imu, t_prev, t):
    """The drivers' per-frame IMU rows [t, acc, gyro] over (t_prev, t]."""
    if t_prev is None:
        return None
    acc, gyro, _ = euroc.imu_between(imu, t_prev, t)
    ts = imu.timestamps[(imu.timestamps > t_prev) & (imu.timestamps <= t)]
    return np.concatenate([ts[:, None], acc, gyro], axis=1).astype(np.float32)


def _direct(name, settings, root, seq, sensor, out):
    """System driven directly with the frames the driver loads."""
    slam = System(settings, sensor, async_mapping=False, device="cpu")
    if name == "stereo_kitti":
        s = kitti.load_sequence(root, seq, stereo=True)
        for i, t in enumerate(s.timestamps):
            slam.track_stereo(kitti.load_gray(s.image_paths[i]), kitti.load_gray(s.image_paths_right[i]), float(t))
    elif name == "rgbd_tum":
        s = tum.load_sequence(root, seq)
        for i, t in enumerate(s.timestamps):
            slam.track_rgbd(tum.load_gray(s.rgb_paths[i]), tum.load_depth(s.depth_paths[i]), float(t))
    else:
        s = (tumvi if "tumvi" in name else euroc).load_sequence(root, seq, None, stereo=True)
        t_prev = None
        for i, t in enumerate(s.timestamps):
            slam.track_stereo(euroc.load_gray(s.image_paths[i]), euroc.load_gray(s.image_paths_right[i]), float(t),
                              imu=_rows(s.imu, t_prev, float(t)))
            t_prev = float(t)
    slam.save_trajectory_tum(str(out))
    slam.shutdown()


def driver_equals_system(tmp_path, monkeypatch, name, sensor):
    """The driver's trajectory file (synchronous control patched into its
    System): > 80% of the frames in time order, and byte for byte the file
    of `System` driven directly."""
    sc = chip_smoke.driver_scene(name, small=True)
    settings, root, seq = chip_smoke.write_driver_tree(tmp_path, name, sc)
    module = importlib.import_module(f"orbslam3_cpp_fork_tpu_torch.examples.{name}")
    monkeypatch.setattr(module, "System", functools.partial(System, async_mapping=False))
    traj = tmp_path / "traj.txt"
    module.main([settings, root, seq, "--traj", str(traj), "--kf-traj", str(tmp_path / "kf.txt"),
                 "--log-level", "WARNING", "--device", "cpu"])
    lines = traj.read_text().splitlines()
    assert len(lines) > 0.8 * sc["n"], lines
    stamps = np.array([float(x.split()[0]) for x in lines])
    assert np.all(np.diff(stamps) > 0)
    _direct(name, settings, root, seq, sensor, tmp_path / "direct.txt")
    assert traj.read_bytes() == (tmp_path / "direct.txt").read_bytes()


