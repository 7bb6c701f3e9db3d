"""The port's dataset loaders and command-line drivers
(orbslam3_cpp_fork_tpu_torch/examples/) on rendered on-disk datasets:
tests/test_datasets_cli.py on the port, with its 14-frame trees and 600
features.

The EuRoC mono driver runs in-process (`main(argv)`) on the CPU and must
write the same trajectory bytes as the port's `System` driven directly on
the same frames; both run the synchronous control (`async_mapping=False`,
patched into the driver's System), because the default mode's mapping thread
makes no two runs bit-equal. The reference test's gates hold on the file.
Every reference driver has its port counterpart, one to one, and each parses
its arguments with the `--device` flag added.
"""

import functools
import importlib
import os

import numpy as np
import pytest
import torch
from PIL import Image

import chip_smoke
from orbslam3_cpp_fork_tpu_torch.datasets import euroc, kitti, synthetic, tum
from orbslam3_cpp_fork_tpu_torch.runtime.system import System
from orbslam3_cpp_fork_tpu_torch.runtime.tracker import Sensor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FRAMES = 14

YAML = """%YAML:1.0
File.version: "1.0"
Camera.type: "PinHole"
Camera1.fx: {fx}
Camera1.fy: {fy}
Camera1.cx: {cx}
Camera1.cy: {cy}
Camera.width: {w}
Camera.height: {h}
Camera.fps: 20.0
Camera.RGB: 1
ORBextractor.nFeatures: 600
{extra}
"""


@pytest.fixture(scope="module", autouse=True)
def _two_torch_threads():
    """Two tracking runs of 14 frames at 640x480: two intra-op threads, not
    the default team that spins against the other test workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rendered():
    scene = synthetic.make_scene(seed=3)
    Rs, ts = synthetic.smooth_trajectory(n_frames=N_FRAMES, step=0.12, yaw_rate=0.002)
    frames = synthetic.render_sequence(scene, Rs, ts)
    return scene, Rs, ts, frames


def _save_png(path, img):
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8)).save(path)


def test_euroc_loader_and_mono_cli(rendered, tmp_path, monkeypatch):
    scene, Rs, ts, frames = rendered
    seq_dir = tmp_path / "MH88" / "mav0"
    cam0 = seq_dir / "cam0" / "data"
    cam0.mkdir(parents=True)
    stamps_ns = [int(1e9 * 0.05 * i) + 1403636579763555584 for i in range(len(frames))]
    for ns, f in zip(stamps_ns, frames):
        _save_png(str(cam0 / f"{ns}.png"), f)
    imu_dir = seq_dir / "imu0"
    imu_dir.mkdir(parents=True)
    with open(imu_dir / "data.csv", "w") as f:
        f.write("#timestamp,wx,wy,wz,ax,ay,az\n")
        for i in range(100):
            f.write(f"{stamps_ns[0] + i * 5_000_000},0,0,0,0,0,-9.81\n")

    seq = euroc.load_sequence(str(tmp_path), "MH88")
    assert len(seq.image_paths) == len(frames)
    assert seq.imu is not None and len(seq.imu.timestamps) == 100
    img = euroc.load_gray(seq.image_paths[0])
    assert img.shape == (scene.height, scene.width)
    acc, gyro, dts = euroc.imu_between(seq.imu, seq.timestamps[0], seq.timestamps[1])
    assert len(acc) == 10 and abs(dts.sum() - 0.05) < 1e-3

    yaml_path = tmp_path / "euroc.yaml"
    yaml_path.write_text(YAML.format(fx=scene.K[0, 0], fy=scene.K[1, 1], cx=scene.K[0, 2], cy=scene.K[0, 2],
                                     w=scene.width, h=scene.height, extra=""))
    from orbslam3_cpp_fork_tpu_torch.examples import mono_euroc

    monkeypatch.setattr(mono_euroc, "System", functools.partial(System, async_mapping=False))
    traj = tmp_path / "traj.txt"
    mono_euroc.main([str(yaml_path), str(tmp_path), "MH88", "--traj", str(traj), "--kf-traj", str(tmp_path / "kf.txt"),
                     "--log-level", "WARNING", "--device", "cpu"])
    lines = traj.read_text().strip().splitlines()
    assert len(lines) > 8, lines

    # The same frames through the System directly.
    direct = System(str(yaml_path), Sensor.MONOCULAR, async_mapping=False, device="cpu")
    for i in range(len(seq.image_paths)):
        direct.track_monocular(euroc.load_gray(seq.image_paths[i]), float(seq.timestamps[i]))
    direct.save_trajectory_tum(str(tmp_path / "direct.txt"))
    direct.shutdown()
    assert traj.read_bytes() == (tmp_path / "direct.txt").read_bytes()


def test_tum_loader(rendered, tmp_path):
    scene, Rs, ts, frames = rendered
    base = tmp_path / "fr1_mini"
    (base / "rgb").mkdir(parents=True)
    (base / "depth").mkdir(parents=True)
    with open(base / "rgb.txt", "w") as frgb, open(base / "depth.txt", "w") as fd:
        frgb.write("# color images\n")
        fd.write("# depth images\n")
        for i, img in enumerate(frames[:6]):
            t = 0.05 * i
            _save_png(str(base / "rgb" / f"{t:.6f}.png"), img)
            d = synthetic.render_depth(scene, Rs[i], ts[i])
            Image.fromarray((d * 5000).astype(np.uint16)).save(str(base / "depth" / f"{t + 0.004:.6f}.png"))
            frgb.write(f"{t:.6f} rgb/{t:.6f}.png\n")
            fd.write(f"{t + 0.004:.6f} depth/{t + 0.004:.6f}.png\n")
    seq = tum.load_sequence(str(tmp_path), "fr1_mini")
    assert len(seq.rgb_paths) == 6
    d = tum.load_depth(seq.depth_paths[0])
    assert d.max() > 1.0  # meters, scene depth ~3-10m
    img = tum.load_gray(seq.rgb_paths[0])
    assert img.shape == (scene.height, scene.width)


def test_kitti_loader(rendered, tmp_path):
    scene, Rs, ts, frames = rendered
    base = tmp_path / "sequences" / "00"
    (base / "image_0").mkdir(parents=True)
    (base / "image_1").mkdir(parents=True)
    with open(base / "times.txt", "w") as f:
        for i, img in enumerate(frames[:5]):
            _save_png(str(base / "image_0" / f"{i:06d}.png"), img)
            _save_png(str(base / "image_1" / f"{i:06d}.png"), img)
            f.write(f"{0.1 * i:.6e}\n")
    seq = kitti.load_sequence(str(tmp_path), "00")
    assert len(seq.image_paths) == 5
    assert len(seq.image_paths_right) == 5
    assert abs(seq.timestamps[1] - 0.1) < 1e-9


def test_all_example_drivers_parse(capsys):
    """The port's 13 drivers map one to one to the reference's; each exposes
    main(argv) and parses its arguments (--help), --device among them."""
    ref = sorted(f[:-3] for f in os.listdir(os.path.join(REPO, "examples"))
                 if f.endswith(".py") and f not in ("common.py", "evaluate_ate.py"))
    ex = os.path.join(REPO, "orbslam3_cpp_fork_tpu_torch", "examples")
    port = sorted(f[:-3] for f in os.listdir(ex)
                  if f.endswith(".py") and f not in ("__init__.py", "common.py", "evaluate_ate.py"))
    assert port == ref and len(port) == 13, (port, ref)
    for name in port:
        mod = importlib.import_module(f"orbslam3_cpp_fork_tpu_torch.examples.{name}")
        with pytest.raises(SystemExit) as e:
            mod.main(["--help"])
        assert e.value.code == 0, name
        assert "--device" in capsys.readouterr().out, name


@pytest.mark.slow
@pytest.mark.parametrize("run", [0, 1])
def test_full_width_mono_euroc_ate(tmp_path, capsys, run):
    """The smoke's shell part A on the CPU: the bench ring's first 60
    frames at 752x480 (1000 features, 8 levels) as an EuRoC tree written by
    chip_smoke.py, through the reference's examples/mono_euroc.py (a
    subprocess) and the port's driver (in-process, "cpu"), both in the
    default mode. Prints the scale-aligned ATEs behind the smoke's
    SHELL_JAX_ATE_M and SHELL_PORT_ATE_M (two runs: the mode's mapping
    thread makes every run differ)."""
    import subprocess
    import sys

    from orbslam3_cpp_fork_tpu_torch.examples import mono_euroc
    from orbslam3_cpp_fork_tpu_torch.utils.evaluation import ate_rmse
    from orbslam3_cpp_fork_tpu_torch.utils.trajectory import read_tum

    torch.set_num_threads(4)
    scene, Rs, ts, frames = chip_smoke.render_ring(chip_smoke.SHELL_FRAMES)
    n = len(frames)
    stamps = np.arange(n) * 0.05
    chip_smoke.write_euroc_tree(tmp_path, "RING", stamps, frames)
    chip_smoke.euroc_settings(tmp_path / "mono.yaml", scene, 20)
    common = [str(tmp_path / "mono.yaml"), str(tmp_path), "RING", "--log-level", "WARNING"]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, os.path.join(REPO, "examples", "mono_euroc.py"), *common,
                          "--traj", str(tmp_path / "ref.txt"), "--kf-traj", str(tmp_path / "ref_kf.txt")],
                         capture_output=True, text=True, env=env, timeout=3000)
    assert out.returncode == 0, out.stderr[-2000:]
    mono_euroc.main([*common, "--traj", str(tmp_path / "port.txt"), "--kf-traj", str(tmp_path / "port_kf.txt"),
                     "--device", "cpu"])
    for name in ("ref", "port"):
        ts_est, Twc = read_tum(str(tmp_path / f"{name}.txt"))
        ate = ate_rmse(ts_est, Twc[:, :3, 3], stamps, ts)
        with capsys.disabled():
            print(f"\nshell A constants, run {run}: {name} driver, {len(ts_est)} poses of {n}, scale-aligned ATE "
                  f"{ate.rmse_scaled!r} m (scale {ate.scale:.4f})")
        assert len(ts_est) > 0.8 * n and np.all(np.diff(ts_est) > 0) and np.isfinite(ate.rmse_scaled)


@pytest.mark.slow
@pytest.mark.parametrize("name", chip_smoke.DRIVER_NAMES)
def test_full_width_driver_ate(tmp_path, capsys, name):
    """The smoke's drivers phase on the CPU: the driver's tree at its
    family's published width (chip_smoke.driver_scene), through the
    reference's examples/<name>.py (a subprocess) and the port's driver
    (in-process, "cpu"), both in the default mode. Prints the ATEs behind
    chip_smoke.DRIVER_ATE_M (scale-aligned for the mono drivers, unscaled
    otherwise, over every exported pose) and each run's scale."""
    import subprocess
    import sys

    from orbslam3_cpp_fork_tpu_torch.utils.evaluation import ate_rmse
    from orbslam3_cpp_fork_tpu_torch.utils.trajectory import read_tum

    torch.set_num_threads(4)
    sc = chip_smoke.driver_scene(name)
    common = [*chip_smoke.write_driver_tree(tmp_path, name, sc), "--log-level", "WARNING"]
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, os.path.join(REPO, "examples", f"{name}.py"), *common,
                          "--traj", str(tmp_path / "ref.txt"), "--kf-traj", str(tmp_path / "ref_kf.txt")],
                         capture_output=True, text=True, env=env, timeout=5400)
    runs = {"port": None}
    if out.returncode == 0:
        runs = {"ref": None, **runs}
    else:
        with capsys.disabled():
            print(f"\n{name}: the reference's driver failed (exit {out.returncode}):\n{out.stderr[-3000:]}")
    module = importlib.import_module(f"orbslam3_cpp_fork_tpu_torch.examples.{name}")
    module.main([*common, "--traj", str(tmp_path / "port.txt"), "--kf-traj", str(tmp_path / "port_kf.txt"),
                 "--device", "cpu"])
    for run in runs:
        ts_est, Twc = read_tum(str(tmp_path / f"{run}.txt"))
        ate = ate_rmse(ts_est, Twc[:, :3, 3], sc["stamps"], sc["ts"])
        err = ate.rmse_scaled if name.startswith("mono") else ate.rmse
        with capsys.disabled():
            print(f"\ndrivers constants: {name}: {run} driver, {len(ts_est)} poses of {sc['n']}, ATE {err!r} m "
                  f"({'scale-aligned' if name.startswith('mono') else 'unscaled'}; scale {ate.scale:.4f})")
        assert len(ts_est) > 0.8 * sc["n"] and np.all(np.diff(ts_est) > 0) and np.isfinite(err)
