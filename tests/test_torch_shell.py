"""The port's shell: `entry()`, the viewers (utils/viewer.py,
utils/live_viewer.py) and `System`'s wiring of them, the timestamp guards
and ChangeDataset, and the settings and ATE cases of
tests/test_settings_io.py that tests/test_torch_system.py does not cover.

- entry: `entry("cpu")` builds the reference's inputs bit for bit (the same
  draws of `default_rng(0)`); its `fn` against the reference's on those
  inputs is `-m slow` (the reference compiles its whole per-frame program):
  `n_in` equal, pose within 1e-4.
- Viewers: tests/test_viewer.py's six cases on the port, plus the PNG bytes,
  the drawn frame and the PLY and HTML text bitwise equal to the reference's
  on the same inputs.
- Guards: tests/test_dataset_guards.py's two cases on the port.
- Settings: the IMU block and the legacy schemas load to the reference's
  values; malformed files and unknown cameras are refused alike; the ATE
  alignment gives the reference's numbers.
"""

import dataclasses
import json
import os
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_cpp_fork_tpu.utils import evaluation as jeval
from orbslam3_cpp_fork_tpu.utils import settings as jsettings
from orbslam3_cpp_fork_tpu.utils import viewer as jviewer
from orbslam3_cpp_fork_tpu_torch.datasets import synthetic
from orbslam3_cpp_fork_tpu_torch.ops.camera import Camera
from orbslam3_cpp_fork_tpu_torch.runtime.system import System
from orbslam3_cpp_fork_tpu_torch.runtime.tracker import Sensor, TrackState
from orbslam3_cpp_fork_tpu_torch.utils import evaluation as teval
from orbslam3_cpp_fork_tpu_torch.utils import settings as tsettings
from orbslam3_cpp_fork_tpu_torch.utils import viewer
from orbslam3_cpp_fork_tpu_torch.utils.live_viewer import LiveViewer

from test_settings_io import IMU_EXTRA, LEGACY_FISHEYE_YAML, LEGACY_YAML, PINHOLE_YAML


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _settings(W=320, H=240):
    return tsettings.Settings(
        camera_type="PinHole", camera=Camera.pinhole(260.0, 260.0, W / 2, H / 2),
        width=W, height=H, fps=20.0, rgb=False,
        n_features=256, scale_factor=1.2, n_levels=4, ini_th_fast=20, min_th_fast=7,
    )


# ------------------------------------------------------------------- entry


def test_entry_builds_the_reference_inputs():
    import __graft_entry__

    from orbslam3_cpp_fork_tpu_torch.entry import entry

    fn, args = entry("cpu")
    _, ref_args = __graft_entry__.entry()
    assert len(args) == len(ref_args) == 9
    for got, ref in zip(args, ref_args):
        assert got.device.type == "cpu" and tuple(got.shape) == tuple(ref.shape)
        assert np.array_equal(got.numpy(), np.asarray(ref).astype(got.numpy().dtype)), got.shape
    assert args[7].dtype == torch.int8 and args[8].dtype == torch.bool


@pytest.mark.slow
def test_entry_matches_the_reference():
    import __graft_entry__

    from orbslam3_cpp_fork_tpu_torch.entry import entry

    fn, args = entry("cpu")
    R2, t2, n_in = fn(*args)
    ref_fn, ref_args = __graft_entry__.entry()
    jR2, jt2, jn_in = ref_fn(*ref_args)
    assert int(n_in) == int(jn_in)
    np.testing.assert_allclose(R2.numpy(), np.asarray(jR2), atol=1e-4)
    np.testing.assert_allclose(t2.numpy(), np.asarray(jt2), atol=1e-4)
    assert np.isfinite(R2.numpy()).all() and np.isfinite(t2.numpy()).all()


def test_entry_refuses_a_missing_card():
    from orbslam3_cpp_fork_tpu_torch.entry import entry

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal cannot be observed")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry()


# ----------------------------------------------------------------- viewers


def test_save_png_roundtrip(tmp_path):
    img = (np.arange(40 * 60).reshape(40, 60) % 251).astype(np.uint8)
    p = tmp_path / "x.png"
    viewer.save_png(str(p), img)
    data = p.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    from PIL import Image

    assert np.array_equal(np.asarray(Image.open(p)), img)
    jviewer.save_png(str(tmp_path / "ref.png"), img)
    assert data == (tmp_path / "ref.png").read_bytes()


def test_draw_frame_overlay(tmp_path):
    img = np.zeros((100, 120), np.float32)
    xy = np.array([[20, 30], [60, 50], [200, 300]], np.float32)  # last OOB
    valid = np.array([True, True, True])
    tracked = np.array([True, False, False])
    rgb = viewer.draw_frame(img, xy, valid, tracked, state="OK")
    assert rgb.shape == (118, 120, 3)
    assert (rgb[27:34, 17:24, 1] > 200).any()  # tracked keypoint green
    assert (rgb[47:54, 57:64, 2] > 200).any()  # untracked blue
    assert np.array_equal(rgb, jviewer.draw_frame(img, xy, valid, tracked, state="OK"))
    viewer.save_png(str(tmp_path / "f.png"), rgb)


def test_map_exports(tmp_path):
    pts = np.random.default_rng(0).normal(size=(50, 3)).astype(np.float32)
    mask = np.ones(50, bool)
    mask[40:] = False
    traj = np.cumsum(np.ones((8, 3), np.float32) * 0.1, axis=0)
    for mod, tag in ((viewer, "port"), (jviewer, "ref")):
        mod.export_map_ply(str(tmp_path / f"{tag}.ply"), pts, traj, point_mask=mask)
        mod.export_map_html(str(tmp_path / f"{tag}.html"), pts, traj, point_mask=mask)
    text = (tmp_path / "port.ply").read_text()
    assert "element vertex 48" in text  # 40 points kept + 8 keyframes
    h = (tmp_path / "port.html").read_text()
    assert "landmarks" in h and '"traj"' in h
    assert text == (tmp_path / "ref.ply").read_text() and h == (tmp_path / "ref.html").read_text()


def test_system_viewer_writes_outputs(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    slam = System(_settings(), Sensor.MONOCULAR, use_viewer=True, device="cpu")
    scene = synthetic.make_scene(n_points=900, width=320, height=240, fx=260.0, seed=1)
    for i in range(4):
        img = synthetic.render_frame(scene, np.eye(3, dtype=np.float32), np.array([0.06 * i, 0.0, 0.0], np.float32))
        slam.track_monocular(img, i * 0.05)
    slam.shutdown()
    assert os.path.exists("viewer_out/map.ply")
    assert os.path.exists("viewer_out/map.html")
    assert os.path.exists("viewer_out/frame_000000.png")


def test_live_viewer_endpoints():
    lv = LiveViewer(port=0)
    try:
        img = np.zeros((60, 80), np.float32)
        xy = np.array([[10, 10], [40, 30]], np.float32)
        lv.push_frame(img, xy, np.array([True, True]), np.array([True, False]), "OK", 7)
        lv.state_provider = lambda: {
            "points": np.array([[0, 0, 5.0], [1, 1, 6.0]], np.float32),
            "traj": np.array([[0, 0, 0], [0.1, 0, 0]], np.float32),
            "n_keyframes": 2, "n_landmarks": 2, "n_loops": 0,
        }
        page = urllib.request.urlopen(lv.url, timeout=10).read()
        assert b"state.json" in page
        png = urllib.request.urlopen(lv.url + "frame.png", timeout=10).read()
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        state = json.loads(urllib.request.urlopen(lv.url + "state.json", timeout=10).read())
        assert state["state"] == "OK" and state["frame_id"] == 7
        assert len(state["points"]) == 2 and len(state["traj"]) == 2
    finally:
        lv.stop()


def test_live_viewer_in_system():
    """System(live_viewer=True) serves the live map while tracking; the
    state reports the map's landmark count."""
    slam = System(_settings(), Sensor.MONOCULAR, live_viewer=True, device="cpu")
    url = slam.live_viewer.url
    scene = synthetic.make_scene(n_points=900, width=320, height=240, fx=260.0, seed=1)
    try:
        for i in range(4):
            img = synthetic.render_frame(scene, np.eye(3, dtype=np.float32), np.array([0.06 * i, 0.0, 0.0], np.float32))
            slam.track_monocular(img, i * 0.05)
        state = json.loads(urllib.request.urlopen(url + "state.json", timeout=10).read())
        assert state["frame_id"] >= 0 and state["n_landmarks"] == len(state["points"])
        slam.tracker.flush_mapping()
        assert state["n_keyframes"] <= slam.tracker.map.n_keyframes()
    finally:
        slam.shutdown()
    assert slam.live_viewer is None


# ------------------------------------------------------------------ guards


def _run_frames(slam, scene, t0, n, step=0.05):
    for i in range(n):
        pos = np.array([0.05 * i, 0.0, 0.0], np.float32)
        slam.track_monocular(synthetic.render_frame(scene, np.eye(3, dtype=np.float32), pos), t0 + i * step)


def test_backwards_timestamp_spawns_fresh_start():
    slam = System(_settings(), Sensor.MONOCULAR, device="cpu")
    try:
        scene = synthetic.make_scene(n_points=900, width=320, height=240, fx=260.0, seed=2)
        _run_frames(slam, scene, 10.0, 6)
        map_id_before = slam.tracker.map.map_id
        # A frame 5 seconds in the past must not corrupt the map: the tracker
        # resets (small map) or spawns a new one.
        img = synthetic.render_frame(scene, np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
        slam.track_monocular(img, 5.0)
        assert slam.get_tracking_state() in (TrackState.NO_IMAGES_YET, TrackState.NOT_INITIALIZED)
        assert slam.tracker.map.n_keyframes() <= 2
        assert slam.tracker.map.map_id >= map_id_before
    finally:
        slam.shutdown()


def test_change_dataset_restarts_cleanly():
    slam = System(_settings(), Sensor.MONOCULAR, device="cpu")
    try:
        scene = synthetic.make_scene(n_points=900, width=320, height=240, fx=260.0, seed=3)
        _run_frames(slam, scene, 0.0, 6)
        slam.change_dataset()
        # The second sequence starts at an earlier clock: tracking must
        # re-initialize without tripping the timestamp guard.
        scene2 = synthetic.make_scene(n_points=900, width=320, height=240, fx=260.0, seed=4)
        _run_frames(slam, scene2, -100.0, 8)
        assert slam.tracker.frame_id == 14
    finally:
        slam.shutdown()


# ---------------------------------------------------------------- settings


def _same(got, ref, path="settings"):
    """Field by field: arrays bitwise (as f32 where the port stores f32),
    dataclasses and dicts recursively, cameras by intrinsics."""
    if isinstance(got, Camera):
        for k in ("fx", "fy", "cx", "cy"):
            assert getattr(got, k) == float(getattr(ref, k)), f"{path}.{k}"
        assert np.array_equal(np.asarray(got.dist, np.float32), np.asarray(ref.dist, np.float32)), f"{path}.dist"
    elif dataclasses.is_dataclass(got):
        for f in dataclasses.fields(got):
            _same(getattr(got, f.name), getattr(ref, f.name), f"{path}.{f.name}")
    elif isinstance(got, dict):
        assert sorted(got) == sorted(ref), path
        for k in got:
            _same(got[k], ref[k], f"{path}[{k}]")
    elif isinstance(got, np.ndarray) or isinstance(ref, (np.ndarray, jnp.ndarray)):
        assert np.array_equal(np.asarray(got), np.asarray(ref)), path
    else:
        assert got == ref, path


@pytest.mark.parametrize("text", [PINHOLE_YAML + IMU_EXTRA, LEGACY_YAML, LEGACY_FISHEYE_YAML],
                         ids=["imu", "legacy-pinhole-inertial", "legacy-fisheye-stereo"])
def test_load_settings_blocks_match_the_reference(tmp_path, text):
    p = tmp_path / "settings.yaml"
    p.write_text(text)
    got, ref = tsettings.load_settings(str(p)), jsettings.load_settings(str(p))
    _same(got, ref)
    if "IMU.Frequency" in text:
        assert got.imu is not None and got.imu.frequency == 200.0 and np.asarray(got.imu.Tbc).shape == (4, 4)


@pytest.mark.parametrize("text", ["%YAML:1.0\nSomething.else: 1\n", PINHOLE_YAML.replace('"PinHole"', '"Weird"')],
                         ids=["malformed", "unknown-camera"])
def test_load_rejects_like_the_reference(tmp_path, text):
    p = tmp_path / "settings.yaml"
    p.write_text(text)
    with pytest.raises((ValueError, KeyError)) as got:
        tsettings.load_settings(str(p))
    with pytest.raises((ValueError, KeyError)) as ref:
        jsettings.load_settings(str(p))
    assert type(got.value) is type(ref.value)


def test_ate_matches_the_reference():
    """tests/test_settings_io.py's two ATE cases: a Sim(3) recovered and a
    pure scale error seen only at GT scale; every number the reference's."""
    rng = np.random.default_rng(6)
    n = 50
    ts = np.arange(n) * 0.1
    gt = np.cumsum(rng.normal(0, 0.1, (n, 3)), axis=0)
    th = 0.7
    R = np.array([[np.cos(th), -np.sin(th), 0.0], [np.sin(th), np.cos(th), 0.0], [0.0, 0.0, 1.0]])
    for est, scale in ((2.5 * (gt @ R.T) + np.array([4.0, -2.0, 1.0]), 1 / 2.5), (1.5 * gt, 1 / 1.5)):
        got, ref = teval.ate_rmse(ts, est, ts, gt), jeval.ate_rmse(ts, est, ts, gt)
        assert got.n_pairs == ref.n_pairs == n
        assert got.rmse_scaled < 1e-5 and abs(got.scale - scale) < 1e-6
        for k in ("rmse", "rmse_scaled", "scale"):
            assert getattr(got, k) == getattr(ref, k), k
    assert got.rmse > 0.01  # the unit-scale error stays visible
