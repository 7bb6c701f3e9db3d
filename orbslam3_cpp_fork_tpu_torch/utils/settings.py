"""Typed settings loader for the reference's YAML config schema (copy of
utils/settings.py).

Parses the same "File.version 1.0" YAML files the reference ships per
dataset. The OpenCV FileStorage `%YAML:1.0` directive is stripped and the
flat dotted keys are parsed with PyYAML, which is imported only inside the
function that reads a file: a `Settings` object made in code needs no YAML
package. Unknown camera types and missing required keys raise.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..ops.camera import Camera


@dataclasses.dataclass
class ImuSettings:
    noise_gyro: float
    noise_acc: float
    walk_gyro: float
    walk_acc: float
    frequency: float
    Tbc: np.ndarray  # (4,4) body-from-camera


@dataclasses.dataclass
class Settings:
    camera_type: str
    camera: Camera
    width: int
    height: int
    fps: float
    rgb: bool
    n_features: int
    scale_factor: float
    n_levels: int
    ini_th_fast: int
    min_th_fast: int
    camera2: Camera | None = None
    Tlr: np.ndarray | None = None  # stereo extrinsics (4,4)
    # Fisheye-stereo lapping areas (Camera{1,2}.overlapping{Begin,End}).
    lapping1: tuple | None = None
    lapping2: tuple | None = None
    bf: float | None = None
    stereo_th_depth: float | None = None
    imu: ImuSettings | None = None
    depth_map_factor: float | None = None
    new_width: int | None = None
    new_height: int | None = None
    load_atlas: str | None = None
    save_atlas: str | None = None
    # Legacy (pre-1.0) explicit stereo-rectification blocks LEFT.*/RIGHT.*
    # (K, D, R, P per side — the old examples fed these to
    # cv::initUndistortRectifyMap themselves). Dicts with keys K, D, R, P.
    left_rect: dict | None = None
    right_rect: dict | None = None


def _load_yaml(path: str) -> dict:
    import yaml  # lazy: only a YAML file needs it

    with open(path) as f:
        text = f.read()
    if text.startswith("%YAML"):
        text = text.split("\n", 1)[1]
    # OpenCV matrices appear as `!!opencv-matrix` tagged maps; strip tags.
    text = text.replace("!!opencv-matrix", "")
    return yaml.safe_load(text) or {}


def _camera_from(d: dict, prefix: str, cam_type: str) -> Camera:
    fx = float(d[f"{prefix}.fx"])
    fy = float(d[f"{prefix}.fy"])
    cx = float(d[f"{prefix}.cx"])
    cy = float(d[f"{prefix}.cy"])
    if cam_type in ("PinHole", "Rectified"):
        dist = [
            float(d.get(f"{prefix}.k1", 0.0)),
            float(d.get(f"{prefix}.k2", 0.0)),
            float(d.get(f"{prefix}.p1", 0.0)),
            float(d.get(f"{prefix}.p2", 0.0)),
            float(d.get(f"{prefix}.k3", 0.0)),
        ]
        return Camera.pinhole(fx, fy, cx, cy, dist=dist)
    elif cam_type == "KannalaBrandt8":
        return Camera.kb8(
            fx, fy, cx, cy,
            k1=float(d.get(f"{prefix}.k1", 0.0)),
            k2=float(d.get(f"{prefix}.k2", 0.0)),
            k3=float(d.get(f"{prefix}.k3", 0.0)),
            k4=float(d.get(f"{prefix}.k4", 0.0)),
        )
    raise ValueError(f"unknown camera type: {cam_type}")


def _matrix(d, key) -> np.ndarray | None:
    v = d.get(key)
    if v is None:
        return None
    if isinstance(v, dict) and "data" in v:
        return np.asarray(v["data"], np.float32).reshape(
            int(v.get("rows", 4)), int(v.get("cols", 4))
        )
    return np.asarray(v, np.float32)


def _load_legacy(d: dict) -> Settings:
    """Pre-1.0 config schema: flat `Camera.*` keys, `Tbc`, `ThDepth`,
    `Tlr` + `Camera.lappingBegin/End` for fisheye stereo (the reference
    parses these in Tracking::ParseCamParamFile/ParseORBParamFile/
    ParseIMUParamFile, src/Tracking.cc:604-1308; e.g.
    Examples_old/Stereo-Inertial/EuRoC.yaml)."""
    cam_type = d.get("Camera.type", "PinHole")
    if cam_type == "KannalaBrandt8":
        cam1 = _camera_from(d, "Camera", cam_type)
        cam2 = (
            _camera_from(d, "Camera2", cam_type)
            if any(k.startswith("Camera2.") for k in d)
            else None
        )
    else:
        cam1 = _camera_from(d, "Camera", cam_type)
        cam2 = None
    imu = None
    if "IMU.Frequency" in d:
        imu = ImuSettings(
            noise_gyro=float(d["IMU.NoiseGyro"]),
            noise_acc=float(d["IMU.NoiseAcc"]),
            walk_gyro=float(d["IMU.GyroWalk"]),
            walk_acc=float(d["IMU.AccWalk"]),
            frequency=float(d["IMU.Frequency"]),
            Tbc=_matrix(d, "Tbc"),
        )
    width = int(d["Camera.width"])
    height = int(d["Camera.height"])
    scale = float(d.get("Camera.imageScale", 1.0))
    new_w = new_h = None
    if scale != 1.0:
        new_w, new_h = int(round(width * scale)), int(round(height * scale))
    bf = None if "Camera.bf" not in d else float(d["Camera.bf"])

    def _rect_block(side: str) -> dict | None:
        if f"{side}.K" not in d:
            return None
        return {
            "K": _matrix(d, f"{side}.K").reshape(3, 3),
            "D": _matrix(d, f"{side}.D").reshape(-1),
            "R": _matrix(d, f"{side}.R").reshape(3, 3),
            "P": _matrix(d, f"{side}.P").reshape(3, 4),
        }

    return Settings(
        camera_type=cam_type,
        camera=cam1,
        camera2=cam2,
        width=width,
        height=height,
        fps=float(d.get("Camera.fps", 30.0)),
        rgb=bool(d.get("Camera.RGB", 1)),
        n_features=int(d.get("ORBextractor.nFeatures", 1000)),
        scale_factor=float(d.get("ORBextractor.scaleFactor", 1.2)),
        n_levels=int(d.get("ORBextractor.nLevels", 8)),
        ini_th_fast=int(d.get("ORBextractor.iniThFAST", 20)),
        min_th_fast=int(d.get("ORBextractor.minThFAST", 7)),
        Tlr=_matrix(d, "Tlr"),
        lapping1=(
            (float(d["Camera.lappingBegin"]), float(d["Camera.lappingEnd"]))
            if "Camera.lappingBegin" in d
            else None
        ),
        lapping2=(
            (float(d["Camera2.lappingBegin"]), float(d["Camera2.lappingEnd"]))
            if "Camera2.lappingBegin" in d
            else None
        ),
        bf=bf,
        stereo_th_depth=None if "ThDepth" not in d else float(d["ThDepth"]),
        imu=imu,
        depth_map_factor=(
            None if "DepthMapFactor" not in d else float(d["DepthMapFactor"])
        ),
        new_width=new_w,
        new_height=new_h,
        load_atlas=d.get("System.LoadAtlasFromFile"),
        save_atlas=d.get("System.SaveAtlasToFile"),
        left_rect=_rect_block("LEFT"),
        right_rect=_rect_block("RIGHT"),
    )


def load_settings(path: str) -> Settings:
    d = _load_yaml(path)
    version = str(d.get("File.version", ""))
    if version != "1.0":
        # Legacy (pre-1.0) schema, parsed by Tracking::Parse*ParamFile in
        # the reference (src/Tracking.cc:604-1308).
        if "Camera.fx" in d or "Camera1.fx" not in d:
            return _load_legacy(d)
        raise ValueError(f"unsupported settings version {version!r}")
    cam_type = d["Camera.type"]
    cam1 = _camera_from(d, "Camera1", cam_type)
    cam2 = None
    if any(k.startswith("Camera2.") for k in d):
        cam2 = _camera_from(d, "Camera2", cam_type)
    imu = None
    if "IMU.Frequency" in d:
        imu = ImuSettings(
            noise_gyro=float(d["IMU.NoiseGyro"]),
            noise_acc=float(d["IMU.NoiseAcc"]),
            walk_gyro=float(d["IMU.GyroWalk"]),
            walk_acc=float(d["IMU.AccWalk"]),
            frequency=float(d["IMU.Frequency"]),
            Tbc=_matrix(d, "IMU.T_b_c1"),
        )
    return Settings(
        camera_type=cam_type,
        camera=cam1,
        camera2=cam2,
        width=int(d["Camera.width"]),
        height=int(d["Camera.height"]),
        fps=float(d.get("Camera.fps", 30.0)),
        rgb=bool(d.get("Camera.RGB", 1)),
        n_features=int(d.get("ORBextractor.nFeatures", 1000)),
        scale_factor=float(d.get("ORBextractor.scaleFactor", 1.2)),
        n_levels=int(d.get("ORBextractor.nLevels", 8)),
        ini_th_fast=int(d.get("ORBextractor.iniThFAST", 20)),
        min_th_fast=int(d.get("ORBextractor.minThFAST", 7)),
        Tlr=_matrix(d, "Stereo.T_c1_c2"),
        lapping1=(
            (float(d["Camera1.overlappingBegin"]), float(d["Camera1.overlappingEnd"]))
            if "Camera1.overlappingBegin" in d
            else None
        ),
        lapping2=(
            (float(d["Camera2.overlappingBegin"]), float(d["Camera2.overlappingEnd"]))
            if "Camera2.overlappingBegin" in d
            else None
        ),
        bf=None if "Camera.bf" not in d else float(d["Camera.bf"]),
        stereo_th_depth=None
        if "Stereo.ThDepth" not in d
        else float(d["Stereo.ThDepth"]),
        imu=imu,
        depth_map_factor=None
        if "RGBD.DepthMapFactor" not in d
        else float(d["RGBD.DepthMapFactor"]),
        new_width=None if "Camera.newWidth" not in d else int(d["Camera.newWidth"]),
        new_height=None if "Camera.newHeight" not in d else int(d["Camera.newHeight"]),
        load_atlas=d.get("System.LoadAtlasFromFile"),
        save_atlas=d.get("System.SaveAtlasToFile"),
    )
