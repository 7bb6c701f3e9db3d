"""EuRoC MAV dataset loader.

Replaces src/Common/EuRoC.cc: timestamp-file-driven image lists, IMU CSV
parsing with ns -> s conversion (src/Common/EuRoC.cc:32), and per-camera
paths of the ASL folder layout:

  <root>/<seq>/mav0/cam0/data/<ns>.png
  <root>/<seq>/mav0/imu0/data.csv

Image decoding uses imageio/PIL if available (the pipeline only needs a
float32 grayscale array); shipping datasets is out of scope for tests.

(Copy of datasets/euroc.py: numpy only.)
"""

from __future__ import annotations

import csv
import dataclasses
import os

import numpy as np


@dataclasses.dataclass
class ImuRecord:
    timestamps: np.ndarray  # (N,) seconds
    gyro: np.ndarray  # (N,3) rad/s
    acc: np.ndarray  # (N,3) m/s^2


@dataclasses.dataclass
class EurocSequence:
    image_paths: list  # cam0
    image_paths_right: list  # cam1 (stereo)
    timestamps: np.ndarray  # seconds
    imu: ImuRecord | None


def load_sequence(
    root: str, seq: str, timestamp_file: str | None = None, stereo: bool = False
) -> EurocSequence:
    """timestamp_file: optional EuRoC_TimeStamps list (ns per line, as
    shipped in Examples/*/EuRoC_TimeStamps); defaults to all cam0 images."""
    cam0 = os.path.join(root, seq, "mav0", "cam0", "data")
    cam1 = os.path.join(root, seq, "mav0", "cam1", "data")
    if timestamp_file:
        with open(timestamp_file) as f:
            stamps_ns = [int(line.strip()) for line in f if line.strip()]
    else:
        stamps_ns = sorted(
            int(os.path.splitext(p)[0]) for p in os.listdir(cam0) if p.endswith(".png")
        )
    paths0 = [os.path.join(cam0, f"{ns}.png") for ns in stamps_ns]
    paths1 = [os.path.join(cam1, f"{ns}.png") for ns in stamps_ns] if stereo else []
    imu = None
    imu_csv = os.path.join(root, seq, "mav0", "imu0", "data.csv")
    if os.path.exists(imu_csv):
        ts, gyro, acc = [], [], []
        with open(imu_csv) as f:
            reader = csv.reader(f)
            for row in reader:
                if not row or row[0].startswith("#"):
                    continue
                ts.append(float(row[0]) * 1e-9)
                gyro.append([float(x) for x in row[1:4]])
                acc.append([float(x) for x in row[4:7]])
        imu = ImuRecord(
            np.asarray(ts), np.asarray(gyro, np.float32), np.asarray(acc, np.float32)
        )
    return EurocSequence(
        image_paths=paths0,
        image_paths_right=paths1,
        timestamps=np.asarray(stamps_ns, np.float64) * 1e-9,
        imu=imu,
    )


def load_gray(path: str) -> np.ndarray:
    """Load an image as float32 grayscale 0..255."""
    try:
        from PIL import Image  # pillow ships with the baked deps

        img = np.asarray(Image.open(path).convert("L"), np.float32)
        return img
    except ImportError:  # pragma: no cover
        import imageio.v3 as iio

        img = iio.imread(path)
        if img.ndim == 3:
            img = img.mean(axis=-1)
        return img.astype(np.float32)


def imu_between(imu: ImuRecord, t0: float, t1: float):
    """Measurements in (t0, t1] — the per-frame batch Tracking feeds to
    preintegration (Examples/Monocular-Inertial/mono_euroc_inertial
    sync loop)."""
    sel = (imu.timestamps > t0) & (imu.timestamps <= t1)
    idx = np.nonzero(sel)[0]
    ts = imu.timestamps[idx]
    dts = np.diff(np.concatenate([[t0], ts])).astype(np.float32)
    return imu.acc[idx], imu.gyro[idx], dts
