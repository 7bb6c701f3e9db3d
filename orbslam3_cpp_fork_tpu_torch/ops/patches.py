"""Per-keypoint patch gather, IC angle and steered BRIEF (port of ops/patches.py).

The reference gathers one 40x40 window per keypoint with a Pallas kernel
and turns the windows into orientations and descriptors with two matmuls.
Here the gather is the hand-written CUDA kernel `csrc/patch_gather.cu` on
CUDA tensors and its plain PyTorch version (clamped index grids, advanced
indexing) on CPU tensors. The two are bitwise equal: both only copy f32
values.

BRIEF bit rule. The reference computes the 256 steered comparisons as a
bf16 matmul of the flattened patch against a {-1, 0, +1} table with one
-1 (point a) and one +1 (point b) per column, accumulated in f32. The sum
of two bf16 values of magnitude <= 255 is exact in f32, so bit k is
exactly `bf16(I_b) > bf16(I_a)`. `brief_from_patches` evaluates that
comparison directly on the bf16-rounded pixels: on identical patches its
bits equal the reference's bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import _kernels

RAD = 19  # max rotated BRIEF offset: ceil(13 * sqrt(2))
PATCH_ROWS = 40  # covers offsets -19..+20
PATCH_COLS = 40
N_ANGLE_BINS = 30  # 12-degree bins, as in the ORB paper's pattern LUTs

# Number of patch-gather kernel launches in this process (CUDA tensors
# only; the plain CPU version does not count).
launches = 0
_gather_fn = None


def _check_gather_args(imgs: list[torch.Tensor], xy: torch.Tensor) -> None:
    dev = xy.device
    if xy.dtype != torch.int32 or xy.ndim != 2 or xy.shape[1] != 2:
        raise ValueError(f"xy must be int32 (N, 2), got {xy.dtype} {tuple(xy.shape)}")
    for im in imgs:
        if im.dtype != torch.float32 or im.ndim != 2:
            raise ValueError(f"image must be float32 (H, W), got {im.dtype} {tuple(im.shape)}")
        if im.device != dev:
            raise ValueError(f"image on {im.device} but xy on {dev}")
        if im.shape != imgs[0].shape:
            raise ValueError("images of a dual gather must share one shape")
    if dev.type == "cuda" and not (xy.is_contiguous() and all(i.is_contiguous() for i in imgs)):
        raise ValueError("the CUDA patch gather takes contiguous tensors")


def _gather_plain(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """Plain version: patch[n, r, c] = img[clamp(y+r-19), clamp(x+c-19)]."""
    h, w = img.shape
    x = torch.clamp(xy[:, 0].long(), 0, w - 1)
    y = torch.clamp(xy[:, 1].long(), 0, h - 1)
    off = torch.arange(PATCH_ROWS, device=img.device) - RAD
    rows = torch.clamp(y[:, None] + off, 0, h - 1)
    cols = torch.clamp(x[:, None] + off[:PATCH_COLS], 0, w - 1)
    return img[rows[:, :, None], cols[:, None, :]]


def _gather_cuda(imgs: list[torch.Tensor], xy: torch.Tensor) -> torch.Tensor:
    """Launch csrc/patch_gather.cu: (len(imgs), N, 40, 40)."""
    global launches, _gather_fn
    if _gather_fn is None:
        _gather_fn = _kernels.patch_gather_fn()
    h, w = imgs[0].shape
    n = xy.shape[0]
    out = torch.empty((len(imgs), n, PATCH_ROWS, PATCH_COLS), dtype=torch.float32, device=xy.device)
    if n == 0:
        return out
    with torch.cuda.device(xy.device):
        stream = torch.cuda.current_stream(xy.device).cuda_stream
        err = _gather_fn(
            imgs[0].data_ptr(), imgs[-1].data_ptr(), xy.data_ptr(), out.data_ptr(),
            n, h, w, len(imgs), stream,
        )
    if err != 0:
        raise RuntimeError(f"patch_gather launch failed: cudaError {err}")
    launches += 1
    return out


def extract_patches(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """(H,W) f32 image + (N,2) int32 (x,y) -> (N, 40, 40) patches with the
    keypoint at [19, 19] and edge-clamped reads (coordinates clipped into
    the image first)."""
    _check_gather_args([img], xy)
    if xy.device.type == "cuda":
        return _gather_cuda([img], xy)[0]
    return _gather_plain(img, xy)


def extract_patches_dual(
    img_a: torch.Tensor, img_b: torch.Tensor, xy: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Patches of the same keypoints from two same-shape images (raw for
    orientation, blurred for BRIEF), one kernel launch on CUDA."""
    _check_gather_args([img_a, img_b], xy)
    if xy.device.type == "cuda":
        both = _gather_cuda([img_a, img_b], xy)
        return both[0], both[1]
    return _gather_plain(img_a, xy), _gather_plain(img_b, xy)


def _brief_rotated_pairs():
    """Yield (bin, k, (ya, xa), (yb, xb)) patch coordinates of pair k rotated
    to angle bin b (reference rotation: x' = round(x cos - y sin),
    y' = round(x sin + y cos))."""
    from .orb import _PATTERN  # (256,4) int32, OpenCV bit_pattern_31

    pat = np.asarray(_PATTERN, dtype=np.float64)
    for b in range(N_ANGLE_BINS):
        th = 2.0 * np.pi * b / N_ANGLE_BINS
        ca, sa = np.cos(th), np.sin(th)
        for k in range(256):
            ax, ay, bx, by = pat[k]
            rxa = int(round(ax * ca - ay * sa)) + RAD
            rya = int(round(ax * sa + ay * ca)) + RAD
            rxb = int(round(bx * ca - by * sa)) + RAD
            ryb = int(round(bx * sa + by * ca)) + RAD
            yield b, k, (rya, rxa), (ryb, rxb)


@functools.lru_cache(maxsize=None)
def _brief_diff_table() -> np.ndarray:
    """(P, N_ANGLE_BINS*256) difference matrix of the reference: column
    (b*256+k) holds -1 at pair k's rotated a-point and +1 at its b-point,
    in flattened 40x40 patch coordinates."""
    d = np.zeros((PATCH_ROWS * PATCH_COLS, N_ANGLE_BINS * 256), np.float32)
    for b, k, (ya, xa), (yb, xb) in _brief_rotated_pairs():
        d[ya * PATCH_COLS + xa, b * 256 + k] -= 1.0
        d[yb * PATCH_COLS + xb, b * 256 + k] += 1.0
    return d


@functools.lru_cache(maxsize=None)
def _brief_pair_index() -> tuple[np.ndarray, np.ndarray]:
    """(N_ANGLE_BINS, 256) flattened patch indices of the a- and b-points."""
    ia = np.zeros((N_ANGLE_BINS, 256), np.int64)
    ib = np.zeros((N_ANGLE_BINS, 256), np.int64)
    for b, k, (ya, xa), (yb, xb) in _brief_rotated_pairs():
        ia[b, k] = ya * PATCH_COLS + xa
        ib[b, k] = yb * PATCH_COLS + xb
    return ia, ib


def quantize_angle(angle: torch.Tensor) -> torch.Tensor:
    """Angle (radians) -> bin index in [0, N_ANGLE_BINS) (round half to even)."""
    b = torch.round(angle * (N_ANGLE_BINS / (2.0 * np.pi))).to(torch.int32)
    return torch.remainder(b, N_ANGLE_BINS)


def brief_from_patches(patches: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """(N,40,40) patches + (N,) angle -> (N,256) int8 bits;
    bit k = 1 iff bf16(I(b_k)) > bf16(I(a_k)) at the quantized rotation."""
    n = patches.shape[0]
    ia, ib = _device_tables(patches.device)[:2]
    bins = quantize_angle(angle).long()
    flat = patches.reshape(n, -1).to(torch.bfloat16)
    va = torch.gather(flat, 1, ia[bins])
    vb = torch.gather(flat, 1, ib[bins])
    return (vb > va).to(torch.int8)


@functools.lru_cache(maxsize=None)
def _moment_weights() -> np.ndarray:
    """(P, 2) x/y moment weights of the radius-15 circular IC_Angle patch
    in flattened 40x40 patch coordinates."""
    from .orb import HALF_PATCH

    r = HALF_PATCH
    wts = np.zeros((PATCH_ROWS * PATCH_COLS, 2), np.float32)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            if dx * dx + dy * dy <= r * r + r:
                idx = (dy + RAD) * PATCH_COLS + (dx + RAD)
                wts[idx, 0] = dx  # m10
                wts[idx, 1] = dy  # m01
    return wts


@functools.lru_cache(maxsize=None)
def _device_tables(device: torch.device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """BRIEF a/b indices and moment weights, uploaded once per device (no
    host-to-device copy on the per-frame path)."""
    ia, ib = _brief_pair_index()
    return (
        torch.from_numpy(ia).to(device),
        torch.from_numpy(ib).to(device),
        torch.from_numpy(_moment_weights()).to(device),
    )


def ic_angle_from_patches(patches: torch.Tensor) -> torch.Tensor:
    """(N,40,40) raw-image patches -> (N,) IC_Angle orientations."""
    n = patches.shape[0]
    w = _device_tables(patches.device)[2]
    m = patches.reshape(n, -1) @ w  # (N,2) = (m10, m01)
    return torch.atan2(m[:, 1], m[:, 0])
