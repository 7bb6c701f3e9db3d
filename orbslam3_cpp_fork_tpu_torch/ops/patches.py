"""Per-keypoint patch gather, IC angle and steered BRIEF (port of ops/patches.py).

The reference gathers one 40x40 window per keypoint with a Pallas kernel
and turns the windows into orientations and descriptors with two matmuls.
Here the gather is the hand-written CUDA kernel `csrc/patch_gather.cu` on
CUDA tensors and its plain PyTorch version (clamped index grids, advanced
indexing) on CPU tensors. The two are bitwise equal: both only copy f32
values. `extract_patches_levels` gathers every pyramid level in one launch;
`extract_patches` and `extract_patches_dual` launch the same kernel with a
one-level table.

`describe_keypoints` is what the extractor calls: keypoints of all pyramid
levels -> angles, BRIEF bits and packed words. On CUDA tensors it is one
launch of the fused kernel `csrc/orb_describe.cu`, which keeps every
window inside its block, so no (N, 40, 40) tensor reaches device memory;
on CPU tensors it is `describe_keypoints_plain`, the per-level gather ->
`ic_angle_from_patches` -> `brief_from_patches` -> `pack_bits` chain. The
kernel sums the moments in float64 and rounds once, the plain version is
an f32 matmul: angles agree to ~1e-6 rad, and bits are equal wherever
both land in the same 12-degree bin.

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
# only; the plain CPU version does not count). The kernel also counts on
# the card: see `gather_counter`.
launches = 0
_gather_fn = None
# Number of fused describe-kernel launches this process made (host side).
# The kernel also counts on the card: see `describe_counter`.
describe_launches = 0
_describe_fn = None


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


@functools.lru_cache(maxsize=None)
def gather_counter(device: torch.device) -> torch.Tensor:
    """The card's own count of patch-gather launches, a (1,) int64 tensor on
    `device` (as `describe_counter` for the fused kernel)."""
    return torch.zeros(1, dtype=torch.int64, device=device)


def _gather_cuda(levels, blurred, xys) -> torch.Tensor:
    """Launch csrc/patch_gather.cu once for every level: (2, M, 40, 40), or
    (1, M, 40, 40) when `blurred` is None, levels concatenated in order."""
    global launches, _gather_fn
    if _gather_fn is None:
        _gather_fn = _kernels.patch_gather_fn()
    dev = xys[0].device
    xy = torch.cat(xys) if len(xys) > 1 else xys[0]
    m = xy.shape[0]
    n_images = 1 if blurred is None else 2
    out = torch.empty((n_images, m, PATCH_ROWS, PATCH_COLS), dtype=torch.float32, device=dev)
    if m == 0:
        return out
    if out.data_ptr() % 16:
        raise RuntimeError("patch_gather writes 16-byte vectors: the output is not 16-byte aligned")
    table = _kernels.LevelTable()
    table.n_levels = len(levels)
    start = 0
    for l, (lvl, kp) in enumerate(zip(levels, xys)):
        table.raw[l] = lvl.data_ptr()
        table.blur[l] = (lvl if blurred is None else blurred[l]).data_ptr()
        table.h[l], table.w[l] = lvl.shape
        table.start[l] = start
        start += kp.shape[0]
    table.start[len(levels)] = start
    # As in `_describe_cuda`: the caching allocator keeps `xy` and the level
    # buffers for work queued on this stream.
    with torch.cuda.device(dev):
        err = _gather_fn(
            table, xy.data_ptr(), out.data_ptr(), gather_counter(dev).data_ptr(), m, n_images,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"patch_gather launch failed: cudaError {err}")
    launches += 1
    return out


def _check_level_args(levels, blurred, xys) -> None:
    if not (0 < len(levels) == len(blurred) == len(xys) <= _kernels.MAX_LEVELS):
        raise ValueError(f"need 1..{_kernels.MAX_LEVELS} levels, as many blurred copies and keypoint sets")
    for lvl, blur, xy in zip(levels, blurred, xys):
        _check_gather_args([lvl, blur], xy)
        if xy.device != xys[0].device:
            raise ValueError("all levels must lie on one device")


def extract_patches(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """(H,W) f32 image + (N,2) int32 (x,y) -> (N, 40, 40) patches with the
    keypoint at [19, 19] and edge-clamped reads (coordinates clipped into
    the image first)."""
    _check_gather_args([img], xy)
    if xy.device.type == "cuda":
        return _gather_cuda([img], None, [xy])[0]
    return _gather_plain(img, xy)


def extract_patches_dual(
    img_a: torch.Tensor, img_b: torch.Tensor, xy: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Patches of the same keypoints from two same-shape images (raw for
    orientation, blurred for BRIEF), one kernel launch on CUDA."""
    _check_gather_args([img_a, img_b], xy)
    if xy.device.type == "cuda":
        both = _gather_cuda([img_a], [img_b], [xy])
        return both[0], both[1]
    return _gather_plain(img_a, xy), _gather_plain(img_b, xy)


def extract_patches_levels(
    levels: list[torch.Tensor], blurred: list[torch.Tensor], xys: list[torch.Tensor]
) -> torch.Tensor:
    """`extract_patches_dual` for every pyramid level at once: (2, M, 40, 40)
    with M = sum(n_l), [0] from the raw levels and [1] from the blurred
    ones, the levels concatenated in order. One kernel launch on CUDA
    tensors; the plain version level by level on CPU tensors."""
    _check_level_args(levels, blurred, xys)
    if xys[0].device.type == "cuda":
        return _gather_cuda(levels, blurred, xys)
    return torch.stack([
        torch.cat([_gather_plain(img, xy) for img, xy in zip(imgs, xys)]) for imgs in (levels, blurred)
    ])


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
    flat = patches.reshape(n, PATCH_ROWS * PATCH_COLS).to(torch.bfloat16)
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
def _brief_pair_table() -> np.ndarray:
    """(N_ANGLE_BINS, 256, 2) uint16 window indices (a, b) of every rotated
    pair: the table the fused kernel reads."""
    return np.stack(_brief_pair_index(), axis=-1).astype(np.uint16)


@functools.lru_cache(maxsize=None)
def _device_tables(device: torch.device) -> tuple[torch.Tensor, ...]:
    """BRIEF a/b indices, moment weights and the fused kernel's pair table,
    uploaded once per device (no host-to-device copy on the per-frame
    path). The pair table travels as int16 (same bits: every index is below
    1600) because not every PyTorch build moves uint16 tensors."""
    ia, ib = _brief_pair_index()
    return (
        torch.from_numpy(ia).to(device),
        torch.from_numpy(ib).to(device),
        torch.from_numpy(_moment_weights()).to(device),
        torch.from_numpy(_brief_pair_table().view(np.int16)).to(device),
    )


def ic_angle_from_patches(patches: torch.Tensor) -> torch.Tensor:
    """(N,40,40) raw-image patches -> (N,) IC_Angle orientations."""
    n = patches.shape[0]
    w = _device_tables(patches.device)[2]
    m = patches.reshape(n, PATCH_ROWS * PATCH_COLS) @ w  # (N,2) = (m10, m01)
    return torch.atan2(m[:, 1], m[:, 0])


def _describe_per_level(patch_pairs):
    """(raw, blurred) patches of each level -> IC angle -> BRIEF -> packed
    words, level by level."""
    from .orb import pack_bits

    outs = []
    for praw, pblur in patch_pairs:
        angle = ic_angle_from_patches(praw)
        bits = brief_from_patches(pblur, angle)
        outs.append((angle, bits, pack_bits(bits)))
    return tuple(torch.cat(c) for c in zip(*outs))


def describe_keypoints_plain(levels, blurred, xys):
    """Plain PyTorch version of `describe_keypoints` (any device)."""
    return _describe_per_level(
        (_gather_plain(a, xy), _gather_plain(b, xy)) for a, b, xy in zip(levels, blurred, xys)
    )


def describe_keypoints_per_level(levels, blurred, xys):
    """The same function by the per-level route: one patch-gather launch for
    every level (`extract_patches_levels`), then the PyTorch angle, BRIEF
    and packing ops on each level's view of the gathered patches."""
    both = extract_patches_levels(levels, blurred, xys)
    ends = np.cumsum([0] + [xy.shape[0] for xy in xys])
    return _describe_per_level((both[0, s:e], both[1, s:e]) for s, e in zip(ends[:-1], ends[1:]))


@functools.lru_cache(maxsize=None)
def describe_counter(device: torch.device) -> torch.Tensor:
    """The card's own count of fused-kernel launches, a (1,) int64 tensor on
    `device`: the kernel's first thread adds one, so launches replayed from
    a CUDA graph count too. Reading it (`int(...)`) synchronises; `zero_()`
    resets it."""
    return torch.zeros(1, dtype=torch.int64, device=device)


def _describe_cuda(levels, blurred, xys):
    """Launch csrc/orb_describe.cu once for all levels."""
    global describe_launches, _describe_fn
    if _describe_fn is None:
        _describe_fn = _kernels.orb_describe_fn()
    dev = xys[0].device
    xy = torch.cat(xys)
    m = xy.shape[0]
    angle = torch.empty((m,), dtype=torch.float32, device=dev)
    bits = torch.empty((m, 256), dtype=torch.int8, device=dev)
    words = torch.empty((m, 8), dtype=torch.int64, device=dev)
    if m == 0:
        return angle, bits, words
    table = _kernels.LevelTable()
    table.n_levels = len(levels)
    start = 0
    for l, (lvl, blur, kp) in enumerate(zip(levels, blurred, xys)):
        table.raw[l], table.blur[l] = lvl.data_ptr(), blur.data_ptr()
        table.h[l], table.w[l] = lvl.shape
        table.start[l] = start
        start += kp.shape[0]
    table.start[len(levels)] = start
    pairs = _device_tables(dev)[3]
    # The launch is asynchronous; `xy` and the caller's level buffers may be
    # released before it runs, which is safe because the caching allocator
    # reuses a block only for work queued later on the same stream.
    with torch.cuda.device(dev):
        err = _describe_fn(
            table, xy.data_ptr(), pairs.data_ptr(), angle.data_ptr(), bits.data_ptr(), words.data_ptr(),
            describe_counter(dev).data_ptr(), m, torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"orb_describe launch failed: cudaError {err}")
    describe_launches += 1
    return angle, bits, words


def describe_keypoints(
    levels: list[torch.Tensor], blurred: list[torch.Tensor], xys: list[torch.Tensor]
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Keypoints of every pyramid level -> orientations and descriptors.

    levels[l], blurred[l]: the raw level and its 7x7-blurred copy, f32
    (h_l, w_l); xys[l]: that level's keypoints, int32 (n_l, 2) as (x, y).
    Returns, with M = sum(n_l) and the levels concatenated in order:
    angle (M,) f32, the IC angle of the raw level; desc_i8 (M, 256) int8,
    the steered BRIEF bits of the blurred level; desc (M, 8) int64, the
    bits packed (bit j of word i is pair 32 i + j). Reads are edge-clamped,
    the keypoint clipped into the image first. One kernel launch on CUDA
    tensors; the plain version on CPU tensors.
    """
    _check_level_args(levels, blurred, xys)
    if xys[0].device.type == "cuda":
        return _describe_cuda(levels, blurred, xys)
    return describe_keypoints_plain(levels, blurred, xys)
