"""ORB feature extraction on whole images (port of ops/orb.py).

Per pyramid level: the threshold-free FAST-9/16 score, 3x3 non-maximum
suppression, the 20 -> 7 threshold fallback, a spatially balanced per-cell
top-8 selection; then, for all levels at once, the IC angle and the 30-bin
steered BRIEF (`patches.describe_keypoints`: one fused CUDA kernel launch
per image, see ops/patches.py). Levels are merged into a fixed-capacity
feature set by one stable ranked sort.

Ties follow the reference exactly: `argmax` takes the first index and
every ranking sort is stable. The per-frame path issues no host sync.
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np
import torch
import torch.nn.functional as F

from . import patches as patches_mod
from .image import N_LEVELS, SCALE_FACTOR, build_pyramid, gaussian_blur7

# 16 Bresenham circle offsets (dy, dx), circular order.
_CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

EDGE_MARGIN = 16  # reference minBorder = EDGE_THRESHOLD - 3
HALF_PATCH = 15  # IC_Angle patch radius

_PATTERN = np.load(os.path.join(os.path.dirname(__file__), "orb_pattern.npy"))  # (256,4)


@dataclasses.dataclass(frozen=True)
class Features:
    """SoA feature set for one image (all levels merged, fixed capacity).

    xy      (N,2) float32 — keypoint position at level-0 scale.
    level   (N,)  int32   — pyramid level (octave).
    angle   (N,)  float32 — orientation, radians.
    score   (N,)  float32 — FAST score.
    desc    (N,8) int64   — packed 256-bit descriptors, one uint32 word per
                            int64 (`desc_numpy` gives the reference's uint32).
    desc_i8 (N,256) int8  — unpacked bits.
    valid   (N,)  bool    — slot validity mask.
    """

    xy: torch.Tensor
    level: torch.Tensor
    angle: torch.Tensor
    score: torch.Tensor
    desc: torch.Tensor
    desc_i8: torch.Tensor
    valid: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.xy.shape[0]

    def desc_numpy(self) -> np.ndarray:
        """(N,8) uint32 packed words, bit for bit the reference's layout."""
        return self.desc.cpu().numpy().astype(np.uint32)


def _shifts32(device) -> torch.Tensor:
    return torch.arange(32, dtype=torch.int64, device=device)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(N,256) 0/1 bits -> (N,8) int64 words; bit j of word i is pair i*32+j."""
    shifts = _shifts32(bits.device)
    b = bits.to(torch.int64).reshape(-1, 8, 32)
    return torch.sum(b << shifts, dim=-1)


def unpack_bits(words: torch.Tensor) -> torch.Tensor:
    """(L,8) int64 words -> (L,256) int8 bits (np.unpackbits little order)."""
    shifts = _shifts32(words.device)
    return ((words[:, :, None] >> shifts) & 1).reshape(words.shape[0], 256).to(torch.int8)


def fast_raw_score(img: torch.Tensor) -> torch.Tensor:
    """Threshold-free FAST-9/16 corner measure for every pixel: the largest
    threshold t at which the pixel is still a FAST corner."""
    h, w = img.shape
    pad = 3
    img_pad = F.pad(img[None, None], (pad, pad, pad, pad), mode="replicate")[0, 0]
    diffs = torch.stack(
        [img_pad[pad + dy : pad + dy + h, pad + dx : pad + dx + w] - img for dy, dx in _CIRCLE.tolist()]
    )  # (16, H, W)

    def arc_score(d):
        # Windowed min over 9 contiguous circle samples: min9[s] = min(d[s..s+8]).
        m2 = torch.minimum(d, torch.roll(d, -1, dims=0))
        m4 = torch.minimum(m2, torch.roll(m2, -2, dims=0))
        m8 = torch.minimum(m4, torch.roll(m4, -4, dims=0))
        m9 = torch.minimum(m8, torch.roll(d, -8, dims=0))
        return torch.amax(m9, dim=0)

    score = torch.maximum(arc_score(diffs), arc_score(-diffs))
    score = torch.clamp_min(score, 0.0)
    yy = torch.arange(h, device=img.device)[:, None]
    xx = torch.arange(w, device=img.device)[None, :]
    inb = (yy >= pad) & (yy < h - pad) & (xx >= pad) & (xx < w - pad)
    return torch.where(inb, score, torch.zeros_like(score))


def fast_score(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """FAST-9/16 corner score at a threshold (0 where not a corner)."""
    s = fast_raw_score(img)
    return torch.where(s > threshold, s, torch.zeros_like(s))


def nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-maximum suppression (-inf padding at the border)."""
    m = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(score >= m, score, torch.zeros_like(score))


def orientation_maps(img: torch.Tensor) -> torch.Tensor:
    """(2, H, W) maps of m10 (x moment) and m01 (y moment) of the radius-15
    circular IC_Angle patch around every pixel (edge-padded image). One
    float64 convolution with the patch's moment weights, rounded to float32
    once (the reference's shift-add form was a TPU lowering choice)."""
    r = HALF_PATCH
    h, w = img.shape
    wts = torch.from_numpy(patches_mod._moment_weights()).to(img.device, torch.float64)
    kern = wts.T.reshape(2, 1, patches_mod.PATCH_ROWS, patches_mod.PATCH_COLS)
    kern = kern[:, :, patches_mod.RAD - r : patches_mod.RAD + r + 1, patches_mod.RAD - r : patches_mod.RAD + r + 1]
    p = F.pad(img.to(torch.float64)[None, None], (r, r, r, r), mode="replicate")
    return F.conv2d(p, kern.contiguous())[0].to(torch.float32).reshape(2, h, w)


def compute_angles(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """IC_Angle at integer keypoint positions xy = (x, y) on this level."""
    m = orientation_maps(img)
    x, y = xy[:, 0].long(), xy[:, 1].long()
    return torch.atan2(m[1][y, x], m[0][y, x])


def compute_descriptors(blurred: torch.Tensor, xy: torch.Tensor, angle: torch.Tensor):
    """Steered BRIEF-256 of integer keypoints on one blurred level: (packed
    words (N, 8) int64 holding uint32 values, bits (N, 256) int8). The
    patch gather (`patches.extract_patches`, the `csrc/patch_gather.cu`
    kernel on a CUDA tensor), then `brief_from_patches` and packing; bit j
    of word i is pair i*32 + j."""
    p = patches_mod.extract_patches(blurred, xy)
    bits = patches_mod.brief_from_patches(p, angle)
    return pack_bits(bits), bits


def _per_level_budget(n_features: int, n_levels: int, scale: float) -> list[int]:
    """Geometric per-level feature budget (reference ctor)."""
    inv = 1.0 / scale
    first = n_features * (1 - inv) / (1 - inv**n_levels)
    budgets, acc = [], 0
    for l in range(n_levels - 1):
        b = int(round(first * inv**l))
        budgets.append(b)
        acc += b
    budgets.append(max(n_features - acc, 0))
    return budgets


def select_keypoints(
    score: torch.Tensor, n_max: int, cell: int = 32, k_per_cell: int = 8
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Spatially balanced top-n_max selection.

    Returns (xy int32 (n_max,2) as (x,y), score (n_max,), valid (n_max,)):
    all cell-rank-0 features by score, then rank-1, ...
    """
    h, w = score.shape
    dev = score.device
    ch = math.ceil(h / cell)
    cw = math.ceil(w / cell)
    ph, pw = ch * cell, cw * cell
    s = F.pad(score, (0, pw - w, 0, ph - h))
    cells = s.reshape(ch, cell, cw, cell).permute(0, 2, 1, 3).reshape(ch * cw, cell * cell)
    k = min(k_per_cell, cell * cell)
    cols = torch.arange(cells.shape[1], device=dev)[None, :]
    cur = cells
    neg_inf = torch.full_like(cells, -math.inf)
    tops_s, tops_i = [], []
    for _ in range(k):
        a = torch.argmax(cur, dim=1)  # first index on ties, as jnp.argmax
        tops_s.append(torch.gather(cur, 1, a[:, None])[:, 0])
        tops_i.append(a)
        cur = torch.where(cols == a[:, None], neg_inf, cur)
    top_s = torch.stack(tops_s, dim=1)  # per-cell descending
    top_i = torch.stack(tops_i, dim=1)
    cidx = torch.arange(ch * cw, device=dev)
    iy = (cidx // cw)[:, None] * cell + top_i // cell
    ix = (cidx % cw)[:, None] * cell + top_i % cell
    rank = torch.arange(k, device=dev, dtype=torch.float32)[None, :].expand(top_s.shape)
    valid_c = top_s > 0.0
    # Small rank first, then high score (scores < 512, so rank*1024 dominates).
    key = torch.where(valid_c, rank * 1024.0 - top_s, torch.full_like(top_s, math.inf))
    key_f = key.reshape(-1)
    order = torch.argsort(key_f, stable=True)[:n_max]
    sel_valid = torch.isfinite(key_f[order])
    xy = torch.stack([ix.reshape(-1)[order], iy.reshape(-1)[order]], dim=-1).to(torch.int32)
    sel_s = top_s.reshape(-1)[order]
    return xy, torch.where(sel_valid, sel_s, torch.zeros_like(sel_s)), sel_valid


@dataclasses.dataclass(frozen=True)
class OrbParams:
    n_features: int = 1000
    n_levels: int = N_LEVELS
    scale_factor: float = SCALE_FACTOR
    th_fast_high: float = 20.0
    th_fast_low: float = 7.0
    cell: int = 32
    k_per_cell: int = 8
    # Slack so dense levels can absorb budget unfilled at sparse levels.
    level_slack: float = 1.25


def level_caps(p: OrbParams) -> list[int]:
    """Per-level keypoint capacity: the budget with slack (at least 8)."""
    budgets = _per_level_budget(p.n_features, p.n_levels, p.scale_factor)
    return [max(8, int(b * p.level_slack)) for b in budgets]


def level_keypoints(lvl: torch.Tensor, cap: int, p: OrbParams):
    """FAST + NMS + threshold fallback + border mask + balanced selection
    for one pyramid level: (xy int32 (cap,2), score (cap,), valid (cap,))."""
    zero = torch.zeros_like(lvl)
    raw = fast_raw_score(lvl)
    s_hi = nms3(torch.where(raw > p.th_fast_high, raw, zero))
    s_lo = nms3(torch.where(raw > p.th_fast_low, raw, zero))
    # Prefer high-threshold corners; low-threshold ones rank after them.
    s = torch.where(s_hi > 0, s_lo + 1024.0, torch.where(s_lo > 0, s_lo, zero))
    h, w = lvl.shape
    yy = torch.arange(h, device=lvl.device)[:, None]
    xx = torch.arange(w, device=lvl.device)[None, :]
    inb = (
        (yy >= EDGE_MARGIN) & (yy < h - EDGE_MARGIN)
        & (xx >= EDGE_MARGIN) & (xx < w - EDGE_MARGIN)
    )
    s = torch.where(inb, s, zero)
    return select_keypoints(s, cap, p.cell, p.k_per_cell)


def extract_orb(img: torch.Tensor, p: OrbParams = OrbParams()) -> Features:
    """Full ORB extraction for one grayscale image (float32, 0..255)."""
    levels = build_pyramid(img, p.n_levels, p.scale_factor)
    budgets = _per_level_budget(p.n_features, p.n_levels, p.scale_factor)
    caps = level_caps(p)
    dev = img.device

    per_level, blurred, xys = [], [], []
    for l, lvl in enumerate(levels):
        xy, score, valid = level_keypoints(lvl, caps[l], p)
        blurred.append(gaussian_blur7(lvl).contiguous())
        xys.append(xy)
        per_level.append(
            dict(
                xy=xy.to(torch.float32) * (p.scale_factor**l),
                level=torch.full((caps[l],), l, dtype=torch.int32, device=dev),
                score=torch.where(valid, score, torch.zeros_like(score)),
                valid=valid,
                rank=torch.arange(caps[l], dtype=torch.int32, device=dev),
                budget=torch.full((caps[l],), budgets[l], dtype=torch.int32, device=dev),
            )
        )
    cat = {k: torch.cat([d[k] for d in per_level]) for k in per_level[0]}
    # Orientations and descriptors of all levels at once (one kernel launch
    # on CUDA tensors, no patch tensor in device memory).
    cat["angle"], cat["desc_i8"], cat["desc"] = patches_mod.describe_keypoints(
        [lvl.contiguous() for lvl in levels], blurred, xys
    )
    # Global trim to n_features: in-budget slots first (by score), then
    # slack slots by score.
    in_budget = (cat["rank"] < cat["budget"]) & cat["valid"]
    base = torch.where(in_budget, 0.0, 4096.0)
    key = torch.where(
        cat["valid"],
        base - torch.clamp_max(cat["score"], 4095.0),
        torch.full_like(base, math.inf),
    )
    order = torch.argsort(key, stable=True)[: p.n_features]
    return Features(
        xy=cat["xy"][order],
        level=cat["level"][order],
        angle=cat["angle"][order],
        score=cat["score"][order],
        desc=cat["desc"][order],
        desc_i8=cat["desc_i8"][order],
        valid=torch.isfinite(key[order]),
    )
