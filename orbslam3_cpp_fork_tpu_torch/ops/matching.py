"""Descriptor matching as dense masked Hamming-distance matrices
(port of ops/matching.py).

H(a, b) = |a| + |b| - 2 a.b over 0/1 bits. The reference runs a.b as an
int8 matmul; here it is an f32 matmul of the bits, exact because every
partial sum is an integer below 2^24 once TF32 is off (device.py). Search
windows and scale bands are +INF penalties added to the distance matrix;
`argmin` takes the first index on ties, as the reference's does.
"""

from __future__ import annotations

import torch

TH_HIGH = 100
TH_LOW = 50
HISTO_LENGTH = 30
INF = 1e9

_POPCOUNT8 = None


def hamming_matrix(bits_a: torch.Tensor, bits_b: torch.Tensor) -> torch.Tensor:
    """(N,256) x (M,256) 0/1 bit arrays -> (N,M) int32 Hamming distances."""
    a = bits_a.to(torch.float32)
    b = bits_b.to(torch.float32)
    dot = (a @ b.T).to(torch.int32)
    wa = torch.sum(bits_a, dim=1, dtype=torch.int32)
    wb = torch.sum(bits_b, dim=1, dtype=torch.int32)
    return wa[:, None] + wb[None, :] - 2 * dot


def popcount_hamming(desc_a: torch.Tensor, desc_b: torch.Tensor) -> torch.Tensor:
    """Packed (N,8) x (M,8) words (int64 holding uint32) -> (N,M) int32,
    by XOR and a per-byte popcount table."""
    global _POPCOUNT8
    if _POPCOUNT8 is None:
        _POPCOUNT8 = torch.tensor([bin(i).count("1") for i in range(256)], dtype=torch.int32)
    table = _POPCOUNT8.to(desc_a.device)
    x = desc_a[:, None, :] ^ desc_b[None, :, :]
    total = torch.zeros(x.shape[:2], dtype=torch.int32, device=x.device)
    for byte in range(4):
        total = total + table[(x >> (8 * byte)) & 0xFF].sum(dim=-1, dtype=torch.int32)
    return total


def match_nn(
    dist: torch.Tensor,
    valid_a: torch.Tensor,
    valid_b: torch.Tensor,
    max_dist: float = TH_LOW,
    ratio: float = 1.0,
    cross_check: bool = True,
    extra_penalty: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Nearest-neighbour matching on a (possibly masked) distance matrix.

    Returns (idx_b (N,), ok (N,)): for each row, the matched column and
    whether it passed the threshold, ratio and mutual-best checks.
    """
    d = dist.to(torch.float32)
    d = torch.where(valid_a[:, None] & valid_b[None, :], d, torch.full_like(d, INF))
    if extra_penalty is not None:
        d = d + extra_penalty
    best = torch.argmin(d, dim=1)
    best_d = torch.gather(d, 1, best[:, None])[:, 0]
    cols = torch.arange(d.shape[1], device=d.device)[None, :]
    second_d = torch.amin(torch.where(cols == best[:, None], torch.full_like(d, INF), d), dim=1)
    ok = (best_d <= max_dist) & (best_d < ratio * second_d)
    if cross_check:
        col_best = torch.argmin(d, dim=0)  # (M,)
        ok = ok & (col_best[best] == torch.arange(d.shape[0], device=d.device))
    return best, ok


def window_penalty(
    uv_pred: torch.Tensor,
    xy_b: torch.Tensor,
    radius: torch.Tensor,
    level_b: torch.Tensor | None = None,
    level_min: torch.Tensor | None = None,
    level_max: torch.Tensor | None = None,
) -> torch.Tensor:
    """(N,M) additive penalty: 0 inside the square search window (and level
    band), +INF outside (Frame::GetFeaturesInArea)."""
    dx = torch.abs(uv_pred[:, None, 0] - xy_b[None, :, 0])
    dy = torch.abs(uv_pred[:, None, 1] - xy_b[None, :, 1])
    r = radius if radius.ndim else radius[None]
    inside = (dx <= r[:, None]) & (dy <= r[:, None])
    if level_b is not None:
        if level_min is not None:
            inside = inside & (level_b[None, :] >= level_min[:, None])
        if level_max is not None:
            inside = inside & (level_b[None, :] <= level_max[:, None])
    return torch.where(inside, torch.zeros_like(dx), torch.full_like(dx, INF))


def search_by_projection(
    bits_map: torch.Tensor,
    valid_map: torch.Tensor,
    uv_pred: torch.Tensor,
    pred_level: torch.Tensor,
    bits_frame: torch.Tensor,
    xy_frame: torch.Tensor,
    level_frame: torch.Tensor,
    valid_frame: torch.Tensor,
    radius: torch.Tensor,
    max_dist: int = TH_HIGH,
    ratio: float = 0.9,
    level_band: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Project-and-match (SearchByProjection): map descriptors vs frame
    features inside per-point windows at compatible scales."""
    dist = hamming_matrix(bits_map, bits_frame)
    pen = window_penalty(
        uv_pred, xy_frame, radius, level_frame,
        pred_level - level_band, pred_level + level_band,
    )
    return match_nn(
        dist, valid_map, valid_frame, max_dist, ratio, cross_check=True, extra_penalty=pen
    )
