"""Image pyramid and 7x7 Gaussian blur (port of ops/image.py).

The reference's CPU lowering (XLA) contracts `a * b + c` into one fused
multiply-add in the resize coordinates, the bilinear blend and the blur's
tap chain. A plain f32 transcription therefore differs from it by up to
4e-3 gray levels at pyramid level 1, enough to move FAST scores and
keypoints. Here every such step is evaluated as the exact product plus
addend in float64 and rounded once to float32, i.e. as the same fused
multiply-add; the pyramid and the blur then equal the reference's values
bit for bit (tests/test_torch_orb.py checks it). The order of the terms
follows the reference's contraction: `fma(a, 1 - w, b * w)` for the
blend, `fma(k0, s0, k1 * s1)` then `fma(k_i, s_i, acc)` for the taps.

Images are float32 (H, W) grayscale in 0..255.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

N_LEVELS = 8
SCALE_FACTOR = 1.2


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """round_f32(a * b + c) with one rounding, for f32 operands."""
    return (a.double() * b.double() + c.double()).float()


def pyramid_shapes(h: int, w: int, n_levels: int = N_LEVELS, scale: float = SCALE_FACTOR):
    """Static per-level (H, W) list, matching ComputePyramid's rounding."""
    shapes = []
    for l in range(n_levels):
        s = 1.0 / (scale**l)
        shapes.append((max(1, int(round(h * s))), max(1, int(round(w * s)))))
    return shapes


def _sample_coords(n_in: int, n_out: int, device) -> tuple[torch.Tensor, ...]:
    """Half-pixel source coordinates: (i0, i1, weight) per output index."""
    s = float(np.float32(n_in / n_out))
    i = torch.arange(n_out, dtype=torch.float32, device=device) + 0.5
    c = (i.double() * s - 0.5).float()  # fma(i + 0.5, s, -0.5)
    c0 = torch.clamp(torch.floor(c), 0, n_in - 1)
    c1 = torch.clamp(c0 + 1, 0, n_in - 1)
    wgt = torch.clamp(c - c0, 0.0, 1.0)
    return c0.long(), c1.long(), wgt


def resize_bilinear(img: torch.Tensor, out_hw: tuple[int, int]) -> torch.Tensor:
    """Bilinear resize with half-pixel centers (cv::resize INTER_LINEAR)."""
    h, w = img.shape[-2], img.shape[-1]
    oh, ow = out_hw
    y0, y1, wy = _sample_coords(h, oh, img.device)
    x0, x1, wx = _sample_coords(w, ow, img.device)
    r0 = img[..., y0, :]
    r1 = img[..., y1, :]
    top = _fma(r0[..., :, x0], 1 - wx, r0[..., :, x1] * wx)
    bot = _fma(r1[..., :, x0], 1 - wx, r1[..., :, x1] * wx)
    wy = wy[:, None]
    return _fma(top, 1 - wy, bot * wy)


def build_pyramid(img: torch.Tensor, n_levels: int = N_LEVELS, scale: float = SCALE_FACTOR):
    """List of per-level images; level 0 is the input, each further level
    is resized from the previous one (as the reference)."""
    shapes = pyramid_shapes(img.shape[-2], img.shape[-1], n_levels, scale)
    levels = [img]
    for l in range(1, n_levels):
        levels.append(resize_bilinear(levels[-1], shapes[l]))
    return levels


@functools.lru_cache(maxsize=None)
def _gaussian_kernel1d(ksize: int, sigma: float, device: torch.device) -> torch.Tensor:
    """Normalized f32 taps, computed on the CPU so every device uses the
    same bits (they equal the reference's), uploaded once per device."""
    r = (ksize - 1) / 2
    x = torch.arange(ksize, dtype=torch.float32) - r
    k = torch.exp(-(x**2) / (2.0 * sigma**2))
    return (k / torch.sum(k)).to(device)


def _reflect101_index(n: int, pad: int, device) -> torch.Tensor:
    """Source indices of a BORDER_REFLECT_101 padded axis of length n."""
    i = torch.arange(-pad, n + pad, device=device)
    i = torch.abs(i)
    return torch.where(i > n - 1, 2 * (n - 1) - i, i)


def _tap_chain(k: torch.Tensor, slices: list[torch.Tensor]) -> torch.Tensor:
    acc = _fma(k[0], slices[0], k[1] * slices[1])
    for i in range(2, len(slices)):
        acc = _fma(k[i], slices[i], acc)
    return acc


def gaussian_blur(img: torch.Tensor, ksize: int = 7, sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur with BORDER_REFLECT_101 padding."""
    k = _gaussian_kernel1d(ksize, sigma, img.device)
    pad = ksize // 2
    h, w = img.shape[-2], img.shape[-1]
    p = img[..., _reflect101_index(h, pad, img.device), :]
    r = _tap_chain(k, [p[..., i : i + h, :] for i in range(ksize)])
    p2 = r[..., :, _reflect101_index(w, pad, img.device)]
    return _tap_chain(k, [p2[..., :, i : i + w] for i in range(ksize)])


def gaussian_blur7(img: torch.Tensor) -> torch.Tensor:
    return gaussian_blur(img, ksize=7, sigma=2.0)
