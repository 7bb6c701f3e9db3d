"""Parity of the port's patch gather, IC angle and BRIEF with the JAX
reference (ops/patches.py), on the CPU.

The port's plain gather is held bitwise against the Pallas kernel run in
interpret mode and against the reference's XLA gather path; the BRIEF bits
against the reference's bf16 matmul on identical patches.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_cpp_fork_tpu.ops import patches as jp
from orbslam3_cpp_fork_tpu_torch.ops import patches as tp


def _image(h, w, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.0, 255.0, (h, w)).astype(np.float32)


def _keypoints(h, w, n, seed, outside=0):
    """n random keypoints plus every border and corner case; `outside`
    widens the range past the image (the gather clips first)."""
    rng = np.random.default_rng(seed)
    edges = np.array(
        [[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1], [w // 2, 0], [w // 2, h - 1],
         [0, h // 2], [w - 1, h // 2], [1, 1], [w - 2, h - 2], [18, 19], [w - 20, h - 21]],
        np.int32,
    )
    rnd = np.stack(
        [rng.integers(-outside, w + outside, n), rng.integers(-outside, h + outside, n)], 1
    ).astype(np.int32)
    return np.concatenate([edges, rnd])


def test_plain_gather_matches_pallas_kernel_interpret():
    h, w = 60, 150
    img = _image(h, w, 0)
    xy = _keypoints(h, w, 118, 1, outside=25)  # 130 keypoints
    # Inputs prepared exactly as extract_patches' TPU branch does.
    x = np.clip(xy[:, 0], 0, w - 1)
    y = np.clip(xy[:, 1], 0, h - 1)
    xy_c = np.stack([x, y], -1).astype(np.int32)
    padded = jnp.pad(jnp.asarray(img), ((jp.RAD, 29), (jp.RAD, 256 + 19)), mode="edge")
    n_pad = -len(xy) % jp._BK
    xy_p = jnp.pad(jnp.asarray(xy_c), ((0, n_pad), (0, 0)))
    ref = np.asarray(jp._extract_patches_tpu(padded, xy_p, interpret=True))[: len(xy), :, : jp.PATCH_COLS]
    got = tp.extract_patches(torch.from_numpy(img), torch.from_numpy(xy)).numpy()
    assert got.shape == ref.shape == (130, 40, 40)
    assert np.array_equal(got, ref), (
        f"tolerance: bitwise; max abs diff {np.abs(got - ref).max()} vs the Pallas kernel"
    )


@pytest.mark.parametrize("h,w,n,seed", [(60, 150, 130, 2), (97, 41, 7, 3), (240, 320, 300, 4)])
def test_plain_gather_matches_xla_gather(h, w, n, seed):
    img = _image(h, w, seed)
    xy = _keypoints(h, w, n, seed + 10, outside=30)
    ref = np.asarray(jax.jit(jp.extract_patches)(jnp.asarray(img), jnp.asarray(xy)))
    got = tp.extract_patches(torch.from_numpy(img), torch.from_numpy(xy)).numpy()
    assert np.array_equal(got, ref), f"tolerance: bitwise; max abs diff {np.abs(got - ref).max()}"


def test_dual_gather_matches_reference():
    # Keypoints inside the image, borders and corners included: extract_orb
    # only ever gathers those for valid features.
    h, w = 80, 120
    a, b = _image(h, w, 5), _image(h, w, 6)
    xy = _keypoints(h, w, 100, 7)
    ra, rb = jax.jit(jp.extract_patches_dual)(jnp.asarray(a), jnp.asarray(b), jnp.asarray(xy))
    ga, gb = tp.extract_patches_dual(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(xy))
    assert np.array_equal(ga.numpy(), np.asarray(ra)), "tolerance: bitwise (raw image patches)"
    assert np.array_equal(gb.numpy(), np.asarray(rb)), "tolerance: bitwise (blurred image patches)"


def test_brief_diff_table_and_moment_weights_match():
    assert np.array_equal(tp._brief_diff_table(), jp._brief_diff_table()), "tolerance: exact"
    assert np.array_equal(tp._moment_weights(), jp._moment_weights()), "tolerance: exact"


def test_quantize_angle_matches_including_bin_edges():
    rng = np.random.default_rng(8)
    step = 2 * np.pi / jp.N_ANGLE_BINS
    edges = (np.arange(-31, 31) + 0.5) * step
    angle = np.concatenate([rng.uniform(-np.pi, np.pi, 500), edges, [-np.pi, np.pi, 0.0]]).astype(np.float32)
    ref = np.asarray(jax.jit(jp.quantize_angle)(jnp.asarray(angle)))
    got = tp.quantize_angle(torch.from_numpy(angle)).numpy()
    assert np.array_equal(got, ref), "tolerance: exact bins (round half to even)"


@pytest.mark.parametrize("quantized", [False, True])
def test_brief_bits_exact_on_identical_patches(quantized):
    rng = np.random.default_rng(9 + quantized)
    n = 257
    if quantized:
        # Pixel values that collide after bf16 rounding (> 128 the bf16 step
        # is 1 gray level, below 1/2 or finer): ties and near-ties.
        p = rng.integers(100, 140, (n, 40, 40)).astype(np.float32) + rng.choice(
            [0.0, 0.25, 0.5, 0.75], (n, 40, 40)
        ).astype(np.float32)
    else:
        p = rng.uniform(0.0, 255.0, (n, 40, 40)).astype(np.float32)
    angle = rng.uniform(-np.pi, np.pi, n).astype(np.float32)
    ref = np.asarray(jax.jit(jp.brief_from_patches)(jnp.asarray(p), jnp.asarray(angle)))
    got = tp.brief_from_patches(torch.from_numpy(p), torch.from_numpy(angle)).numpy()
    assert got.dtype == np.int8
    assert np.array_equal(got, ref), (
        f"tolerance: exact bits; {int((got != ref).sum())} of {got.size} differ"
    )


@pytest.mark.parametrize("integer", [True, False])
def test_ic_angle_matches(integer):
    # Corner-like patches: an intensity ramp in a random direction plus
    # noise (uniform noise alone has near-zero moments, where atan2 is
    # ill-conditioned). Integer pixels are the level-0 case.
    rng = np.random.default_rng(11 + integer)
    n = 300
    th = rng.uniform(-np.pi, np.pi, n)
    yy, xx = np.mgrid[-19:21, -19:21]
    ramp = np.cos(th)[:, None, None] * xx + np.sin(th)[:, None, None] * yy
    p = np.clip(128 + rng.uniform(0.5, 4.0, (n, 1, 1)) * ramp + rng.normal(0, 10, (n, 40, 40)), 0, 255)
    p = (np.round(p) if integer else p).astype(np.float32)
    ref = np.asarray(jax.jit(jp.ic_angle_from_patches)(jnp.asarray(p)))
    got = tp.ic_angle_from_patches(torch.from_numpy(p)).numpy()
    d = np.abs(np.angle(np.exp(1j * (got.astype(np.float64) - ref))))
    assert d.max() <= 1e-5, f"tolerance: 1e-5 rad; max diff {d.max()}"


@pytest.mark.parametrize(
    "img_dtype,xy_dtype,xy_shape",
    [(torch.float64, torch.int32, (4, 2)), (torch.float32, torch.int64, (4, 2)), (torch.float32, torch.int32, (4, 3))],
)
def test_gather_rejects_bad_inputs(img_dtype, xy_dtype, xy_shape):
    img = torch.zeros((30, 40), dtype=img_dtype)
    xy = torch.zeros(xy_shape, dtype=xy_dtype)
    with pytest.raises(ValueError):
        tp.extract_patches(img, xy)


def test_plain_gather_does_not_count_launches():
    before = tp.launches
    tp.extract_patches_dual(torch.zeros((30, 40)), torch.zeros((30, 40)), torch.zeros((5, 2), dtype=torch.int32))
    assert tp.launches == before


def _pyramid_slots(seed):
    """A seeded 752x480 pyramid (8 levels, the port's level shapes), its
    blurred copy, and the main path's 1,247 keypoint slots spread over the
    levels with level 5 left empty: random keypoints up to 25 px beyond
    each level's image plus every border and corner case."""
    from orbslam3_cpp_fork_tpu_torch.ops import image, orb

    rng = np.random.default_rng(seed)
    img = torch.from_numpy(rng.uniform(0.0, 255.0, (480, 752)).astype(np.float32))
    levels = [lvl.contiguous() for lvl in image.build_pyramid(img)]
    blurred = [image.gaussian_blur7(lvl).contiguous() for lvl in levels]
    caps = list(orb.level_caps(orb.OrbParams(n_features=1000)))
    caps[0], caps[5] = caps[0] + caps[5], 0
    xys = []
    for l, (lvl, n) in enumerate(zip(levels, caps)):
        h, w = lvl.shape
        xy = _keypoints(h, w, n - 12, seed + l, outside=25)[:n] if n else np.zeros((0, 2), np.int32)
        xys.append(torch.from_numpy(xy))
    return levels, blurred, xys, caps


def test_extract_patches_levels_matches_reference_level_by_level():
    levels, blurred, xys, caps = _pyramid_slots(12)
    assert sum(caps) == 1247 and len(levels) == 8 and caps[5] == 0
    got = tp.extract_patches_levels(levels, blurred, xys).numpy()
    assert got.shape == (2, 1247, 40, 40)
    ends = np.cumsum([0] + caps)
    for l, (lvl, blur, xy) in enumerate(zip(levels, blurred, xys)):
        a, b, xy_n = lvl.numpy(), blur.numpy(), xy.numpy()
        h, w = a.shape
        ga, gb = got[0, ends[l]:ends[l + 1]], got[1, ends[l]:ends[l + 1]]
        # The reference's own gather clips every keypoint first.
        ra = np.asarray(jax.jit(jp.extract_patches)(jnp.asarray(a), jnp.asarray(xy_n)))
        rb = np.asarray(jax.jit(jp.extract_patches)(jnp.asarray(b), jnp.asarray(xy_n)))
        assert np.array_equal(ga, ra) and np.array_equal(gb, rb), f"level {l}: tolerance bitwise"
        # Its dual gather stacks both images, so it clamps as the kernel
        # does only for keypoints inside the image (the extractor's own).
        inside = (xy_n[:, 0] >= 0) & (xy_n[:, 0] < w) & (xy_n[:, 1] >= 0) & (xy_n[:, 1] < h)
        if inside.any():
            da, db = jax.jit(jp.extract_patches_dual)(jnp.asarray(a), jnp.asarray(b), jnp.asarray(xy_n[inside]))
            assert np.array_equal(ga[inside], np.asarray(da)), f"level {l}: tolerance bitwise (dual, raw)"
            assert np.array_equal(gb[inside], np.asarray(db)), f"level {l}: tolerance bitwise (dual, blurred)"


def test_describe_per_level_route_equals_plain_on_cpu():
    levels, blurred, xys, _ = _pyramid_slots(13)
    before = tp.launches
    got = tp.describe_keypoints_per_level(levels, blurred, xys)
    ref = tp.describe_keypoints_plain(levels, blurred, xys)
    assert tp.launches == before, "the plain route counts no launch"
    for g, r in zip(got, ref):
        assert g.shape == r.shape and torch.equal(g, r), "tolerance: exact (the same patches, the same ops)"
