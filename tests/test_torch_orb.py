"""Parity of the port's ORB extractor with the JAX reference (ops/orb.py,
ops/image.py) on the CPU, on a rendered 240x320 frame with 300 features.

What was reached: every resize and blur step equals the reference bit for
bit when run on its own (the port evaluates the reference's fused
multiply-adds exactly, see ops/image.py). Inside the reference's
whole-pyramid program XLA evaluates some levels' sample coordinates
without the fused multiply-add, so chained pyramid levels are gated at
atol 1e-2 gray levels (the largest difference seen is 4.3e-4 on one row
of one level); keypoints are gated exactly at level 0 and at >= 99% equal
slots overall.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_cpp_fork_tpu.ops import image as jim
from orbslam3_cpp_fork_tpu.ops import orb as jorb
from orbslam3_cpp_fork_tpu.ops import patches as jpatches
from orbslam3_cpp_fork_tpu_torch.datasets import synthetic
from orbslam3_cpp_fork_tpu_torch.ops import image as tim
from orbslam3_cpp_fork_tpu_torch.ops import orb as torb
from orbslam3_cpp_fork_tpu_torch.ops import patches as tpatches

H, W, NF = 240, 320, 300


def _frame(i=3):
    scene = synthetic.make_ring_scene(seed=7, n_points=1200, size_range=(9, 15), width=W, height=H)
    Rs, ts = synthetic.circle_trajectory(n_frames=300, radius=2.5, total_angle=2.3 * np.pi)
    return synthetic.to_u8(synthetic.render_frame(scene, Rs[i], ts[i])).astype(np.float32)


@pytest.fixture(scope="module")
def both():
    img = _frame()
    ref = jorb.extract_orb_jit(jnp.asarray(img), jorb.OrbParams(n_features=NF))
    ref = {k: np.asarray(getattr(ref, k)) for k in ("xy", "level", "angle", "score", "desc", "desc_i8", "valid")}
    got = torb.extract_orb(torch.from_numpy(img), torb.OrbParams(n_features=NF))
    got_np = {k: getattr(got, k).numpy() for k in ("xy", "level", "angle", "score", "desc_i8", "valid")}
    got_np["desc"] = got.desc_numpy()
    return img, ref, got_np


def _slot_equal(ref, got):
    return (
        np.all(ref["xy"] == got["xy"], axis=1) & (ref["level"] == got["level"]) & (ref["valid"] == got["valid"])
    )


def test_level0_keypoints_exact(both):
    _, ref, got = both
    for src in (ref, got):
        assert src["valid"].sum() > 100
    r0 = ref["valid"] & (ref["level"] == 0)
    g0 = got["valid"] & (got["level"] == 0)
    assert np.array_equal(r0, g0), "tolerance: exact (level-0 slots)"
    assert np.array_equal(ref["xy"][r0], got["xy"][g0]), "tolerance: exact (level-0 xy)"


def test_slots_agree(both):
    _, ref, got = both
    frac = _slot_equal(ref, got).mean()
    assert frac >= 0.99, f"tolerance: >= 99% equal slots (xy, level, valid); got {frac:.4f}"
    assert np.array_equal(ref["score"][_slot_equal(ref, got)], got["score"][_slot_equal(ref, got)]), (
        "tolerance: exact FAST scores on agreeing slots"
    )


def test_pyramid_within_tolerance(both):
    img = both[0]
    ref = jax.jit(lambda x: jim.build_pyramid(x))(jnp.asarray(img))
    got = tim.build_pyramid(torch.from_numpy(img))
    errs = [float(np.abs(np.asarray(r) - g.numpy()).max()) for r, g in zip(ref, got)]
    assert errs[0] == 0.0, "tolerance: level 0 is the input, exact"
    assert max(errs) <= 1e-2, f"tolerance: atol 1e-2 gray levels; per-level max diff {errs}"


@pytest.mark.parametrize("level", range(1, 8))
def test_resize_step_exact(both, level):
    # One resize from the reference's own previous level: bitwise.
    img = both[0]
    shapes = jim.pyramid_shapes(H, W)
    prev = np.asarray(jax.jit(lambda x: jim.build_pyramid(x))(jnp.asarray(img))[level - 1])
    ref = np.asarray(jax.jit(lambda x: jim.resize_bilinear(x, shapes[level]))(jnp.asarray(prev)))
    got = tim.resize_bilinear(torch.from_numpy(prev.copy()), shapes[level]).numpy()
    assert np.array_equal(got, ref), f"tolerance: bitwise; max diff {np.abs(got - ref).max()}"


@pytest.mark.parametrize("shape,seed", [((240, 320), 0), ((67, 89), 1), ((7, 9), 2)])
def test_gaussian_blur_exact(shape, seed):
    x = np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)
    ref = np.asarray(jax.jit(jim.gaussian_blur7)(jnp.asarray(x)))
    got = tim.gaussian_blur7(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, ref), f"tolerance: bitwise; max diff {np.abs(got - ref).max()}"


def test_angles_and_descriptors(both):
    img, ref, got = both
    agree = _slot_equal(ref, got) & ref["valid"]
    d = np.abs(np.angle(np.exp(1j * (ref["angle"][agree].astype(np.float64) - got["angle"][agree]))))
    assert d.max() <= 1e-4, f"tolerance: 1e-4 rad on agreeing slots; max diff {d.max()}"
    # Descriptor bits are exact wherever both blurred patches are equal.
    jl = jax.jit(lambda x: jim.build_pyramid(x))(jnp.asarray(img))
    tl = tim.build_pyramid(torch.from_numpy(img))
    same = np.zeros_like(agree)
    for l in range(8):
        sel = np.nonzero(agree & (ref["level"] == l))[0]
        if len(sel) == 0:
            continue
        xy = np.round(ref["xy"][sel] / 1.2**l).astype(np.int32)
        pr = np.asarray(jax.jit(jpatches.extract_patches)(jax.jit(jim.gaussian_blur7)(jl[l]), jnp.asarray(xy)))
        pg = tpatches.extract_patches(tim.gaussian_blur7(tl[l]), torch.from_numpy(xy)).numpy()
        same[sel] = np.all(pr.reshape(len(sel), -1) == pg.reshape(len(sel), -1), axis=1)
    assert same.sum() >= 0.95 * agree.sum(), "tolerance: equal blurred patches on >= 95% of agreeing slots"
    assert np.array_equal(ref["desc"][same], got["desc"][same]), "tolerance: exact descriptor words"
    assert np.array_equal(ref["desc_i8"][same], got["desc_i8"][same]), "tolerance: exact descriptor bits"
    assert got["desc"].dtype == np.uint32


@pytest.mark.parametrize("seed", [0, 1])
def test_fast_and_nms_exact(seed):
    # Integer images: many exact score ties, as at pyramid level 0.
    x = np.random.default_rng(seed).integers(0, 255, (61, 83)).astype(np.float32)
    ref = np.asarray(jax.jit(jorb.fast_raw_score)(jnp.asarray(x)))
    got = torb.fast_raw_score(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, ref), "tolerance: exact FAST score"
    assert np.array_equal(torb.nms3(torch.from_numpy(ref.copy())).numpy(), np.asarray(jorb.nms3_jit(jnp.asarray(ref)))), (
        "tolerance: exact NMS"
    )


def test_select_keypoints_exact_with_ties():
    rng = np.random.default_rng(5)
    s = rng.integers(0, 6, (100, 130)).astype(np.float32) * (rng.uniform(size=(100, 130)) < 0.3)
    ref = jax.jit(jorb.select_keypoints, static_argnums=(1,))(jnp.asarray(s), 150)
    got = torb.select_keypoints(torch.from_numpy(s), 150)
    for r, g, name in zip(ref, got, ("xy", "score", "valid")):
        assert np.array_equal(np.asarray(r), g.numpy()), f"tolerance: exact {name} (ties by first index)"


def test_per_level_budget_and_caps():
    for nf in (300, 1000, 2000):
        assert torb._per_level_budget(nf, 8, 1.2) == jorb._per_level_budget(nf, 8, 1.2)


def test_pack_unpack_roundtrip():
    bits = np.random.default_rng(3).integers(0, 2, (50, 256)).astype(np.int8)
    words = torb.pack_bits(torch.from_numpy(bits))
    ref = np.packbits(bits.astype(np.uint8), axis=-1, bitorder="little").view(np.uint32)
    assert np.array_equal(words.numpy().astype(np.uint32), ref), "tolerance: exact"
    assert np.array_equal(torb.unpack_bits(words).numpy(), bits), "tolerance: exact"
