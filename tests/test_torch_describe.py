"""The port's describe stage (keypoints of all levels -> IC angles, steered
BRIEF bits, packed words), on the CPU.

(a) `describe_keypoints_plain` against the JAX reference's chain
    extract_patches_dual -> ic_angle_from_patches -> brief_from_patches ->
    packed words, on the same pyramid levels and keypoints: angle within
    1e-5 rad (wrap-aware), bits and words exact wherever both sides land in
    the same 12-degree bin.
(b) A numpy model of the fused CUDA kernel's algorithm (csrc/orb_describe.cu:
    clamped reads, float64 moments rounded once, `rint` bin, the uint16 pair
    table exactly as uploaded, ballot-order packing) against the plain
    version, under the same rule, on border keypoints, flat (zero-moment)
    windows, a level without keypoints and N = 1, 127, 129.
(c) `extract_orb`, which now describes all levels in one call, against the
    reference's extractor and against the per-level composition.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from orbslam3_cpp_fork_tpu.ops import orb as jorb
from orbslam3_cpp_fork_tpu.ops import patches as jp
from orbslam3_cpp_fork_tpu_torch.datasets import synthetic
from orbslam3_cpp_fork_tpu_torch.ops import image as tim
from orbslam3_cpp_fork_tpu_torch.ops import orb as torb
from orbslam3_cpp_fork_tpu_torch.ops import patches as tp

H, W, NF = 200, 264, 200
TOL_ANGLE = 1e-5  # rad; f32 moment sums in another order, atan2 of another libm


def _angle_diff(a, b):
    return np.abs(np.angle(np.exp(1j * (a.astype(np.float64) - b.astype(np.float64)))))


def _bins(angle):
    return tp.quantize_angle(torch.from_numpy(np.asarray(angle, np.float32))).numpy()


def _frame(i=5):
    scene = synthetic.make_ring_scene(seed=7, n_points=1200, size_range=(9, 15), width=W, height=H)
    Rs, ts = synthetic.circle_trajectory(n_frames=300, radius=2.5, total_angle=2.3 * np.pi)
    return synthetic.to_u8(synthetic.render_frame(scene, Rs[i], ts[i])).astype(np.float32)


@pytest.fixture(scope="module")
def pyramid():
    """Levels 0, 2, 4, 6 of a rendered frame, their blurred copies and each
    level's own valid keypoints (corners: well-conditioned moments) followed
    by border and corner positions inside the image."""
    p = torb.OrbParams(n_features=NF)
    levels = tim.build_pyramid(torch.from_numpy(_frame()))
    picked = []
    for l in (0, 2, 4, 6):
        lvl = levels[l].contiguous()
        xy, _, valid = torb.level_keypoints(lvl, torb.level_caps(p)[l], p)
        h, w = lvl.shape
        edges = torch.tensor(
            [[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1], [w // 2, 0], [w // 2, h - 1], [0, h // 2],
             [w - 1, h // 2], [18, 19], [w - 20, h - 21]], dtype=torch.int32)
        picked.append((lvl, tim.gaussian_blur7(lvl).contiguous(), torch.cat([xy[valid], edges])))
    assert sum(int(x[2].shape[0]) for x in picked) > 150
    return [list(c) for c in zip(*picked)]


def _check_against(ref, got, what, max_bin_frac):
    """ref, got: (angle, bits, words as uint32) numpy triples."""
    d = _angle_diff(ref[0], got[0])
    assert d.max() <= TOL_ANGLE, f"{what}: tolerance {TOL_ANGLE} rad (wrap-aware); max diff {d.max()}"
    same = _bins(ref[0]) == _bins(got[0])
    assert (~same).mean() <= max_bin_frac, (
        f"{what}: tolerance {max_bin_frac:.1%} of slots in another bin; got {(~same).sum()} of {same.size}"
    )
    assert np.array_equal(ref[1][same], got[1][same]), f"{what}: tolerance exact bits on equal bins"
    assert np.array_equal(ref[2][same], got[2][same]), f"{what}: tolerance exact words on equal bins"


def _plain_np(levels, blurred, xys):
    angle, bits, words = tp.describe_keypoints_plain(levels, blurred, xys)
    assert angle.dtype == torch.float32 and bits.dtype == torch.int8 and words.dtype == torch.int64
    assert int(words.min()) >= 0 and int(words.max()) < 2**32, "each word is a uint32 value"
    return angle.numpy(), bits.numpy(), words.numpy().astype(np.uint32)


def test_plain_describe_matches_reference_chain(pyramid):
    levels, blurred, xys = pyramid
    got = _plain_np(levels, blurred, xys)
    ref = []
    for lvl, blur, xy in zip(levels, blurred, xys):
        praw, pblur = jax.jit(jp.extract_patches_dual)(
            jnp.asarray(lvl.numpy()), jnp.asarray(blur.numpy()), jnp.asarray(xy.numpy())
        )
        angle = jax.jit(jp.ic_angle_from_patches)(praw)
        bits = np.asarray(jax.jit(jp.brief_from_patches)(pblur, angle))
        words = np.packbits(bits.astype(np.uint8), axis=-1, bitorder="little").view(np.uint32)
        ref.append((np.asarray(angle), bits, words))
    ref = [np.concatenate(c) for c in zip(*ref)]
    assert got[0].shape == ref[0].shape and got[1].shape == ref[1].shape and got[2].shape == ref[2].shape
    _check_against(ref, got, "plain describe vs the JAX chain", max_bin_frac=0.01)


def test_describe_dispatches_to_plain_on_cpu_and_counts_nothing(pyramid):
    levels, blurred, xys = pyramid
    before = (tp.launches, tp.describe_launches)
    got = tp.describe_keypoints(levels, blurred, xys)
    ref = tp.describe_keypoints_plain(levels, blurred, xys)
    per_level = tp.describe_keypoints_per_level(levels, blurred, xys)
    for g, r, q in zip(got, ref, per_level):
        assert torch.equal(g, r) and torch.equal(q, r), "tolerance: exact (the same code on CPU tensors)"
    assert (tp.launches, tp.describe_launches) == before, "CPU tensors launch no kernel"


# ---- (b) a numpy model of the fused kernel ------------------------------


def _bf16_rn(x):
    """float32 -> nearest bfloat16 (ties to even), returned as float32."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _kernel_model(levels, blurred, xys):
    """csrc/orb_describe.cu in numpy, one keypoint (= one block) at a time."""
    pairs = tp._brief_pair_table()
    assert pairs.dtype == np.uint16 and pairs.shape == (30, 256, 2)
    side = 31
    dy, dx = np.divmod(np.arange(side * side), side)
    dy, dx = dy - 15, dx - 15
    circ = dx * dx + dy * dy <= 15 * 15 + 15
    wr, wc = np.divmod(np.arange(1600), 40)
    scale = np.float32(4.7746482927568605)
    starts = np.cumsum([0] + [int(x.shape[0]) for x in xys])
    xy_all = np.concatenate([x.numpy() for x in xys])
    m = int(starts[-1])
    angle = np.zeros(m, np.float32)
    bits = np.zeros((m, 256), np.int8)
    words = np.zeros((m, 8), np.uint32)
    for i in range(m):
        l = 0
        while l + 1 < len(levels) and i >= starts[l + 1]:
            l += 1
        raw, blur = levels[l].numpy(), blurred[l].numpy()
        h, w = raw.shape
        x = min(max(int(xy_all[i, 0]), 0), w - 1)
        y = min(max(int(xy_all[i, 1]), 0), h - 1)
        win = _bf16_rn(blur[np.clip(y + wr - 19, 0, h - 1), np.clip(x + wc - 19, 0, w - 1)])
        v = raw[np.clip(y + dy[circ], 0, h - 1), np.clip(x + dx[circ], 0, w - 1)].astype(np.float64)
        f10 = np.float32(np.sum(v * dx[circ]))
        f01 = np.float32(np.sum(v * dy[circ]))
        a = np.float32(0.0) if (f10 == 0 and f01 == 0) else np.arctan2(f01, f10)
        angle[i] = a
        b = int(np.rint(np.float32(a * scale))) % 30  # Python's % is non-negative
        bit = win[pairs[b, :, 1]] > win[pairs[b, :, 0]]
        bits[i] = bit
        # __ballot_sync: lane j of warp k sets bit j of word k.
        words[i] = (bit.reshape(8, 32).astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(axis=1)
    return angle, bits, words


def test_kernel_model_matches_plain_on_a_pyramid(pyramid):
    levels, blurred, xys = pyramid
    _check_against(_plain_np(levels, blurred, xys), _kernel_model(levels, blurred, xys),
                   "kernel model vs plain (4 levels, corners and borders)", max_bin_frac=0.01)


def _blob_image(h, w, seed):
    """Smooth blobs on a flat background: corners with clear gradients."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    img = np.full((h, w), 40.0)
    for _ in range(15):
        cx, cy, s, a = rng.uniform(0, w), rng.uniform(0, h), rng.uniform(3, 9), rng.uniform(40, 150)
        img += a * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s * s))
    return np.clip(img, 0, 255).astype(np.float32)


@pytest.mark.parametrize("n", [1, 127, 129])
def test_kernel_model_matches_plain_edge_cases(n):
    """Keypoints on and beyond the border (clipped first), a level with no
    keypoints between two that have some, and a flat level whose windows
    have zero moments (angle 0, bin 0 on both sides)."""
    rng = np.random.default_rng(n)
    shapes = [(70, 90), (50, 64), (41, 43), (45, 52)]
    levels = [torch.from_numpy(_blob_image(h, w, n + i)) for i, (h, w) in enumerate(shapes)]
    levels[3] = torch.full(shapes[3], 77.25)
    blurred = [tim.gaussian_blur7(l).contiguous() for l in levels]

    def kps(h, w, k):
        xy = np.stack([rng.integers(-20, w + 20, k), rng.integers(-20, h + 20, k)], 1)
        fixed = np.array([[0, 0], [w - 1, h - 1], [-5, -7], [w + 3, h + 9]])[: min(k, 4)]
        xy[: len(fixed)] = fixed
        return torch.from_numpy(xy.astype(np.int32))

    xys = [kps(*shapes[0], n), torch.zeros((0, 2), dtype=torch.int32), kps(*shapes[2], 7), kps(*shapes[3], 5)]
    plain = _plain_np(levels, blurred, xys)
    model = _kernel_model(levels, blurred, xys)
    assert plain[0].shape == (n + 12,)
    # Where a window is nearly flat its moments nearly cancel and the angle
    # is ill-conditioned in f32, so the angle gate covers the slots with a
    # clear gradient and the bit gate every slot whose bins agree.
    flat = slice(n + 7, n + 12)
    assert np.all(plain[0][flat] == 0) and np.all(model[0][flat] == 0), "zero moments: angle exactly 0"
    assert np.array_equal(plain[1][flat], model[1][flat]) and not plain[1][flat].any()
    same = _bins(plain[0]) == _bins(model[0])
    assert np.array_equal(plain[1][same], model[1][same]), "tolerance: exact bits on equal bins"
    assert np.array_equal(plain[2][same], model[2][same]), "tolerance: exact words on equal bins"
    # An f32 sum of 709 terms up to 255 * 15 is off by a few tenths, which
    # is 1e-5 rad of angle only where the moment vector is longer than ~5e4.
    strong = _moment_norm(levels, xys) >= 5e4
    assert strong.sum() >= 0.5 * (len(strong) - 5)
    d = _angle_diff(plain[0], model[0])
    assert d[strong].max() <= TOL_ANGLE, f"tolerance {TOL_ANGLE} rad where |m| >= 5e4; max {d[strong].max()}"
    assert (~same)[strong].sum() == 0, "tolerance: equal bins wherever the gradient is clear"


def _moment_norm(levels, xys):
    out = []
    w = torch.from_numpy(tp._moment_weights()).double()
    for lvl, xy in zip(levels, xys):
        m = tp._gather_plain(lvl, xy).reshape(xy.shape[0], 1600).double() @ w
        out.append(torch.linalg.norm(m, dim=1).numpy())
    return np.concatenate(out)


def test_pair_table_is_the_plain_index_tables():
    ia, ib = tp._brief_pair_index()
    t = tp._brief_pair_table()
    assert t.dtype == np.uint16 and t.max() < 1600
    assert np.array_equal(t[..., 0], ia) and np.array_equal(t[..., 1], ib), "tolerance: exact"
    up = tp._device_tables(torch.device("cpu"))[3]
    assert up.dtype == torch.int16 and np.array_equal(up.numpy().view(np.uint16), t), "uploaded bits unchanged"


@pytest.mark.parametrize(
    "case", ["levels_mismatch", "too_many_levels", "bad_xy_dtype", "bad_image_dtype", "shape_mismatch", "no_levels"]
)
def test_describe_rejects_bad_inputs(case):
    img = torch.zeros((50, 60))
    xy = torch.zeros((3, 2), dtype=torch.int32)
    args = {
        "levels_mismatch": ([img, img], [img], [xy, xy]),
        "too_many_levels": ([img] * 9, [img] * 9, [xy] * 9),
        "bad_xy_dtype": ([img], [img], [xy.long()]),
        "bad_image_dtype": ([img.double()], [img.double()], [xy]),
        "shape_mismatch": ([img], [torch.zeros((50, 61))], [xy]),
        "no_levels": ([], [], []),
    }[case]
    with pytest.raises(ValueError):
        tp.describe_keypoints(*args)


# ---- (c) the extractor after the restructuring ---------------------------


@pytest.fixture(scope="module")
def extracted():
    img = _frame()
    ref = jorb.extract_orb_jit(jnp.asarray(img), jorb.OrbParams(n_features=NF))
    ref = {k: np.asarray(getattr(ref, k)) for k in ("xy", "level", "angle", "score", "desc", "desc_i8", "valid")}
    got = torb.extract_orb(torch.from_numpy(img), torb.OrbParams(n_features=NF))
    out = {k: getattr(got, k).numpy() for k in ("xy", "level", "angle", "score", "desc_i8", "valid")}
    out["desc"] = got.desc_numpy()
    return img, ref, out


def test_extract_orb_matches_reference(extracted):
    _, ref, got = extracted
    agree = (
        np.all(ref["xy"] == got["xy"], axis=1) & (ref["level"] == got["level"])
        & (ref["valid"] == got["valid"]) & ref["valid"]
    )
    assert ref["valid"].sum() > 100
    assert agree.sum() >= 0.99 * ref["valid"].sum(), "tolerance: >= 99% of valid slots equal (xy, level)"
    d = _angle_diff(ref["angle"][agree], got["angle"][agree])
    assert d.max() <= 1e-4, f"tolerance: 1e-4 rad on agreeing slots; max diff {d.max()}"
    words_equal = np.all(ref["desc"][agree] == got["desc"][agree], axis=1)
    assert words_equal.mean() >= 0.95, (
        f"tolerance: exact descriptor words on >= 95% of agreeing slots; got {words_equal.mean():.4f}"
    )
    bits = np.unpackbits(got["desc"].view(np.uint8), axis=-1, bitorder="little")
    assert np.array_equal(bits, got["desc_i8"]), "tolerance: exact (words are the packed bits)"


def test_extract_orb_is_the_per_level_composition(extracted):
    """One describe call over all levels gives what the loop over levels
    gives: gather, angle, BRIEF and packing level by level, then the trim."""
    img, _, got = extracted
    p = torb.OrbParams(n_features=NF)
    levels = tim.build_pyramid(torch.from_numpy(img))
    caps = torb.level_caps(p)
    rows = []
    for l, lvl in enumerate(levels):
        xy, score, valid = torb.level_keypoints(lvl, caps[l], p)
        praw, pblur = tp.extract_patches_dual(lvl.contiguous(), tim.gaussian_blur7(lvl).contiguous(), xy)
        angle = tp.ic_angle_from_patches(praw)
        bits = tp.brief_from_patches(pblur, angle)
        for j in np.nonzero(valid.numpy())[0]:
            rows.append((l, int(xy[j, 0]), int(xy[j, 1]), float(angle[j]), bits[j].numpy()))
    by_key = {(l, x, y): (a, b) for l, x, y, a, b in rows}
    n = 0
    for i in np.nonzero(got["valid"])[0]:
        l = int(got["level"][i])
        x, y = np.round(got["xy"][i] / 1.2**l).astype(int)
        a, b = by_key[(l, int(x), int(y))]
        assert got["angle"][i] == np.float32(a), "tolerance: exact angle"
        assert np.array_equal(got["desc_i8"][i], b), "tolerance: exact bits"
        n += 1
    assert n == got["valid"].sum() > 100
