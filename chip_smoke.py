#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and ignored):
  1. device  - the card's name and power limit (nvidia-smi);
  2. build   - compile every csrc/*.cu with nvcc for sm_90a, in parallel;
  3. kernel  - each kernel against its plain PyTorch version on the card.
               Patch gather: every pyramid level of a rendered 752x480 frame
               with that level's real keypoints, plus border/corner keypoints
               and N = 1, 127, 129; bitwise equality required. Fused describe
               (gather + IC angle + steered BRIEF, all 8 levels in one
               launch): the same frame, plus border keypoints, a level
               without keypoints, a flat level and N = 1, 127, 129; angle
               within 1e-5 rad, bits exact wherever both sides quantize the
               angle to the same bin. Times of both, of their plain versions
               and of the per-level route at the main path's shapes (CUDA
               events over runs of calls), and each kernel's bound;
  4. main    - a seeded localization map (L = 4096, 1000 features) of the
               bench ring sequence and localization-only tracking of its
               first frames through LocalizationTracker.track on the card:
               frames tracked, ATE against ground truth, per-frame latency,
               fused-kernel launches as the card itself counted them; the
               first frames are also tracked on the CPU (plain versions) and
               must agree;
  5. per-level path - the describe stage by the earlier route (one
               patch-gather launch per level, then PyTorch ops) over the
               first frames, its launches counted and its output held against
               the fused kernel's.
`--profile N` adds a torch.profiler pass over N frames (kernel launches and
device time per frame, host time per stage), `--compare-routes` a timing of
the tracker with the describe stage by either route; both are off by default.
The last line of standard output is the JSON device record.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import warnings
from pathlib import Path

# ATE RMSE (GT scale, m) of the JAX reference package's fused_frame_program
# chained over the same 120 frames against the same seeded map (752x480,
# 1000 features, L = 4096, a keyframe every 10 frames), on a CPU; the port
# must not be worse than this plus TOL_ATE_M. How it was measured: PERF.md.
JAX_ATE_M = 0.00969087002638239
TOL_ATE_M = 0.005
MIN_TRACKED_FRAC = 0.95
N_LEVELS = 8
FRAMES = 120  # tracked frames of the ring sequence
KF_EVERY = 10  # keyframe spacing of the seeded map
CAPACITY = 4096  # local-map capacity L (the runtime's local_lm_cap)
N_FEATURES = 1000
CPU_CHECK = 3  # first frames re-tracked on the CPU
PER_LEVEL_FRAMES = 12  # frames described by the per-level route
TOL_ANGLE = 1e-5  # rad, fused kernel (f64 moments) vs plain (f32 matmul)
# Moment vectors shorter than this (and not exactly zero) make the plain
# version's f32 angle ill-conditioned: its sums are off by a few tenths.
MIN_MOMENT = 5e4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
F32_FLOPS = 67e12  # H100 SXM data sheet, float32 outside the tensor cores


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 50, trials: int = 7) -> float:
    """Milliseconds per fn() call: CUDA events around a run of `reps`
    back-to-back calls, elapsed time over the count; median of `trials`."""
    import torch

    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    times.sort()
    return times[len(times) // 2]


def render_ring(n_frames: int):
    """The bench ring sequence (bench.py): scene, GT poses, uint8 frames."""
    import numpy as np

    from orbslam3_cpp_fork_tpu_torch.datasets import synthetic

    scene = synthetic.make_ring_scene(seed=7, n_points=1200, size_range=(9, 15), width=752, height=480)
    Rs, ts = synthetic.circle_trajectory(n_frames=300, radius=2.5, total_angle=2.3 * np.pi)
    frames = [synthetic.to_u8(synthetic.render_frame(scene, Rs[i], ts[i])) for i in range(n_frames)]
    return scene, Rs[:n_frames], ts[:n_frames], frames


def frame_levels(dev, frame, orb_params):
    """One frame's describe inputs as the extractor makes them: the 8 raw
    levels, their blurred copies, each level's keypoints, the valid mask."""
    import torch

    from orbslam3_cpp_fork_tpu_torch.ops import image, orb

    img = torch.from_numpy(frame.astype("float32")).to(dev)
    levels = [lvl.contiguous() for lvl in image.build_pyramid(img, orb_params.n_levels, orb_params.scale_factor)]
    blurred = [image.gaussian_blur7(lvl).contiguous() for lvl in levels]
    caps = orb.level_caps(orb_params)
    kps = [orb.level_keypoints(lvl, caps[l], orb_params) for l, lvl in enumerate(levels)]
    return levels, blurred, [k[0].contiguous() for k in kps], torch.cat([k[2] for k in kps])


def describe_diff(got, ref, gate):
    """(max angle error over the gated slots, slots in another bin, gated
    slots in another bin, differing bits on equal bins, slots)."""
    import math

    import torch

    from orbslam3_cpp_fork_tpu_torch.ops import patches

    if not (torch.isfinite(got[0]).all() and got[1].shape == ref[1].shape and got[2].shape == ref[2].shape):
        fail("fused describe output is non-finite or mis-shaped")
    d = torch.abs(torch.remainder(got[0].double() - ref[0].double() + math.pi, 2 * math.pi) - math.pi)
    same = patches.quantize_angle(got[0]) == patches.quantize_angle(ref[0])
    bad_bits = int((got[1][same] != ref[1][same]).sum()) + int((got[2][same] != ref[2][same]).sum())
    err = float(d[gate].max()) if bool(gate.any()) else 0.0
    return err, int((~same).sum()), int((~same & gate).sum()), bad_bits, int(same.numel())


def moment_norm(levels, xys):
    """|(m10, m01)| of every slot in float64, from the plain gather."""
    import torch

    from orbslam3_cpp_fork_tpu_torch.ops import patches

    w = patches._device_tables(levels[0].device)[2].double()
    return torch.cat([
        torch.linalg.norm(patches._gather_plain(lvl, xy).reshape(-1, 1600).double() @ w, dim=1)
        for lvl, xy in zip(levels, xys)
    ])


def phase_kernel_gather(dev, inputs):
    """Patch gather vs plain at the main path's 8 level shapes and edge cases."""
    import torch

    from orbslam3_cpp_fork_tpu_torch.ops import patches

    levels, blurred, xys, _ = inputs
    cases = [(f"level{l}", levels[l], blurred[l], xys[l]) for l in range(len(levels))]
    h, w = levels[0].shape
    border = torch.tensor(
        [[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1], [w // 2, 0], [w // 2, h - 1],
         [0, h // 2], [w - 1, h // 2], [-5, -7], [w + 3, h + 9], [5, 3], [w - 4, h - 2]],
        dtype=torch.int32,
    ).to(dev)
    g = torch.Generator().manual_seed(0)
    for n in (1, 127, 129):
        xy = torch.stack(
            [torch.randint(-20, w + 20, (n,), generator=g), torch.randint(-20, h + 20, (n,), generator=g)], 1
        ).to(torch.int32).to(dev)
        cases.append((f"n{n}", cases[0][1], cases[0][2], xy))
    cases.append(("border", cases[0][1], cases[0][2], border))

    max_err = 0.0
    for name, a, b, xy in cases:
        pa, pb = patches.extract_patches_dual(a, b, xy)
        torch.cuda.synchronize()
        ra, rb = patches._gather_plain(a, xy), patches._gather_plain(b, xy)
        err = max(float((pa - ra).abs().max()), float((pb - rb).abs().max())) if xy.shape[0] else 0.0
        if not (torch.equal(pa, ra) and torch.equal(pb, rb)):
            fail(f"patch_gather differs from the plain version on {name}: max abs err {err}")
        max_err = max(max_err, err)
    log(f"kernel: patch_gather == plain bitwise on {len(cases)} cases "
        f"({', '.join(c[0] for c in cases)}); max_abs_err {max_err}")

    ms = plain_ms = 0.0
    for name, a, b, xy in cases[:N_LEVELS]:
        k = cuda_ms(lambda: patches.extract_patches_dual(a, b, xy))
        p = cuda_ms(lambda: (patches._gather_plain(a, xy), patches._gather_plain(b, xy)))
        log(f"kernel: {name} {tuple(a.shape)} N={xy.shape[0]}: kernel {k:.4f} ms, plain {p:.4f} ms")
        ms += k
        plain_ms += p
    log(f"kernel: patch_gather per frame (8 levels): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    m = sum(int(xy.shape[0]) for xy in xys)
    n_bytes = sum(2 * 4 * lvl.numel() for lvl in levels) + 8 * m + 2 * m * 1600 * 4
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3  # a copy: no arithmetic
    log(f"kernel: patch_gather bound: {n_bytes} bytes (each level and blurred level read once, {m} x 2 patches "
        f"written) / {HBM_BYTES_PER_S:.3g} B/s = {bound_ms:.6f} ms per frame; kernel at {bound_ms / ms:.2%} of it")
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes")


def phase_kernel_describe(dev, inputs):
    """Fused describe vs plain on a real frame's 8 levels (one launch) and
    on edge cases; then its time, the plain version's and the per-level
    route's, per frame."""
    import torch

    from orbslam3_cpp_fork_tpu_torch.ops import image, patches

    levels, blurred, xys, valid = inputs
    g = torch.Generator().manual_seed(1)
    cases = [("frame", levels, blurred, xys, valid)]
    shapes = [(133, 211), (50, 64), (41, 43), (45, 52)]
    yy, xx = torch.meshgrid(torch.arange(133.0), torch.arange(211.0), indexing="ij")
    for n in (1, 127, 129):
        ramp = (30 + (1.1 * xx + 0.9 * yy) % 200 + 20 * torch.rand((133, 211), generator=g)).clamp(0, 255)
        lv = [ramp, ramp[:50, :64].contiguous(), ramp[10:51, 20:63].contiguous(), torch.full(shapes[3], 77.25)]
        lv = [x.to(dev) for x in lv]

        def kps(hw, k):
            h, w = hw
            xy = torch.stack(
                [torch.randint(-20, w + 20, (k,), generator=g), torch.randint(-20, h + 20, (k,), generator=g)], 1)
            fixed = torch.tensor([[0, 0], [w - 1, h - 1], [-5, -7], [w + 3, h + 9]])[: min(k, 4)]
            xy[: len(fixed)] = fixed
            return xy.to(torch.int32).to(dev)

        # Level 1 has no keypoints; level 3 is flat (zero moments).
        kp = [kps(shapes[0], n), torch.zeros((0, 2), dtype=torch.int32, device=dev), kps(shapes[2], 7),
              kps(shapes[3], 5)]
        cases.append((f"edges_n{n}", lv, [image.gaussian_blur7(x).contiguous() for x in lv], kp, None))

    worst = 0.0
    for name, lv, bl, kp, gate in cases:
        got = patches.describe_keypoints(lv, bl, kp)
        torch.cuda.synchronize()
        ref = patches.describe_keypoints_plain(lv, bl, kp)
        norm = moment_norm(lv, kp)
        strong = (norm >= MIN_MOMENT) | (norm == 0)
        gate = strong if gate is None else gate & strong
        err, bins, bins_gated, bad_bits, n = describe_diff(got, ref, gate)
        log(f"kernel: orb_describe vs plain on {name}: {n} slots in 1 launch, {int(gate.sum())} gated (valid "
            f"keypoints with |m| >= {MIN_MOMENT:g} or 0); max angle err {err:.3e} rad on gated slots; "
            f"differing bins {bins} (gated {bins_gated}); differing bits on equal bins {bad_bits}")
        if name != "frame" and (got[0][-5:].any() or got[1][-5:].any() or got[2][-5:].any()):
            fail(f"orb_describe on {name}: a flat window must give angle 0 and no set bit")
        if err > TOL_ANGLE:
            fail(f"orb_describe angle differs from the plain version on {name}: {err} rad > {TOL_ANGLE}")
        if bad_bits:
            fail(f"orb_describe on {name}: {bad_bits} bits differ where both bins agree")
        if bins_gated > 0.01 * max(int(gate.sum()), 100):
            fail(f"orb_describe on {name}: {bins_gated} gated slots in another bin than the plain version")
        worst = max(worst, err)

    # Turns: fused, plain, per-level, per-level, plain, fused; the mean of each.
    fns = dict(
        fused=lambda: patches.describe_keypoints(levels, blurred, xys),
        plain=lambda: patches.describe_keypoints_plain(levels, blurred, xys),
        per_level=lambda: patches.describe_keypoints_per_level(levels, blurred, xys),
    )
    order = ["fused", "plain", "per_level", "per_level", "plain", "fused"]
    t = {k: [] for k in fns}
    for k in order:
        t[k].append(cuda_ms(fns[k]))
    ms, plain_ms, per_level_ms = (sum(t[k]) / len(t[k]) for k in ("fused", "plain", "per_level"))
    m = sum(int(xy.shape[0]) for xy in xys)
    log(f"kernel: orb_describe per frame ({m} slots, 8 levels): fused kernel (1 launch) {ms:.4f} ms "
        f"{t['fused']}; plain {plain_ms:.4f} ms; per-level route (8 gather launches + PyTorch ops) "
        f"{per_level_ms:.4f} ms {t['per_level']}")
    pairs = patches._device_tables(dev)[3]
    n_bytes = (sum(2 * 4 * lvl.numel() for lvl in levels) + 8 * m + pairs.numel() * 2
               + m * (4 + 256 + 64))
    n_flops = m * (709 * 4 + 256)  # two multiply-adds a moment tap, one compare a pair
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S * 1e3, n_flops / F32_FLOPS * 1e3
    bound_ms = max(by_bytes, by_ops)
    log(f"kernel: orb_describe bound: {n_bytes} bytes / {HBM_BYTES_PER_S:.3g} B/s = {by_bytes:.6f} ms; "
        f"{n_flops} operations / {F32_FLOPS:.3g} /s = {by_ops:.6f} ms; bound {bound_ms:.6f} ms per frame; "
        f"kernel (with its wrapper) at {bound_ms / ms:.2%} of it")
    return dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if by_bytes >= by_ops else "operations", per_level_ms=per_level_ms)


def make_tracker_factory(dev, scene, Rs, ts, orb_params, capacity, kf_every):
    import time as _time

    from orbslam3_cpp_fork_tpu_torch import convert
    from orbslam3_cpp_fork_tpu_torch.datasets import synthetic
    from orbslam3_cpp_fork_tpu_torch.runtime.localization import LocalizationTracker

    t0 = _time.perf_counter()
    snap = synthetic.seed_local_map(scene, Rs, ts, capacity, kf_every, orb_params, dev)
    log(f"main: seeded map {int(snap['valid'].sum())}/{capacity} landmarks from "
        f"{len(range(0, len(Rs), kf_every))} keyframes in {_time.perf_counter() - t0:.2f} s")
    K = scene.K
    cam = convert.camera_from_numpy(K[0, 0], K[1, 1], K[0, 2], K[1, 2])
    pose0 = (Rs[0].T, -Rs[0].T @ ts[0])

    def make(device):
        return LocalizationTracker(
            cam, orb_params, convert.local_map_from_numpy(snap, device), device, initial_pose=pose0
        )

    return make


def phase_main(dev, make, ts, frames, n_check, gate_ate):
    import numpy as np
    import torch

    from orbslam3_cpp_fork_tpu_torch.ops import patches
    from orbslam3_cpp_fork_tpu_torch.utils.evaluation import ate_rmse

    # Warm-up on a throwaway tracker (allocator, library handles), so the
    # measured run's first frame is not a cold start.
    warm = make(dev)
    warm.track(frames[0], 0.0)
    torch.cuda.synchronize()

    trk = make(dev)
    lat = []
    syncs: list[str] = []
    counter = patches.describe_counter(dev)
    counter.zero_()
    patches.describe_launches = 0
    patches.launches = 0
    for i, f in enumerate(frames):
        t1 = time.perf_counter()
        # Any host sync inside the frame program is recorded (PyTorch's
        # sync debug mode warns on it); the latency sync below is outside.
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                trk.track(f, i * 0.05)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        # (The mode's own "prototype feature" notice is not a sync.)
        syncs.extend(str(w.message) for w in caught if "called a synchronizing" in str(w.message))
        torch.cuda.synchronize()
        lat.append((time.perf_counter() - t1) * 1e3)
    # The card's own count, read once, after the run and outside the
    # sync-debug window; the wrapper's host-side count beside it.
    launches = int(counter)
    host_launches, gather_launches = patches.describe_launches, patches.launches
    log(f"main: host syncs inside the frame program over {len(frames)} frames: {len(syncs)}")
    for msg in sorted(set(syncs))[:5]:
        log(f"main: sync: {msg.splitlines()[0]}")
    stamps, T, ok = trk.trajectory()

    if not np.isfinite(T).all() or T.shape != (len(frames), 4, 4):
        fail(f"non-finite or mis-shaped poses {T.shape}")
    C = np.stack([-T[i, :3, :3].T @ T[i, :3, 3] for i in range(len(frames))])
    ate = ate_rmse(stamps, C, stamps, ts)
    n_ok = int(ok.sum())
    lat_a = np.asarray(lat)
    log(f"main: tracked {n_ok}/{len(frames)} frames; ATE RMSE {ate.rmse:.6f} m "
        f"(scaled {ate.rmse_scaled:.6f} m)")
    log(f"main: per-frame latency median {np.median(lat_a):.3f} ms, p99 {np.percentile(lat_a, 99):.3f} ms, "
        f"mean {lat_a.mean():.3f} ms")
    log(f"main: orb_describe launches counted on the card {launches}, by the wrapper {host_launches} "
        f"(>= 1 x {len(frames)} required); patch_gather launches {gather_launches}: that kernel is off the "
        f"main path now and is driven by the per-level path below")

    # The repo's own reference for the card's output: the same frames
    # through the plain versions on the CPU.
    cpu = make(torch.device("cpu"))
    worst = 0.0
    for i in range(n_check):
        Tc = cpu.track(frames[i], i * 0.05).numpy()
        worst = max(worst, float(np.linalg.norm((-Tc[:3, :3].T @ Tc[:3, 3]) - C[i])))
    log(f"main: card vs CPU port over the first {n_check} frames: max camera-centre diff {worst:.2e} m")

    if syncs:
        fail(f"{len(syncs)} host syncs inside the frame program")
    if launches < len(frames) or host_launches != launches:
        fail(f"orb_describe ran {launches} times on the card ({host_launches} by the wrapper's count) "
             f"for {len(frames)} frames")
    if n_ok < MIN_TRACKED_FRAC * len(frames):
        fail(f"tracked {n_ok}/{len(frames)} < {MIN_TRACKED_FRAC:.0%}")
    if not gate_ate:
        log("main: ATE gate skipped (not the default configuration the JAX bound was measured on)")
    elif ate.rmse > JAX_ATE_M + TOL_ATE_M:
        fail(f"ATE {ate.rmse:.6f} m > JAX reference {JAX_ATE_M} m + {TOL_ATE_M} m")
    if worst > 1e-3:
        fail(f"card and CPU poses differ by {worst} m (> 1 mm)")
    return launches


def phase_per_level_path(dev, frames, orb_params):
    """The describe stage by the earlier route on the first frames: 8
    patch-gather launches a frame, then PyTorch ops; held against the fused
    kernel on the same inputs."""
    import torch

    from orbslam3_cpp_fork_tpu_torch.ops import patches

    inputs = [frame_levels(dev, f, orb_params) for f in frames]
    torch.cuda.synchronize()
    patches.launches = 0
    outs = [patches.describe_keypoints_per_level(lv, bl, kp) for lv, bl, kp, _ in inputs]
    torch.cuda.synchronize()
    launches = patches.launches
    worst, bins_all, slots = 0.0, 0, 0
    for (lv, bl, kp, valid), got in zip(inputs, outs):
        fused = patches.describe_keypoints(lv, bl, kp)
        norm = moment_norm(lv, kp)
        err, bins, bins_gated, bad_bits, n = describe_diff(fused, got, valid & ((norm >= MIN_MOMENT) | (norm == 0)))
        if err > TOL_ANGLE or bad_bits or bins_gated > 0.01 * n:
            fail(f"per-level route and fused kernel disagree: angle {err} rad, {bad_bits} bits on equal bins, "
                 f"{bins_gated} gated slots in another bin")
        worst, bins_all, slots = max(worst, err), bins_all + bins, slots + n
    log(f"per-level path: {len(frames)} frames, patch_gather launches {launches} (>= {N_LEVELS} x {len(frames)} "
        f"required); vs fused kernel: max angle err {worst:.3e} rad, differing bins {bins_all} of {slots} slots, "
        f"0 differing bits on equal bins")
    if launches < N_LEVELS * len(frames):
        fail(f"patch_gather launched {launches} times for {len(frames)} frames")
    return launches


def phase_profile(dev, make, frames, orb_params, n):
    """torch.profiler over n tracked frames: kernel launches and device
    time per frame, the fused kernel's device time, host time per stage,
    and the kernels one describe call launches by either route."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from orbslam3_cpp_fork_tpu_torch.ops import camera, matching, orb, patches
    from orbslam3_cpp_fork_tpu_torch.optim import pose_opt
    from orbslam3_cpp_fork_tpu_torch.runtime import device_step

    def dev_us(e):
        return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)

    def kernels(prof):
        # Device-side events that are kernels: not copies, not the mirrored
        # record_function ranges.
        evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        return [e for e in evs if not e.key.startswith(("Memcpy", "Memset", "stage:"))]

    stages = [(orb, "extract_orb"), (patches, "describe_keypoints"), (pose_opt, "pose_optimization"),
              (matching, "hamming_matrix"), (matching, "window_penalty"), (matching, "match_nn"),
              (device_step, "project_landmarks"), (device_step, "undistort_points")]
    saved = [(m, k, getattr(m, k)) for m, k in stages]

    def ranged(fn, name):
        def inner(*a, **kw):
            with record_function(f"stage:{name}"):
                return fn(*a, **kw)
        return inner

    trk = make(dev)
    for i in range(2):
        trk.track(frames[i], i * 0.05)
    torch.cuda.synchronize()
    for m, k, fn in saved:
        setattr(m, k, ranged(fn, k))
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for i in range(2, 2 + n):
                trk.track(frames[i], i * 0.05)
            torch.cuda.synchronize()
    finally:
        for m, k, fn in saved:
            setattr(m, k, fn)
    ks = kernels(prof)
    count = sum(e.count for e in ks)
    total = sum(dev_us(e) for e in ks)
    log(f"profile: {n} frames: {count / n:.1f} kernel launches per frame, {total / n / 1e3:.3f} ms of device "
        f"time per frame")
    for e in ks:
        if "orb_describe" in e.key or "patch_gather" in e.key:
            log(f"profile: kernel {e.key[:60]}: {e.count} launches, {dev_us(e) / e.count:.2f} us of device time each")
    for e in prof.key_averages():
        if e.key.startswith("stage:") and e.device_type == DeviceType.CPU:
            log(f"profile: host {e.key}: {e.cpu_time_total / n / 1e3:.3f} ms per frame over {e.count / n:.1f} calls "
                f"(profiled, so inflated)")

    levels, blurred, xys, _ = frame_levels(dev, frames[0], orb_params)
    for name, fn in (("fused", patches.describe_keypoints), ("per-level", patches.describe_keypoints_per_level)):
        calls = 50  # many, so that events lost while the trace starts do not show
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn(levels, blurred, xys)
            torch.cuda.synchronize()
        ks = kernels(prof)
        log(f"profile: one describe call by the {name} route: {sum(e.count for e in ks) / calls:.2f} kernel "
            f"launches, {sum(dev_us(e) for e in ks) / calls:.2f} us of device time ({calls} calls)")


def phase_compare_routes(dev, make, frames, block=10):
    """Per-frame latency of the same tracker with the describe stage by the
    fused kernel and by the per-level route, in alternating blocks of
    frames within one process (the two give the same poses, so one chain
    serves both)."""
    import numpy as np
    import torch

    from orbslam3_cpp_fork_tpu_torch.ops import patches

    routes = {"fused": patches.describe_keypoints, "per_level": patches.describe_keypoints_per_level}
    lat = {k: [] for k in routes}
    trk = make(dev)
    try:
        for i, f in enumerate(frames):
            name = "fused" if (i // block) % 2 == 0 else "per_level"
            patches.describe_keypoints = routes[name]
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            trk.track(f, i * 0.05)
            torch.cuda.synchronize()
            if i % block:  # the first frame after a switch is left out
                lat[name].append((time.perf_counter() - t1) * 1e3)
    finally:
        patches.describe_keypoints = routes["fused"]
    for name, v in lat.items():
        a = np.asarray(v)
        log(f"routes: describe by the {name} route: per-frame latency median {np.median(a):.3f} ms, "
            f"p99 {np.percentile(a, 99):.3f} ms, mean {a.mean():.3f} ms over {len(a)} frames "
            f"(alternating blocks of {block})")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=FRAMES,
                    help="frames to track; any other count than the default skips the ATE gate")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="also profile N tracked frames with torch.profiler (default: off)")
    ap.add_argument("--compare-routes", action="store_true",
                    help="also time the tracker with the describe stage by either route, in alternating blocks")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a CUDA card")
    repo = Path(__file__).resolve().parent
    if not (repo / "orbslam3_cpp_fork_tpu_torch" / "csrc" / "orb_describe.cu").is_file():
        fail(f"{repo} is not a checkout of the repository (port package missing)")
    sys.path.insert(0, str(repo))

    from orbslam3_cpp_fork_tpu_torch.device import get_device
    from orbslam3_cpp_fork_tpu_torch.ops import _kernels
    from orbslam3_cpp_fork_tpu_torch.ops.orb import OrbParams

    card = card_line()
    log(f"device: {card}")
    dev = get_device()

    t0 = time.perf_counter()
    names = _kernels.build_all()
    for name in names:
        _kernels.load(name)
    log(f"build: {', '.join(n + '.cu' for n in names)} in parallel in {time.perf_counter() - t0:.2f} s")
    for name in names:
        secs, ptxas = _kernels.build_info.get(name, (0.0, ""))
        log(f"build: {name}.cu: nvcc {secs:.2f} s")
        for line in ptxas.strip().splitlines():
            log(f"build: {name}: {line.strip()}")

    orb_params = OrbParams(n_features=N_FEATURES)
    scene, Rs, ts, frames = render_ring(args.frames)
    inputs = frame_levels(dev, frames[0], orb_params)
    gather = phase_kernel_gather(dev, inputs)
    describe = phase_kernel_describe(dev, inputs)
    make = make_tracker_factory(dev, scene, Rs, ts, orb_params, CAPACITY, KF_EVERY)
    describe_launches = phase_main(
        dev, make, ts, frames, min(CPU_CHECK, args.frames), gate_ate=args.frames == FRAMES
    )
    gather_launches = phase_per_level_path(dev, frames[: min(PER_LEVEL_FRAMES, args.frames)], orb_params)
    if args.compare_routes:
        phase_compare_routes(dev, make, frames)
    if args.profile:
        phase_profile(dev, make, frames, orb_params, min(args.profile, args.frames - 2))

    tpu_kernel = "orbslam3_cpp_fork_tpu/ops/patches.py:50"
    record = {"kernels": [
        {
            "name": "orb_describe", "route": "cuda",
            "source": "orbslam3_cpp_fork_tpu_torch/csrc/orb_describe.cu", "replaces": tpu_kernel,
            "launches": describe_launches, "max_abs_err": describe["max_abs_err"],
            "ms": describe["ms"], "plain_ms": describe["plain_ms"],
            "bound_ms": describe["bound_ms"], "bound_by": describe["bound_by"],
            # No single PyTorch call gathers windows, sums moments and
            # compares rotated pixel pairs.
            "library_ms": None,
            "per_level_route_ms": describe["per_level_ms"],
        },
        {
            "name": "patch_gather_dual", "route": "cuda",
            "source": "orbslam3_cpp_fork_tpu_torch/csrc/patch_gather.cu", "replaces": tpu_kernel,
            "launches": gather_launches, "max_abs_err": gather["max_abs_err"],
            "ms": gather["ms"], "plain_ms": gather["plain_ms"],
            "bound_ms": gather["bound_ms"], "bound_by": gather["bound_by"],
            # The plain version is ~10 clamps and an advanced-indexing read;
            # no single PyTorch call gathers clamped windows.
            "library_ms": None,
        },
    ]}
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
