#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one CUDA card.

Run from the root of a checkout:  python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and ignored):
  1. device  - the card's name and power limit (nvidia-smi);
  2. build   - compile every csrc/*.cu with nvcc for sm_90a, in parallel;
  3. kernel  - each kernel against its plain PyTorch version on the card.
               Patch gather: all 8 pyramid levels of a rendered 752x480
               frame with their real keypoints in one launch, plus
               border/corner keypoints and N = 1, 127, 129 with an empty
               level, and the one-level entry points; bitwise equality and
               one launch counted by the wrapper and on the card required;
               its device time by torch.profiler beside its bound. Fused describe
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
               patch-gather launch a frame for all levels, then PyTorch ops)
               over the first frames, its launches counted (= frames, by the
               wrapper and on the card), its output held against the fused
               kernel's, the gather's device time a frame by the profiler;
  6. slam    - monocular SLAM from a cold start on the same ring frames:
               MonoTracker (synchronous mapping) on the card with no seed
               map and no ground-truth pose: two-view initialization, fused
               tracking, keyframe insertion, triangulation, fusion, culling
               and window BA. Gates: the map initializes within the first
               40 frames, every later frame is tracked, >= 8 keyframes and
               >= 1000 landmarks at the end, a finite map, one describe
               launch per frame counted on the card, scale-aligned ATE
               within the bound. The phase runs twice and says whether both
               runs gave the same trajectory bit for bit;
  7. async   - the same cold start in the default mode, through the System
               facade: mapping on a worker thread, pipelined tracking
               (pipeline_lag 2), frames free-running, then shutdown. Gates:
               the map initializes within the first 40 frames, final state
               OK, no loss event, > 20 pipelined frames, the worker mapped
               keyframes on its own thread and raised nothing, > 80% of the
               frames exported with strictly increasing timestamps, every
               binding of a tracked frame points at a live landmark, a finite
               map, one describe launch per frame counted on the card, and a
               scale-aligned ATE within 2 x the slam phase's of this run +
               0.02 m. Reports track() latency beside the synchronous run's,
               latency of frames that overlapped a mapping step, frames per
               second with the final flush, back-pressure skips, map-wait
               time, catch-up batches and the worker's idle share. A second
               part splices four black frames into a 60-frame prefix: the
               in-flight frames are dropped and the loss ladder runs without
               an exception (re-acquisition is reported, not required);
  8. loop    - the scene of tests/test_loop_e2e.py at the bench's width
               (752x480, 1000 features, a 2.3 pi circle in 110 frames) with
               the reference's default configuration: loop closing and the
               global BA on. Part A, the synchronous control (MonoTracker,
               async_mapping=False), twice: a loop closed between keyframes
               that are a true revisit (ground-truth optical axes within
               30 degrees), a global BA applied, > 90 frames tracked, final
               state OK, scale-aligned ATE within the CPU bound, the second
               run bitwise equal to the first. Part B, the default mode
               through System (mapping worker, loop worker, background global
               BA): a loop closed on the loop thread, no thread error,
               > 80% of the frames exported in order, every binding live,
               at least 54 poses tracked while OK (the reference's fewest in
               three CPU runs, 69, less 15: in this mode both lose the map
               for 21-28 frames on this scene and export their RECENTLY_LOST
               predictions, ROADMAP R8), ATE of the tracked poses <= 2 x
               part A's + 0.02 m, that of every exported pose reported
               apart. Part C continues part B's
               System for 20 frames rendered at the ground-truth pose of
               frame 50 (the teleport of tests/test_reloc_e2e.py): tracking
               must be OK again within 10 frames, and the relocalized camera
               centre, Sim(3)-aligned by the tracked pre-teleport poses,
               within 0.3 m of frame 50's ground truth.
  9. stereo  - (in the second child process, before phase 17; its part A
               ATE is collected for the shell phase) first the fused
               describe kernel against its plain version
               (the kernel phase's gates) on this phase's pyramids: a
               stereo pair's two images and an RGB-D frame. Part A: the
               scene of tests/test_stereo_loop_e2e.py (a 0.2 m rig, bf =
               0.2 fx, th_depth = 0.2 x 40, a 2.3 pi circle in 110 frames)
               at the loop phase's 752x480 with 1000 features, the
               synchronous tracker with loop closing and the global BA on:
               initialized at frame 0, > 90 of 110 pairs tracked, a loop
               closed in SE(3) (fix_scale), a global BA applied, unscaled
               ATE within max(JAX, port on the CPU) + 10 mm and 0.25 m,
               |scale - 1| < 0.05; a second run gives the same trajectory
               bit for bit. Part B: tests/test_stereo.py's RGB-D sequence
               at 640x480 (20 frames, depth from the renderer): every frame
               tracked, unscaled ATE within its CPU bound, |scale - 1| <
               0.03. Part C: the default mode through System (mapping and
               loop workers) on part A's pairs: no thread error, > 80%
               exported in order, unscaled ATE of the poses tracked while OK
               <= 2 x part A's + 0.02 m; then one raw pair of the
               unrectified pinhole rig of tests/test_rectify.py at its
               752x480 through System's rectification: remap_bilinear on
               the card held against the CPU within 1e-4 of the gray range,
               the map initialized from the pair, its landmarks' depths
               against the rendered depth. orb_describe runs twice a stereo
               pair and once an RGB-D frame.
 10. merge   - (in the first child process, after phase 16) the
               multi-map Atlas on the scene of tests/test_atlas_merge.py
               at its 640x480 and 1000 features (a 2.5 pi circle in 120
               frames, frames 40-47 flat, loop closing on, RECENTLY_LOST
               cut to 0.15 s and the relocalization patience to 3 frames).
               First the fused describe kernel against its plain version on
               the scene's pyramid and on the flat frame. Part A, the
               synchronous tracker, twice: a second map spawned after the
               blind stretch, map 1 welded into map 0, one map and state OK
               at the end, > 80 poses exported and tracked while OK; the
               scale-aligned ATE of the poses tracked while OK at the weld
               (exported at the merge's frame) within max(JAX, port on the
               CPU) + 10 mm and 0.15 m; at the end within the largest end
               of the CPU runs under perturbation + 10 mm (the end spreads
               at the global BA after the loop, in the reference too:
               ROADMAP C2, see MERGE_END_MAX_ATE_M); the second run bitwise
               equal. Part B, the default mode through System (the merge
               parked for the track thread): no thread error, two maps seen,
               the exported poses in time order and, after a merge, in one
               map (the reference merged in none of three CPU runs of this
               mode, so no merge is required), the ATE of each map's poses
               tracked while OK within part A's end bound. Part C: part A's
               Atlas through checkpoint.save_atlas
               into a fresh synchronous System(load_atlas=...): every array
               bitwise, state LOST, then
               localization mode over frames 10-19: a pose comes back, no
               keyframe is added, the last pose within 0.05 m of part A's
               (tests/test_system.py's bars). One describe launch a frame.
 11. inertial - the inertial slice on tests/test_vi_tracking_e2e.py's scene
               (make_ring_scene(seed=5), a 2 m circle with 0.25 m of vertical
               bobbing, 10 fps, exact 200 Hz IMU rows, 1000 features, the
               test's shortened ladder). First the fused describe kernel
               against its plain version on the scene's pyramids. Part A:
               IMU_MONOCULAR at 752x480, synchronous, 70 frames: the IMU
               initialized (stages and their frames reported), state OK,
               > 50 tracked, |scale - 1| < 0.12, scale-aligned ATE within
               max(JAX, port on the CPU) + 10 mm and 0.10 m, the
               trajectory's plane normal |n_z| > 0.98 (a gravity-aligned
               world); a rerun of the first 30 frames (the IMU initializes at
               15) gives the same poses bit for bit. Part B: the default mode
               through System(settings, IMU_MONOCULAR), 45 frames (the ladder
               on the mapping worker at the reference's default schedule):
               the IMU initialized, no thread error, > 80% exported in order,
               |scale - 1| < 0.2, ATE of the poses tracked while OK <= 2 x
               part A's + 0.02 m. Part C: IMU_STEREO on the trajectory's first
               40 frames as pairs of the 0.2 m rig at 640x480 (the reference
               misses the scale bar at 752x480): initialized at frame 0, the
               IMU initialized, unscaled ATE within max(JAX, port on the CPU)
               + 10 mm, |scale - 1| < 0.05. Reports host ms a frame and per
               window VI BA and the preintegration's kernel launches a frame.
               orb_describe runs once a frame, twice a pair.
 12. entry   - the port's entry(): fused_track_step at the reference's
               shapes (640x480, L = 2048, 1000 features, inputs from
               default_rng(0)) on the card: finite R2, t2 and n_in, one
               describe launch a call counted on the card, and n_in equal and
               the pose within 1e-3 of the same fn on CPU inputs.
 13. shell   - the port's command-line drivers, in-process, on EuRoC-layout
               trees written to a temporary directory (PNG frames,
               imu0/data.csv, a File.version 1.0 settings file). Part A:
               mono_euroc on the bench ring's first 60 frames at 752x480
               (1000 features, 8 levels) in the default mode with --viewer
               and --live-viewer: the trajectory files written with more than
               80% of the frames in order, the scale-aligned ATE within
               max(JAX driver, port driver on the CPU, same tree) + 10 mm,
               one describe launch a frame, viewer_out/map.ply, map.html and
               a frame PNG written, and /state.json, fetched once mid-run,
               reporting the live map's keyframes and landmarks. Part B:
               stereo_euroc on the stereo phase's first 30 pairs and part C:
               mono_inertial_euroc on the inertial phase's first 45 frames
               with their 200 Hz IMU rows, both in the default mode and
               gated by the exported poses with the rules of the stereo
               phase's part C and the inertial phase's part B (2 describe
               launches a pair, 1 a frame).
 14. scale   - dryrun_multichip(2): two gloo ranks on the one card, each
               building the same tiny map and taking the sharded path of
               Tracker._global_ba, then a sharded FullInertialBA. Then loop
               A's final map (its keyframes, landmarks and observations
               printed) through its whole-map BA, and the inertial phase's
               map through its FullInertialBA in the sparse solver's
               capacities, each solved locally on the card and twice sharded
               over 2 gloo ranks on the card: every rank bitwise equal to
               every other, the two sharded runs bitwise equal, sharded vs
               local within tests/test_dist_ba.py's bars (t and R 2e-3, Xw
               5e-3; VI twb and Xw 5e-3), every solve lowering the cost; host
               ms and all-reduces a solve printed. With more than one card,
               NCCL with a card per rank too; with one, a line says it was
               skipped.
 15. drivers - (in a child process started after the build, beside phases
               3-14: the paths are host-bound and the host has cores to
               spare) first the fused describe kernel against its plain
               version on a 1241x376 KITTI pyramid with 2,000 features (two
               waves of blocks) and a 512x512 fisheye pyramid, the batched
               patch gather bit for bit on both pyramids (2,496 and 1,247
               slots, one launch each), and
               orb.compute_descriptors (one patch-gather launch) on the card
               against the CPU, bit for bit. Then the ten drivers the shell
               phase does not run, in-process in the default mode, each on a
               tree written in its dataset's own layout at the published
               width of its family's ORB-SLAM3 settings, cut in depth only:
               mono_kitti and stereo_kitti (sequences/00, 1241x376, 2,000
               features, 30 frames / pairs, bf 386.1448), mono_tum and
               rgbd_tum (rgb.txt / depth.txt, 16-bit depth, 640x480 with
               TUM1's intrinsics and distortion, 30 frames), rgbd_inertial
               (the TUM layout plus imu.csv, the inertial phase's scene and
               rows, 45 frames), mono_tumvi, stereo_tumvi,
               mono_inertial_tumvi and stereo_inertial_tumvi
               (dataset-room1_512_16/mav0, 512x512 KB8 frames warped from
               wide pinhole renders, TUM-VI's two cameras and extrinsics, 30
               frames / pairs, 45 for the inertial ones) and
               stereo_inertial_euroc (the inertial phase's 640x480 rig, 40
               pairs). Gates: the trajectory file in time order with > 80%
               of the frames, one describe launch a frame and two a pair, no
               thread error, the ATE of the poses tracked while OK
               (scale-aligned for mono, unscaled otherwise) within max(JAX
               driver, port driver on the CPU, same tree) + 10 mm, |scale -
               1| < 0.05 for stereo and RGB-D, the IMU initialized and
               |scale - 1| < 0.2 for the inertial drivers;
 16. long    - (the same child process) tests/test_long_sequence.py's 560
               noisy frames at 640x480 (800 features, two laps of a 2.5 m
               circle), synchronous with loop closing: state OK and > 88%
               tracked, a loop closed, < 0.45 keyframes a frame alive and
               landmarks under the cap, > 85% exported and a scale-aligned
               ATE < 0.12 m on the true camera centres (ROADMAP R20); it
               prints keyframes and landmarks against their caps, loops,
               landmarks removed, ms a frame (median, p99) and the describe
               launches (= frames); the covisibility route
               (native.backend()), keyframe culling by call, candidate and
               reason with the redundant fractions reached; and after each
               closed loop its Sim(3) scale, the scale-aligned ATE of the
               poses exported so far, the ground truth of its two frames
               (centre distance, angle of the optical axes) and, for each
               stage of its correction (window correction, fuse, essential
               graph, global BA), the keyframe ATE after it and its host ms
               (record_loop_stages; printed, not gated).
 17. inertial long - (a second child process, started with the first)
               the inertial phase's bobbing circle over two laps (360
               frames at 10 fps, the ring's seed 1) at EuRoC's 752x480 with
               1,000 features, the camera on EuRoC's rig IMU.T_b_c1
               (EUROC_T_B_C1; the IMU rows stay the body's), the
               reference's default ladder (VIBA2 at 15 s, ScaleRefinement
               windows from 25 s), loop closing and the global BA on. First
               the fused describe kernel against its plain version on the
               scene's first frame. Part A, the synchronous tracker over
               every frame: state OK, > 90% tracked, IMU stage 3 with VIBA2
               within one keyframe of the reference's CPU frame,
               ScaleRefinement called as often as in the reference's CPU
               run, at least one loop, each a true revisit, each essential
               graph in 4dof mode moving no keyframe's gravity direction in
               its body frame and no vertex scale by VIL_GRAVITY_TOL, each
               followed by the inertial global BA (FullInertialBA(7)),
               |scale - 1| < 0.12, |n_z| > 0.98, scale-aligned ATE within
               max(JAX, port on the CPU) + 10 mm, one describe launch a
               frame; it prints the frames and seconds of IMU init, VIBA1
               and VIBA2, each ScaleRefinement's scale and branch, each
               loop's keyframes, ground truth, graph mode and host ms of the
               graph and the global BA, ms a frame. Part B:
               mono_inertial_euroc in the default mode on an EuRoC tree of
               the first 220 frames whose settings carry IMU.T_b_c1: no
               thread error, > 80% exported in order, the highest IMU stage
               any map reached >= the reference driver's lowest in three
               CPU runs (2: in this mode both lose the map on this scene,
               the port before or after VIBA2 by thread timing), for each
               map with >= 10 poses tracked while OK |scale - 1| < 0.2 and
               its scale-aligned ATE <= 2 x part A's + 0.02 m, at least the
               reference driver's fewest loops in three CPU runs; it prints
               whether VIBA2 was reached, the losses and maps, the loops
               and the background inertial global BAs.
 18. inertial merge - (a third child process, started with the others) the
               inertial Atlas: the inertial long scene over three laps (540
               frames) with two flat stretches (VIM_BLIND), the user's loss
               settings (time_recently_lost 5 s, relocalization patience 12).
               First the fused describe kernel against its plain version on
               the scene's first frame and on a flat frame (5 slots on its
               coarsest level: angle 0, no bit). Part A, the synchronous
               tracker: the first stretch outlasts RECENTLY_LOST and the
               patience, so exactly one spawn keeps map 0 (stage 3, >= 10
               keyframes); the second comes before map 1's IMU init, so one
               reset keeps map 1's id with no keyframe and no database row;
               map 1 reaches VIBA2 within one keyframe of the reference's
               CPU frame counted from its own imu_t0; at least one merge,
               into map 0, each through exactly one merge_vi_ba span
               (`_merge_inertial_ba`) and no merge_eg, |sM - 1| < 1e-3; one
               map, state OK and stage 3 at the end; > 90% of the frames
               outside the stretches tracked; scale-aligned ATE of the
               poses tracked while OK at the weld (exported at the merge's
               frame) and at the end within max(JAX, port on the CPU) + 10
               mm; |scale - 1| < 0.12, |n_z| > 0.98; each later essential
               graph 4dof as in phase 17; one describe launch a frame. It
               prints the spawn, reset, VIBA2 and weld frames, host ms of
               the merge and of merge_vi_ba, the weld's tilt (RM e_z from
               e_z) beside the reference's, each later loop and the CUDA
               graph captures by frame. Part B: mono_inertial_euroc in the
               default mode on the same frames as an EuRoC tree: no thread
               error, the poses exported in order and at least the
               reference driver's fewest in three CPU runs less 15 (both
               lose this scene's maps in this mode, C6), >= 2 maps seen, at
               least the reference driver's fewest merges, each map's ATE
               of the poses tracked while OK <= 2 x part A's + 0.02 m.
 19. stereo inertial long - (the third child process, after phase 18)
               IMU_STEREO past its init: the inertial long scene's
               bobbing circle, clock and rig IMU.T_b_c1 as rectified pairs on
               the settings of ORB-SLAM3's rectified EuRoC stereo-inertial
               yaml (752x480, 1,200 features, bf = 0.110078 fx, ThDepth 35
               baselines = 3.85 m) on a room-sized ring (SIL_RING: about
               half the points a frame sees within ThDepth), the reference's
               default ladder (IMU init at 1 s with 10 keyframes, fixed
               scale; VIBA1 at 5 s; VIBA2 at 15 s), loop closing and the
               global BA on. First the fused describe kernel against its
               plain version on both images of the first pair. Part A, the
               synchronous tracker over all 360 pairs: state OK, > 90%
               tracked, one IMU init with fix_scale and scale exactly 1,
               stage 3 with VIBA2 within one keyframe of the reference's CPU
               frame, ScaleRefinement never called, at least one loop, each a
               true revisit, each 4dof graph moving no body gravity
               direction and no vertex scale by VIL_GRAVITY_TOL, each
               followed by one FullInertialBA(7) over stereo rows, unscaled
               ATE within max(JAX, port on the CPU) + 10 mm, |scale - 1| <
               0.05, |n_z| > 0.98, two describe launches a pair; it prints
               the frames and seconds of IMU init, VIBA1 and VIBA2 with each
               whole-chain solve's route (dense or sparse), keyframes and
               stereo-row share, each loop's keyframes, mode, revisit angle
               and host ms of the graph and of FullInertialBA(7), ms a pair.
               Part B: stereo_inertial_euroc in the default mode on an EuRoC
               tree of the first SIL_DRIVER_PAIRS pairs (File.version 1.0
               settings with 1,200 features, Camera.bf, Stereo.ThDepth 35 and
               IMU.T_b_c1): no thread error, > 80% exported in order, the
               highest IMU stage any map reached >= the reference driver's
               lowest in three CPU runs, for each map with >= 10 poses
               tracked while OK |scale - 1| < 0.05 and unscaled ATE <= 2 x
               part A's + 0.02 m, at least the reference driver's fewest
               loops; it prints the losses, maps, loops and each background
               inertial global BA with its stereo-row count.
`--profile N` adds a torch.profiler pass over N frames (kernel launches and
device time per frame, host time per stage) and over the SLAM phase's
tracked frames and mapping steps, `--compare-routes` a timing of the tracker
with the describe stage by either route; both are off by default.
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
# SLAM phase. Scale-aligned ATE RMSE (m) over the 120 frames on a CPU: the
# larger of the JAX reference's MonoTracker (synchronous, no loop closing:
# 0.023831216539063824) and this port's (0.02424541729702135); the card must
# not be worse than that plus TOL_SLAM_ATE_M. How both were measured: PERF.md.
SLAM_ATE_M = 0.02424541729702135
TOL_SLAM_ATE_M = 0.010
SLAM_INIT_BY = 40  # the map must exist after this many frames
SLAM_MIN_KFS = 8
SLAM_MIN_LMS = 1000
SLAM_PROFILE_FRAMES = 40  # frames of the SLAM phase that --profile traces
# Async phase. The asynchronous run sees another map snapshot per frame than
# the synchronous one (thread timing decides which), so its ATE is held
# against the synchronous run of the same process, not against a constant.
ASYNC_ATE_FACTOR = 2.0
ASYNC_ATE_SLACK_M = 0.020
ASYNC_MIN_PIPELINED = 20
ASYNC_MIN_COVERAGE = 0.8
# Loop phase. Scale-aligned ATE RMSE (m) of part A's run on a CPU (the JAX
# reference and the port, sync, loop closing and global BA on; measured by
# `pytest -m slow tests/test_torch_loop_e2e.py -k against`); part A must not
# be worse than the larger plus TOL_LOOP_ATE_M.
LOOP_JAX_ATE_M = 0.051330064561660935
LOOP_PORT_ATE_M = 0.09380418233244502
TOL_LOOP_ATE_M = 0.010
LOOP_FRAMES = 110
LOOP_MIN_TRACKED = 90
# Part B: in the default mode both the JAX reference and the port lose the
# map where the camera first enters unmapped ground after a fast turn (frames
# ~58-67) and regain it at the revisit of frame 0 (~91); the poses between are
# dead-reckoned (ROADMAP R8). Tracked poses of three reference runs at once on
# a CPU: 73, 70, 69; the port's: 66, 70, 66 (`pytest -m slow -s
# tests/test_torch_loop_e2e.py -k loses_no_more`). Part B must track at least
# the reference's fewest less the margin: thread timing decides the frame of
# the loss, and the card's threads run at another pace than the CPU's.
LOOP_ASYNC_REF_TRACKED = 69
LOOP_ASYNC_TRACKED_MARGIN = 15
LOOP_REVISIT_DEG = 30.0  # ground-truth optical axes of a true revisit
TELEPORT_TO = 50  # part C renders this frame's ground-truth pose
TELEPORT_FRAMES = 20
RELOC_WITHIN = 10
RELOC_TOL_M = 0.3
LADDER_FRAMES = 60  # prefix of the ring used by the blackout part
LADDER_BLACK = (45, 49)  # frames replaced by black images
# The stereo phase: the scene of tests/test_stereo_loop_e2e.py (0.2 m rig,
# a 2.3 pi circle in 110 frames) at the loop phase's 752x480 and 1000
# features, synchronous and in the default mode; tests/test_stereo.py's
# RGB-D sequence at 640x480.
STEREO_FRAMES = 110
STEREO_WIDTH, STEREO_HEIGHT = 752, 480
STEREO_TURNS = 2.3  # the circle's angle in units of pi
STEREO_BASELINE = 0.2
STEREO_MIN_TRACKED = 90
STEREO_MAX_ATE_M = 0.25  # the unscaled bar of tests/test_stereo_loop_e2e.py
STEREO_SCALE_TOL = 0.05
RGBD_FRAMES = 20
RGBD_SCALE_TOL = 0.03
REMAP_TOL = 1e-4  # of the gray range, card vs CPU
# The rectified pair's landmark depths against the rendered depth: a wrong
# baseline or rotation biases them, misaligned rows scatter them. The
# spread is the row-band matcher's on these blobs at this rig's 0.11 m
# baseline (0.0548 on the CPU and on the card, PERF.md).
REMAP_DEPTH_BIAS = 0.02
REMAP_DEPTH_SPREAD = 0.10
# Unscaled ATE RMSE (m) of the synchronous runs on a CPU (PERF.md; pytest
# -m slow -s tests/test_torch_stereo_tracker.py -k full_width).
STEREO_JAX_ATE_M = 0.042988
STEREO_PORT_ATE_M = 0.044783
RGBD_JAX_ATE_M = 0.005728
RGBD_PORT_ATE_M = 0.005598
# The merge phase: the scene of tests/test_atlas_merge.py at its 640x480 and
# 1000 features (make_ring_scene(seed=11, n_points=900, size_range=(9, 15)),
# a 2.5 pi circle in 120 frames 0.05 s apart, frames 40-47 flat at 35.0),
# loop closing on, time_recently_lost 0.15 s and reloc_patience 3, so that
# the blind stretch falls through to LOST and spawns a second Atlas map.
MERGE_FRAMES = 120
MERGE_BLIND = (40, 48)
MERGE_FLAT = 35.0
MERGE_RECENTLY_LOST_S = 0.15
MERGE_RELOC_PATIENCE = 3
MERGE_MIN_POSES = 80
MERGE_MAX_ATE_M = 0.15  # the bar of tests/test_atlas_merge.py
# Scale-aligned ATE RMSE (m) of the synchronous run on a CPU over every
# exported pose at the end (`pytest -m slow -s tests/test_torch_merge_e2e.py
# -k full_width`, PERF.md): reported beside part A's.
MERGE_JAX_ATE_M = 0.07760437872034853
MERGE_PORT_ATE_M = 0.10939217267770134
# Part A's gates. The weld is held to the CPU runs: the scale-aligned ATE of
# the poses tracked while OK, exported at the frame whose loop step merged
# (reference 0.062163 m, port 0.056912 m, both at frame 103; `-k
# full_width`), within the larger + TOL_LOOP_ATE_M and MERGE_MAX_ATE_M. The
# end, after the loop that follows and its global BA, spreads: under
# rounding-sized noise and other RANSAC draws the CPU runs end at
# 0.056-0.097 m (reference) and 0.056-0.253 m (port; `-k end_spread`), and
# from the state of the port's 0.253 m run before its loop keyframe the
# reference ends over tests/test_atlas_merge.py's 0.15 m bar too (`-k
# as_far_off`; ROADMAP C2, classified). So the end is held to the largest end
# measured + TOL_LOOP_ATE_M, and so is part B's.
MERGE_JAX_WELD_ATE_M = 0.06216332984328071
MERGE_PORT_WELD_ATE_M = 0.056911781420670035
MERGE_SPREAD_END_M = 0.2526909968933796
MERGE_END_MAX_ATE_M = MERGE_SPREAD_END_M + TOL_LOOP_ATE_M
# Part B: in the default mode the reference merged in none of three CPU runs
# (each kept three maps: a second loss spawned a third; `-k default_mode`),
# so part B requires no merge, as loop B's tracked-pose count follows the
# reference's fewest (PERF.md); its ATE is taken per map, at the end, within
# MERGE_END_MAX_ATE_M.
MERGE_ASYNC_REF_MERGES = 0
# Part C: the checkpoint's relocalization bars (tests/test_system.py).
CKPT_FRAMES = (10, 20)
CKPT_TOL_M = 0.05
# Inertial phase: tests/test_vi_tracking_e2e.py's trajectory and ladder.
VI_FRAMES = 70
# Depth cuts of the inertial phase (PERF.md section 4): part A's bitwise
# rerun covers the first frames (the IMU initializes at frame 15), part B
# the frames its default ladder needs, part C the first frames of the
# trajectory.
VI_RERUN_FRAMES = 30
VI_ASYNC_FRAMES = 45
VI_STEREO_FRAMES = 40
VI_FPS = 10.0
VI_IMU_HZ = 200.0
VI_RADIUS, VI_OMEGA, VI_BOB_A, VI_BOB_W = 2.0, 0.35, 0.25, 3.0
VI_LADDER = dict(imu_init_min_kfs=6, imu_init_time=0.6, viba1_time=3.0, viba2_time=1e9, imu_kf_period=0.3)
VI_MONO_SIZE = (752, 480)
# Part C at the test's own 640x480: at 752x480 the reference's own
# stereo-inertial run misses the stereo scale bar (scale 0.9411, CPU).
VI_STEREO_SIZE = (640, 480)
VI_MIN_TRACKED = 50  # of 70
VI_SCALE_TOL = 0.12
VI_MAX_ATE_M = 0.10  # scale-aligned, the bar of tests/test_vi_tracking_e2e.py
VI_GRAVITY_NZ = 0.98
VI_ASYNC_SCALE_TOL = 0.2
# CPU runs of the same inputs, synchronous (pytest -m slow -s
# tests/test_torch_vi_e2e.py -k full_width): part A's scale-aligned ATE,
# part C's unscaled ATE.
VI_JAX_ATE_M = 0.08602397722054414
VI_PORT_ATE_M = 0.07992365339961789
VI_STEREO_JAX_ATE_M = 0.0363071075563861
VI_STEREO_PORT_ATE_M = 0.03667004520882259
# Inertial long phase: the inertial phase's scene over two laps (36 s at
# VI_FPS), EuRoC's published width and feature budget
# (Examples/Monocular-Inertial/EuRoC.yaml), its camera rig IMU.T_b_c1 (cam0's
# T_BS in EuRoC's sensor.yaml: body from camera, row-major), the reference's
# default ladder (VIBA2 at 15 s, ScaleRefinement from 25 s), loop closing
# and the global BA on.
EUROC_T_B_C1 = ((0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975),
                (0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768),
                (-0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949),
                (0.0, 0.0, 0.0, 1.0))
VIL_FRAMES = 360
# The ring's seed: with test_vi_tracking_e2e.py's seed 5 on EuRoC's rig the
# reference loses frame 34 at 752x480 at its 30-inlier floor (ROADMAP R22)
# and never reaches VIBA2; seed 1 is the first it tracks through two laps.
VIL_SEED = 1
VIL_SIZE = (752, 480)
VIL_FEATURES = 1000
VIL_MIN_TRACKED = 0.90
VIL_GRAVITY_TOL = 1e-5  # body gravity direction and vertex scales across a 4DoF essential graph
# Part B: frames of the default-mode driver run, cut to the first revisit
# after VIBA2 (frame ~186 in part A; VIBA2 at 150).
VIL_DRIVER_FRAMES = 220
VIL_DRIVER_SCALE_TOL = 0.2
# CPU runs of part A's inputs, synchronous (pytest -m slow -s
# tests/test_torch_inertial_long_e2e.py -k full_width): the reference's and
# the port's scale-aligned ATE, the reference's VIBA2 frame and its
# ScaleRefinement calls; and the reference driver's fewest loops over three
# CPU runs of part B's tree in the default mode (-k driver).
VIL_JAX_ATE_M = 0.05378950508379987
VIL_PORT_ATE_M = 0.05505485166948986
VIL_JAX_VIBA2_FRAME = 150
VIL_JAX_REFINEMENTS = 2
# In the default mode on the CPU the reference's driver loses its map 10
# frames after VIBA1 in all three runs: its highest IMU stage is 2 (VIBA1)
# and it closes no loop by frame 220.
VIL_JAX_DRIVER_STAGE = 2
VIL_JAX_DRIVER_LOOPS = 0
# Inertial merge phase (phase 18): the inertial long scene over three laps
# (the circle's period is 17.95 s) with two flat stretches. The first starts
# ten frames after map 0's VIBA2 (frame 150) and outlasts RECENTLY_LOST's
# 5 s of IMU dead reckoning and the 12 LOST frames of relocalization
# patience, so map 0 (stage 3, 43 keyframes) is kept and map 1 spawned; the
# second starts when map 1 holds 4 keyframes (before its IMU init, which
# needs 10), so map 1 is lost at once and reset after the patience. The
# reset map then runs its own ladder to VIBA2 (15 s past its first
# keyframe) and its first revisit of lap 1's ground welds it into map 0.
# The user's loss settings: time_recently_lost 5 s, reloc_patience 12.
VIM_FRAMES = 540
VIM_BLIND = ((160, 230), (239, 257))
VIM_FLAT = MERGE_FLAT
VIM_MIN_TRACKED = 0.90  # of the frames outside the blind stretches
VIM_KEEP_MIN_KFS = 10  # the reset branch takes a map of fewer keyframes
VIM_WELD_SCALE_TOL = 1e-3  # |sM - 1|: IMU_MONOCULAR solves its welds with a fixed scale
# CPU runs of part A's inputs, synchronous (pytest -m slow -s
# tests/test_torch_inertial_merge_e2e.py -k full_width; the reference with
# ROADMAP R13's repair, see there): the reference's and the port's
# scale-aligned ATE of the poses tracked while OK in a live map (`vim_ate`)
# at the weld and at the end, the reference's map 1 VIBA2 frames after its
# first keyframe (imu_t0) and its weld's tilt; and the reference driver's
# fewest merges and poses exported over three CPU runs of part B's tree in
# the default mode (-k driver).
VIM_JAX_WELD_ATE_M = 0.0838204704223855
VIM_PORT_WELD_ATE_M = 0.06796170536298615
VIM_JAX_ATE_M = 0.08399397873483642
VIM_PORT_ATE_M = 0.06018427575245026
VIM_JAX_VIBA2_AFTER_T0 = 151
VIM_JAX_TILT_DEG = 0.18861181407083163
VIM_JAX_DRIVER_MERGES = 0
# In this mode both implementations lose this scene's maps more than once
# (ROADMAP C6) and R13 loses the reference's reset maps again and again, so
# part B's exported poses are gated at the reference driver's fewest in
# three CPU runs less the loop phase's margin for thread timing, not at
# 80% of the frames.
VIM_JAX_DRIVER_EXPORTED = 319
# Stereo inertial long phase (phase 19): the inertial long scene's
# trajectory, clock and rig as rectified pairs on the published settings of
# ORB-SLAM3's rectified EuRoC stereo(-inertial) yaml
# (Examples/Stereo-Inertial/EuRoC.yaml before v1.0): 752x480,
# ORBextractor.nFeatures 1,200, Camera.bf 47.9064 at fx 435.2047 (a
# baseline of 0.110078 m), ThDepth 35 (baselines), IMU.T_b_c1 = cam0's;
# the reference's default ladder, loop closing and the global BA on. The
# ring is resized to a room around the 2 m circle (depths ~1.5-6 m) so that
# about half the points a frame sees lie within th_depth = 3.85 m (the
# default ring's 8-14 m puts every point beyond it, PERF.md section 4);
# its points are raised to 4,000 to keep the default ring's ~420 in view.
SIL_FRAMES = 360
SIL_SIZE = (752, 480)
SIL_FEATURES = 1200
SIL_BASELINE = 0.110078
SIL_TH_DEPTH = 35.0
SIL_SEED = VIL_SEED
SIL_RING = dict(r_inner=3.5, r_outer=8.0, half_height=2.5, n_points=4000)
# Part B: pairs of the default-mode driver run, cut for the smoke's time
# (a run with all 220 took 985.4 s on the card's host): the reference
# driver reaches neither VIBA2 nor a revisit in 220 pairs, and the first
# 150 hold VIBA1 (pair 51-56), the loss at 66-67, LOST at 116-117 and the
# spawned map's first pairs.
SIL_DRIVER_PAIRS = 150
# CPU runs of part A's inputs, synchronous (pytest -m slow -s
# tests/test_torch_stereo_inertial_long_e2e.py -k full_width): the
# reference's and the port's unscaled ATE and the reference's VIBA2 frame;
# and the reference driver's lowest highest-IMU-stage and fewest loops over
# three CPU runs of part B's tree in the default mode (-k driver).
SIL_JAX_ATE_M = 0.011955848932748026
SIL_PORT_ATE_M = 0.0075287261807108815
SIL_JAX_VIBA2_FRAME = 151
# In the default mode on the CPU the reference's driver (three runs of 220
# pairs) loses its map at pair 66-67, 15 pairs after VIBA1, in all three
# runs (ROADMAP C6), and the map it spawns reaches VIBA1 again: its highest
# IMU stage is 2 and it closes no loop.
SIL_JAX_DRIVER_STAGE = 2
SIL_JAX_DRIVER_LOOPS = 0
# Entry phase: the card's (R2, t2) against the same fn on CPU inputs.
ENTRY_TOL = 1e-3
# Shell phase: the drivers run in-process on EuRoC-layout trees written here.
SHELL_FRAMES = 60  # of the bench ring, 752x480, 1000 features, 8 levels
SHELL_STEREO_PAIRS = 30  # of the stereo phase's rig
SHELL_VI_FRAMES = 45  # of the inertial phase's scene
SHELL_STATE_AT = 30  # the live viewer's state is fetched once, at or after this frame
# Scale-aligned ATE (m) of the mono driver in the default mode on the same
# tree on a CPU: the reference's examples/mono_euroc.py and the port's
# driver (pytest -m slow -s tests/test_torch_drivers.py -k full_width).
SHELL_JAX_ATE_M = 0.013079752449215278
SHELL_PORT_ATE_M = 0.016065074099849305
# Drivers phase: the ten drivers the shell phase does not run, each on a
# tree written in its dataset's own layout at the published width of its
# family's ORB-SLAM3 settings (Examples/<dir>/<file>.yaml, named below),
# rendered from make_ring_scene views and cut in depth only.
KITTI_SIZE = (1241, 376)  # KITTI00-02.yaml
KITTI_K = (718.856, 718.856, 607.1928, 185.2157)
KITTI_BF = 386.1448
KITTI_TH_DEPTH = 35.0
KITTI_FEATURES = 2000
KITTI_FPS = 10.0
TUM_SIZE = (640, 480)  # TUM1.yaml
TUM_K = (517.306408, 516.469215, 318.643040, 255.313989)
TUM_DIST = (0.262383, -0.953104, -0.005358, 0.002628, 1.163314)
TUM_BF = 40.0
TUM_TH_DEPTH = 40.0
TUM_FEATURES = 1000
TUM_FPS = 30.0
TUM_DEPTH_FACTOR = 5000.0  # the 16-bit PNGs; datasets/tum.py reads meters (ROADMAP R18)
TUMVI_SIZE = 512  # tumvi.default_cameras(), the YAML schema of tests/test_fisheye_stereo.py
TUMVI_FEATURES = {"mono_tumvi": 1500, "mono_inertial_tumvi": 1500, "stereo_tumvi": 1000,
                  "stereo_inertial_tumvi": 1000}  # Monocular[-Inertial]/TUM-VI.yaml, Stereo[-Inertial]/TUM-VI.yaml
TUMVI_FPS = 20.0
FISHEYE_THETA_MAX = 75.0  # degrees off axis covered by the pinhole render warped through KB8
FISHEYE_BACKGROUND = 35.0  # render_frame's background level, outside that cone
DRIVER_NAMES = ("mono_kitti", "stereo_kitti", "mono_tum", "rgbd_tum", "rgbd_inertial", "mono_tumvi", "stereo_tumvi",
                "mono_inertial_tumvi", "stereo_inertial_tumvi", "stereo_inertial_euroc")
DRIVER_FRAMES = 30
DRIVER_VI_FRAMES = 45
DRIVER_SI_EUROC_PAIRS = 40
DRIVER_SCALE_TOL = 0.05  # stereo and RGB-D: metric
DRIVER_VI_SCALE_TOL = 0.2  # inertial: the shell phase's part C rule
# ATE (m; scale-aligned for the mono drivers, unscaled otherwise) of the
# reference's driver and the port's on the same tree, both in the default
# mode on a CPU (pytest -m slow -s tests/test_torch_drivers.py -k
# full_width_driver); each driver's bound is the larger + TOL_LOOP_ATE_M.
DRIVER_ATE_M = {
    "mono_kitti": (0.009814794613471033, 0.009291113685527522),
    "stereo_kitti": (0.004788281932521995, 0.004443431890200967),
    "mono_tum": (0.018542492508828765, 0.011589099733977114),
    "rgbd_tum": (0.004176940181367123, 0.004448608480844039),
    "rgbd_inertial": (0.016183681157379053, 0.017451301980072192),
    "mono_tumvi": (0.00437407327305074, 0.0046102076885494855),
    "stereo_tumvi": (0.005268907773982416, 0.0050404673386093),
    "mono_inertial_tumvi": (0.06986172962174882, 0.06087465666650617),
    "stereo_inertial_tumvi": (0.016036685637999155, 0.024414271461683297),
    "stereo_inertial_euroc": (0.025156744558025704, 0.025306137598722106),
}  # (reference, port)
# Long phase: tests/test_long_sequence.py's 560 noisy frames at 640x480
# (800 features, two laps of a 2.5 m circle, synchronous, loop closing on).
LONG_FRAMES = 560
LONG_TURNS = 4.3  # in units of pi
LONG_FEATURES = 800
LONG_MIN_TRACKED = 0.88
LONG_MIN_EXPORTED = 0.85
LONG_MAX_KF_FRAC = 0.45
LONG_MAX_ATE_M = 0.12
# Scale phase: tests/test_dist_ba.py's bars, sharded against local.
SCALE_TOL_POSE = 2e-3  # t (m) and R (rad)
SCALE_TOL_LM = 5e-3  # Xw (m); VI twb too
SCALE_RANKS = 2
# The drivers and long phases' process must have ended by then (s after the
# smoke's start), inside the contract's 1,200 s.
PARALLEL_DEADLINE_S = 1100.0
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
    frames = [synthetic.to_u8(f) for f in synthetic.render_sequence(scene, Rs[:n_frames], ts[:n_frames])]
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


def device_us(e):
    """A profiler event's own device time (us), under either attribute name."""
    return getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)


def profiled(fns, calls=30):
    """{key: (device us a launch, launches a round)} of the kernels whose
    names hold each key, by one torch.profiler session over `calls` rounds
    of calling every fn of `fns` ({key: fn}) once each."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            for fn in fns.values():
                fn()
        torch.cuda.synchronize()
    out = {}
    for key in fns:
        evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and key in e.key]
        n = sum(e.count for e in evs)
        out[key] = (sum(device_us(e) for e in evs) / max(n, 1), n / calls)
    return out


def hold_gather(name, levels, blurred, xys):
    """One batched gather launch over `levels` against the plain version,
    bit for bit, and the host and card counts of that launch. Returns the
    largest absolute difference (0.0 when equal)."""
    import torch

    from orbslam3_cpp_fork_tpu_torch.ops import patches

    counter = patches.gather_counter(levels[0].device)
    torch.cuda.synchronize()
    counter.zero_()
    n0 = patches.launches
    got = patches.extract_patches_levels(levels, blurred, xys)
    torch.cuda.synchronize()
    host, card = patches.launches - n0, int(counter)
    ref = torch.stack([torch.cat([patches._gather_plain(im, xy) for im, xy in zip(imgs, xys)])
                       for imgs in (levels, blurred)])
    err = float((got - ref).abs().max()) if ref.numel() else 0.0
    log(f"kernel: patch_gather on {name}: {ref.shape[1]} slots over {len(levels)} levels "
        f"({[int(xy.shape[0]) for xy in xys]}), launches {host} by the wrapper, {card} on the card; bitwise equal to "
        f"the plain version: {torch.equal(got, ref)} (max abs err {err})")
    if got.shape != ref.shape or not torch.equal(got, ref):
        fail(f"patch_gather differs from the plain version on {name}: max abs err {err}")
    if host != 1 or card != 1:
        fail(f"patch_gather on {name}: {host} launches by the wrapper, {card} on the card (1 expected)")
    return err


def phase_kernel_gather(dev, inputs):
    """Patch gather vs plain: all 8 levels of the main path's frame in one
    launch, edge cases (border keypoints, N = 1, 127, 129, an empty level),
    the one-level entry points; then its time, the plain version's and its
    device time by the profiler, per frame."""
    import torch

    from orbslam3_cpp_fork_tpu_torch.ops import patches

    levels, blurred, xys, _ = inputs
    max_err = hold_gather("the frame's 8 levels", levels, blurred, xys)
    h, w = levels[0].shape
    border = torch.tensor(
        [[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1], [w // 2, 0], [w // 2, h - 1],
         [0, h // 2], [w - 1, h // 2], [-5, -7], [w + 3, h + 9], [5, 3], [w - 4, h - 2]],
        dtype=torch.int32,
    ).to(dev)
    g = torch.Generator().manual_seed(0)

    def random_xy(n, hw):
        return torch.stack([torch.randint(-20, hw[1] + 20, (n,), generator=g),
                            torch.randint(-20, hw[0] + 20, (n,), generator=g)], 1).to(torch.int32).to(dev)

    none = torch.zeros((0, 2), dtype=torch.int32, device=dev)
    for n in (1, 127, 129):
        # Level 1 has no keypoints, level 7 has n: the slot-to-level search
        # must skip the empty level and reach the last one.
        kp = [random_xy(n, levels[0].shape), none] + [random_xy(7, lv.shape) for lv in levels[2:7]] + [
            random_xy(n, levels[7].shape)]
        max_err = max(max_err, hold_gather(f"n{n} with an empty level", levels, blurred, kp))
    max_err = max(max_err, hold_gather("border keypoints", levels[:1], blurred[:1], [border]))
    # The one-level entry points launch the same kernel.
    n0 = patches.launches
    pa, pb = patches.extract_patches_dual(levels[0], blurred[0], border)
    p1 = patches.extract_patches(blurred[3], xys[3])
    torch.cuda.synchronize()
    if not (torch.equal(pa, patches._gather_plain(levels[0], border))
            and torch.equal(pb, patches._gather_plain(blurred[0], border))
            and torch.equal(p1, patches._gather_plain(blurred[3], xys[3])) and patches.launches - n0 == 2):
        fail("extract_patches_dual / extract_patches differ from the plain version or did not launch once each")
    log("kernel: extract_patches_dual and extract_patches: one launch each, bitwise equal to the plain version")

    def plain():
        return [torch.cat([patches._gather_plain(im, xy) for im, xy in zip(imgs, xys)]) for imgs in (levels, blurred)]

    ms = cuda_ms(lambda: patches.extract_patches_levels(levels, blurred, xys))
    plain_ms = cuda_ms(plain)
    m = sum(int(xy.shape[0]) for xy in xys)
    n_bytes = sum(2 * 4 * lvl.numel() for lvl in levels) + 8 * m + 2 * m * 1600 * 4
    bound_ms = n_bytes / HBM_BYTES_PER_S * 1e3  # a copy: no arithmetic
    log(f"kernel: patch_gather per frame ({m} slots, 8 levels, 1 launch): kernel with its wrapper {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms")
    log(f"kernel: patch_gather bound: {n_bytes} bytes (each level and blurred level read once, {m} x 2 patches "
        f"written) / {HBM_BYTES_PER_S:.3g} B/s = {bound_ms:.6f} ms per frame; with its wrapper at "
        f"{bound_ms / ms:.2%} of it")
    # The pyramids were just written and fit in the 50 MB L2: read from
    # there, only the keypoints and the patches cross HBM.
    l2_bound_ms = (8 * m + 2 * m * 1600 * 4) / HBM_BYTES_PER_S * 1e3
    return dict(max_abs_err=max_err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by="bytes",
                l2_bound_ms=l2_bound_ms)


def phase_kernel_profile(dev, inputs, gather, describe):
    """Device time of both kernels on the main path's frame, by one
    torch.profiler session, beside their bounds; stored as `device_us` in
    the kernel phases' results."""
    from orbslam3_cpp_fork_tpu_torch.ops import patches

    levels, blurred, xys, _ = inputs
    t = profiled({"patch_gather": lambda: patches.extract_patches_levels(levels, blurred, xys),
                  "orb_describe": lambda: patches.describe_keypoints(levels, blurred, xys)})
    for name, res in (("patch_gather", gather), ("orb_describe", describe)):
        us, per_call = t[name]
        res["device_us"] = us
        log(f"kernel: {name} device time (profiler) {us:.3f} us a launch, {per_call:.2f} launches a call; at "
            f"{res['bound_ms'] * 1e3 / us:.2%} of its bound ({res['bound_ms'] * 1e3:.3f} us)"
            + (f", at {res['l2_bound_ms'] * 1e3 / us:.2%} of the bound with the pyramids resident in L2 "
               f"({res['l2_bound_ms'] * 1e3:.3f} us: keypoints read, patches written)" if "l2_bound_ms" in res else ""))


def hold_describe(name, lv, bl, kp, gate, flat_tail=False):
    """One fused describe launch against the plain version on the same
    levels and keypoints: angle within TOL_ANGLE on the gated slots (valid
    keypoints whose moment is not ill-conditioned), bits exact wherever both
    bins agree, at most 1% of gated slots in another bin; with `flat_tail`
    the last 5 slots lie on a flat level. Returns the angle error."""
    import torch

    from orbslam3_cpp_fork_tpu_torch.ops import patches

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
    if flat_tail and (got[0][-5:].any() or got[1][-5:].any() or got[2][-5:].any()):
        fail(f"orb_describe on {name}: a flat window must give angle 0 and no set bit")
    if err > TOL_ANGLE:
        fail(f"orb_describe angle differs from the plain version on {name}: {err} rad > {TOL_ANGLE}")
    if bad_bits:
        fail(f"orb_describe on {name}: {bad_bits} bits differ where both bins agree")
    if bins_gated > 0.01 * max(int(gate.sum()), 100):
        fail(f"orb_describe on {name}: {bins_gated} gated slots in another bin than the plain version")
    return err


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

    worst = max(hold_describe(name, lv, bl, kp, gate, flat_tail=name != "frame") for name, lv, bl, kp, gate in cases)

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
        f"{t['fused']}; plain {plain_ms:.4f} ms; per-level route (1 gather launch + PyTorch ops) "
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
    """The describe stage by the earlier route on the first frames: one
    patch-gather launch a frame for all 8 levels, then PyTorch ops; held
    against the fused kernel on the same inputs. Returns (launches, device
    us of the gather kernel a frame by the profiler)."""
    import torch

    from orbslam3_cpp_fork_tpu_torch.ops import patches

    inputs = [frame_levels(dev, f, orb_params) for f in frames]
    counter = patches.gather_counter(dev)
    torch.cuda.synchronize()
    counter.zero_()
    patches.launches = 0
    outs = [patches.describe_keypoints_per_level(lv, bl, kp) for lv, bl, kp, _ in inputs]
    torch.cuda.synchronize()
    launches, card = patches.launches, int(counter)
    worst, bins_all, slots = 0.0, 0, 0
    for (lv, bl, kp, valid), got in zip(inputs, outs):
        fused = patches.describe_keypoints(lv, bl, kp)
        norm = moment_norm(lv, kp)
        err, bins, bins_gated, bad_bits, n = describe_diff(fused, got, valid & ((norm >= MIN_MOMENT) | (norm == 0)))
        if err > TOL_ANGLE or bad_bits or bins_gated > 0.01 * n:
            fail(f"per-level route and fused kernel disagree: angle {err} rad, {bad_bits} bits on equal bins, "
                 f"{bins_gated} gated slots in another bin")
        worst, bins_all, slots = max(worst, err), bins_all + bins, slots + n

    def all_frames():
        for lv, bl, kp, _ in inputs:
            patches.describe_keypoints_per_level(lv, bl, kp)

    # The 12 frames' pyramids (~107 MB) do not all stay in L2.
    gather_us, per_call = profiled({"patch_gather": all_frames}, calls=1)["patch_gather"]
    log(f"per-level path: {len(frames)} frames, patch_gather launches {launches} by the wrapper, {card} on the card "
        f"(= {len(frames)} required); vs fused kernel: max angle err {worst:.3e} rad, differing bins {bins_all} of "
        f"{slots} slots, 0 differing bits on equal bins; gather device time (profiler) {gather_us:.3f} us a launch "
        f"(one a frame; {per_call:.0f} launches profiled)")
    if launches != len(frames) or card != len(frames):
        fail(f"patch_gather launched {launches} times by the wrapper, {card} on the card, for {len(frames)} frames")
    return launches, gather_us


def make_slam_tracker(dev, scene, orb_params):
    from orbslam3_cpp_fork_tpu_torch import convert
    from orbslam3_cpp_fork_tpu_torch.runtime.tracker import MonoTracker, TrackerConfig

    K = scene.K
    cfg = TrackerConfig(
        camera=convert.camera_from_numpy(K[0, 0], K[1, 1], K[0, 2], K[1, 2]),
        width=scene.width, height=scene.height, orb=orb_params,
        async_mapping=False, enable_loop_closing=False,
    )
    return MonoTracker(cfg, dev)


def run_slam(dev, scene, frames, orb_params):
    """One cold-start run of MonoTracker over `frames` on the card. Returns
    the tracker, per-frame records and the describe-launch counts."""
    import torch

    from orbslam3_cpp_fork_tpu_torch import device as device_mod
    from orbslam3_cpp_fork_tpu_torch.ops import patches

    trk = make_slam_tracker(dev, scene, orb_params)
    counter = patches.describe_counter(dev)
    counter.zero_()
    patches.describe_launches = 0
    rec = []
    for i, f in enumerate(frames):
        kfs0, fetch0 = trk.n_kf_inserted, device_mod.n_fetches
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                T = trk.track(f, i * 0.05)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        rec.append(dict(
            ms=(time.perf_counter() - t1) * 1e3, ok=T is not None, state=trk.state.name,
            kf=trk.n_kf_inserted > kfs0 and kfs0 > 0, fetches=device_mod.n_fetches - fetch0,
            syncs=sum("called a synchronizing" in str(w.message) for w in caught),
        ))
    return trk, rec, int(counter), patches.describe_launches


def phase_slam(dev, scene, ts, frames, orb_params, gate_ate):
    import numpy as np

    from orbslam3_cpp_fork_tpu_torch import native
    from orbslam3_cpp_fork_tpu_torch.runtime.tracker import TrackState
    from orbslam3_cpp_fork_tpu_torch.utils.evaluation import ate_rmse

    n = len(frames)
    log(f"slam: mapgraph backend: {native.backend()}")
    trk, rec, launches, host_launches = run_slam(dev, scene, frames, orb_params)
    m = trk.map
    first_ok = next((i for i, r in enumerate(rec) if r["ok"]), None)
    n_ok = sum(r["ok"] for r in rec)
    log(f"slam: map initialized at frame {first_ok}; tracked {n_ok}/{n} frames; state {trk.state.name}; "
        f"fused path declined {trk.n_fused_declined}; keyframes {m.n_keyframes()} ({trk.n_kf_inserted} inserted); "
        f"landmarks {m.n_landmarks()}")
    if first_ok is None or first_ok >= min(SLAM_INIT_BY, n):
        fail(f"slam: the map did not initialize within the first {min(SLAM_INIT_BY, n)} frames")
    lost = [i for i, r in enumerate(rec) if i > first_ok and not r["ok"]]
    if lost or trk.state != TrackState.OK or trk.n_fused_declined:
        fail(f"slam: frames {lost[:10]} not tracked after initialization; state {trk.state.name}; "
             f"{trk.n_fused_declined} frames declined by the fused path")
    if launches != n or host_launches != n:
        fail(f"slam: orb_describe ran {launches} times on the card ({host_launches} by the wrapper) for {n} frames")
    kv, lv = m.kf_valid, m.lm_valid
    if not (np.isfinite(m.kf_R[kv]).all() and np.isfinite(m.kf_t[kv]).all() and np.isfinite(m.lm_pos[lv]).all()):
        fail("slam: non-finite map poses or points")

    track = [r for i, r in enumerate(rec) if i > first_ok and not r["kf"]]
    steps = [r for r in rec if r["kf"]]
    ms = np.asarray([r["ms"] for r in track])
    log(f"slam: per tracked frame without a keyframe ({len(track)}): median {np.median(ms):.3f} ms, "
        f"p99 {np.percentile(ms, 99):.3f} ms; result fetches per frame {np.mean([r['fetches'] for r in track]):.2f}, "
        f"synchronizing calls per frame (uploads included) {np.mean([r['syncs'] for r in track]):.1f}")
    if steps:
        ms_kf = np.asarray([r["ms"] for r in steps])
        log(f"slam: per keyframe frame ({len(steps)}): median {np.median(ms_kf):.3f} ms, max {ms_kf.max():.3f} ms; "
            f"result fetches {np.mean([r['fetches'] for r in steps]):.2f}, synchronizing calls "
            f"{np.mean([r['syncs'] for r in steps]):.1f} (track + mapping step)")
    summ = trk.timers.summary()
    split = ", ".join(
        f"{k[4:]} {summ[k]['mean_ms']:.2f}" for k in
        ("map_triangulate_dispatch", "map_triangulate", "map_fuse_dispatch", "map_fuse", "map_stats",
         "map_cull_lm", "map_local_ba_dispatch", "map_local_ba", "map_cull_kf") if k in summ
    )
    if "map_step" in summ:
        log(f"slam: mapping step mean {summ['map_step']['mean_ms']:.2f} ms over {summ['map_step']['count']} steps "
            f"(host clock; a stage's device work is paid where its result is fetched): {split}")
    log(f"slam: orb_describe launches counted on the card {launches}, by the wrapper {host_launches} (= {n} frames)")

    stamps = np.arange(n) * 0.05
    ts_est, Twc = trk.export_trajectory()
    if not np.isfinite(Twc).all() or len(ts_est) < n_ok - 1:
        fail(f"slam: exported trajectory has {len(ts_est)} poses for {n_ok} tracked frames, or is not finite")
    ate = ate_rmse(ts_est, Twc[:, :3, 3], stamps, ts)
    log(f"slam: scale-aligned ATE RMSE {ate.rmse_scaled:.6f} m over {ate.n_pairs} frames (Sim(3) alignment, scale "
        f"{ate.scale:.4f}); bound {SLAM_ATE_M} + {TOL_SLAM_ATE_M} m")

    # A second cold start on the same frames: is the run reproducible bit for bit?
    trk2, rec2, launches2, _ = run_slam(dev, scene, frames, orb_params)
    _, Twc2 = trk2.export_trajectory()
    same = Twc.shape == Twc2.shape and np.array_equal(Twc, Twc2)
    diff = float(np.abs(Twc[:, :3, 3] - Twc2[:, :3, 3]).max()) if Twc.shape == Twc2.shape else float("nan")
    ms2 = np.asarray([r["ms"] for i, r in enumerate(rec2) if r["ok"] and not r["kf"]])
    log(f"slam: second run: trajectory bitwise equal to the first: {same} (max position diff {diff:.3e}); "
        f"keyframes {trk2.map.n_keyframes()}, landmarks {trk2.map.n_landmarks()}, median {np.median(ms2):.3f} ms "
        f"per tracked frame, describe launches {launches2}")

    if m.n_keyframes() < SLAM_MIN_KFS or m.n_landmarks() < SLAM_MIN_LMS:
        if gate_ate:
            fail(f"slam: {m.n_keyframes()} keyframes (>= {SLAM_MIN_KFS}) and {m.n_landmarks()} landmarks "
                 f"(>= {SLAM_MIN_LMS}) required")
        log("slam: keyframe and landmark floors skipped (shortened run)")
    if not gate_ate:
        log("slam: ATE gate skipped (not the default configuration the bound was measured on)")
    elif not ate.rmse_scaled <= SLAM_ATE_M + TOL_SLAM_ATE_M:
        fail(f"slam: scale-aligned ATE {ate.rmse_scaled:.6f} m > {SLAM_ATE_M} + {TOL_SLAM_ATE_M} m")
    all_ms = np.asarray([r["ms"] for r in rec])
    return launches, dict(ate=float(ate.rmse_scaled), median_ms=float(np.median(all_ms)),
                          p99_ms=float(np.percentile(all_ms, 99)), fps=n / (all_ms.sum() / 1e3))


def make_system(dev, scene, orb_params, async_mapping=True, enable_loop_closing=False, sensor=None, camera=None,
                load_atlas=None, **settings_kw):
    """The port's System over a Settings object made in code (no YAML);
    `settings_kw` are further Settings fields (bf, a second camera...)."""
    from orbslam3_cpp_fork_tpu_torch import convert
    from orbslam3_cpp_fork_tpu_torch.runtime.system import System
    from orbslam3_cpp_fork_tpu_torch.runtime.tracker import Sensor
    from orbslam3_cpp_fork_tpu_torch.utils.settings import Settings

    K = scene.K
    settings = Settings(
        camera_type="PinHole", camera=camera or convert.camera_from_numpy(K[0, 0], K[1, 1], K[0, 2], K[1, 2]),
        width=scene.width, height=scene.height, fps=30.0, rgb=False, n_features=orb_params.n_features,
        scale_factor=orb_params.scale_factor, n_levels=orb_params.n_levels,
        ini_th_fast=int(orb_params.th_fast_high), min_th_fast=int(orb_params.th_fast_low), **settings_kw,
    )
    return System(settings, sensor or Sensor.MONOCULAR, async_mapping=async_mapping,
                  enable_loop_closing=enable_loop_closing, load_atlas=load_atlas, device=dev)


def run_async(dev, scene, frames, orb_params, time_recently_lost=None):
    """One cold-start run in the default mode (mapping worker + pipelined
    tracking) through System, free-running, then shutdown. A failure on the
    mapping thread is re-raised by wait_idle or by shutdown and ends the
    script. Returns the system, per-frame records, what the spies saw and
    the describe-launch counts."""
    import threading

    import torch

    from orbslam3_cpp_fork_tpu_torch.ops import patches

    system = make_system(dev, scene, orb_params)
    trk = system.tracker
    if trk.pipeline_lag != 2 or trk.worker is None:
        fail(f"async: the default mode resolved pipeline_lag={trk.pipeline_lag}, worker={trk.worker}")
    if time_recently_lost is not None:
        trk.cfg.time_recently_lost = time_recently_lost
    seen = dict(stale=[], step_threads=[])
    finish, step = trk._finish_tracked_frame, trk._mapping_step

    def finish_spy(frame, n_in):
        ids = frame.lm_idx[frame.lm_idx >= 0]
        if len(ids) and not trk.map.lm_valid[ids].all():
            seen["stale"].append((frame.frame_id, int((~trk.map.lm_valid[ids]).sum())))
        return finish(frame, n_in)

    def step_spy(k, map_ref):
        seen["step_threads"].append(threading.current_thread().name)
        return step(k, map_ref)

    trk._finish_tracked_frame, trk._mapping_step = finish_spy, step_spy
    counter = patches.describe_counter(dev)
    torch.cuda.synchronize()
    counter.zero_()
    patches.describe_launches = 0
    rec = []
    t_start = time.perf_counter()
    for i, f in enumerate(frames):
        busy0 = trk.worker.busy()
        t1 = time.perf_counter()
        T = system.track_monocular(f, i * 0.05)
        ms = (time.perf_counter() - t1) * 1e3
        rec.append(dict(ms=ms, ok=T is not None, state=trk.state.name, mapping=busy0 or trk.worker.busy()))
    t_track = time.perf_counter() - t_start
    worker = trk.worker
    system.shutdown()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t_start
    return system, rec, seen, worker, dict(t_track=t_track, wall=wall), int(counter), patches.describe_launches


def phase_async(dev, scene, ts, frames, orb_params, slam, gate_ate):
    import numpy as np

    from orbslam3_cpp_fork_tpu_torch.runtime.tracker import TrackState
    from orbslam3_cpp_fork_tpu_torch.utils.evaluation import ate_rmse

    n = len(frames)
    system, rec, seen, worker, times, launches, host_launches = run_async(dev, scene, frames, orb_params)
    trk = system.tracker
    m = trk.map
    first_ok = next((i for i, r in enumerate(rec) if r["state"] == "OK"), None)
    log(f"async: map initialized at frame {first_ok}; state {trk.state.name}; pipelined frames "
        f"{trk.n_pipelined_frames}, synchronous {trk.n_sync_frames}, declined by the fused path {trk.n_fused_declined}; "
        f"loss events {trk.n_lost_events}, in-flight frames dropped {trk.n_frames_dropped}; keyframes "
        f"{m.n_keyframes()} ({trk.n_kf_inserted} inserted, {trk.n_kf_skipped_backpressure} skipped by back-pressure); "
        f"landmarks {m.n_landmarks()}")
    n_worker = sum(t == "mapping" for t in seen["step_threads"])
    log(f"async: mapping steps {len(seen['step_threads'])}, {n_worker} of them on the worker thread; keyframes "
        f"processed by the worker {worker.n_processed}; catch-up batches {worker.n_batches}; worker busy "
        f"{worker.busy_s:.2f} s of {times['wall']:.2f} s (idle share {1 - worker.busy_s / times['wall']:.1%})")
    ms = np.asarray([r["ms"] for r in rec])
    during = np.asarray([r["ms"] for r in rec[first_ok or 0:] if r["mapping"]])
    other = np.asarray([r["ms"] for r in rec[first_ok or 0:] if not r["mapping"]])
    log(f"async: per-frame track() latency median {np.median(ms):.3f} ms, p99 {np.percentile(ms, 99):.3f} ms "
        f"(synchronous run of this process: median {slam['median_ms']:.3f} ms, p99 {slam['p99_ms']:.3f} ms, all "
        f"frames, keyframe frames included)")
    for name, a in (("while a mapping step was running", during), ("with the worker idle", other)):
        if len(a):
            log(f"async: frames {name} ({len(a)}): median {np.median(a):.3f} ms, p99 {np.percentile(a, 99):.3f} ms")
    waits = [float(c.split(":")[1].rstrip("ms+")) for cs in trk.frame_causes.values() for c in cs
             if c.startswith("map_wait:")]
    log(f"async: frames per second {n / times['t_track']:.3f} over the track() calls, {n / times['wall']:.3f} end to "
        f"end with the final flush (synchronous run: {slam['fps']:.3f}); map_wait on {len(waits)} frames, "
        f"{sum(waits) / n:.2f} ms per frame over all frames, longest {max(waits, default=0.0):.0f} ms; "
        f"young-map drains {sum('young_map_drain' in cs for cs in trk.frame_causes.values())}")
    log(f"async: orb_describe launches counted on the card {launches}, by the wrapper {host_launches} (= {n} frames)")

    if first_ok is None or first_ok >= min(SLAM_INIT_BY, n):
        fail(f"async: the map did not initialize within the first {min(SLAM_INIT_BY, n)} frames")
    if trk.state != TrackState.OK or trk.n_lost_events:
        fail(f"async: final state {trk.state.name}, {trk.n_lost_events} loss events")
    if worker.n_processed < 1 or n_worker < 1 or n_worker != len(seen["step_threads"]):
        fail(f"async: the worker processed {worker.n_processed} keyframes; mapping steps ran on {seen['step_threads']}")
    if seen["stale"]:
        fail(f"async: tracked frames bound to dead landmarks: {seen['stale'][:10]}")
    if launches != n or host_launches != n:
        fail(f"async: orb_describe ran {launches} times on the card ({host_launches} by the wrapper) for {n} frames")
    kv, lv = m.kf_valid, m.lm_valid
    if not (np.isfinite(m.kf_R[kv]).all() and np.isfinite(m.kf_t[kv]).all() and np.isfinite(m.lm_pos[lv]).all()):
        fail("async: non-finite map poses or points")
    ts_est, Twc = trk.export_trajectory()
    coverage = len(ts_est) / n
    if not np.isfinite(Twc).all() or not np.all(np.diff(ts_est) > 0):
        fail("async: exported trajectory is not finite or its timestamps do not strictly increase")
    ate = ate_rmse(ts_est, Twc[:, :3, 3], np.arange(n) * 0.05, ts)
    bound = ASYNC_ATE_FACTOR * slam["ate"] + ASYNC_ATE_SLACK_M
    log(f"async: coverage {coverage:.3f} ({len(ts_est)} poses exported for {n} frames); scale-aligned ATE RMSE "
        f"{ate.rmse_scaled:.6f} m over {ate.n_pairs} frames; bound {ASYNC_ATE_FACTOR} x {slam['ate']:.6f} "
        f"(synchronous run of this process) + {ASYNC_ATE_SLACK_M} = {bound:.6f} m")
    if not gate_ate:
        log("async: pipelined-frame, coverage and ATE gates skipped (shortened run)")
        return launches
    if trk.n_pipelined_frames <= ASYNC_MIN_PIPELINED:
        fail(f"async: {trk.n_pipelined_frames} pipelined frames (> {ASYNC_MIN_PIPELINED} required)")
    if coverage <= ASYNC_MIN_COVERAGE:
        fail(f"async: coverage {coverage:.3f} (> {ASYNC_MIN_COVERAGE} required)")
    if not ate.rmse_scaled <= bound:
        fail(f"async: scale-aligned ATE {ate.rmse_scaled:.6f} m > {bound:.6f} m")
    return launches


def phase_ladder(dev, scene, frames, orb_params):
    """Four black frames in a 60-frame prefix: the pipeline drops what is in
    flight and the loss ladder runs (RECENTLY_LOST with re-acquisition, LOST
    after time_recently_lost = 0.6 s); nothing may raise."""
    import numpy as np

    seq = list(frames[:LADDER_FRAMES])
    for i in range(*LADDER_BLACK):
        seq[i] = np.zeros_like(seq[i])
    system, rec, seen, worker, times, launches, _ = run_async(dev, scene, seq, orb_params, time_recently_lost=0.6)
    trk = system.tracker
    states = [r["state"] for r in rec]
    changes = [(i, s) for i, s in enumerate(states) if i == 0 or s != states[i - 1]]
    log(f"ladder: state changes {changes}; loss events {trk.n_lost_events}; in-flight frames dropped "
        f"{trk.n_frames_dropped}; frames left without a pose {trk.n_lost_frames}; final state "
        f"{trk.state.name}; re-acquired: {trk.state.name == 'OK'}; describe launches {launches} for {len(seq)} frames")
    if trk.n_lost_events < 1:
        fail("ladder: four black frames did not produce a loss event")
    if trk.state.name not in ("OK", "RECENTLY_LOST", "LOST"):
        fail(f"ladder: final state {trk.state.name}")
    if seen["stale"]:
        fail(f"ladder: tracked frames bound to dead landmarks: {seen['stale'][:10]}")


def render_loop():
    """The scene of tests/test_loop_e2e.py at 752x480: scene, GT
    camera-to-world poses, uint8 frames."""
    import numpy as np

    from orbslam3_cpp_fork_tpu_torch.datasets import synthetic

    scene = synthetic.make_ring_scene(seed=11, n_points=900, size_range=(9, 15), width=752, height=480)
    Rs, ts = synthetic.circle_trajectory(n_frames=LOOP_FRAMES, radius=2.5, total_angle=2.3 * np.pi)
    frames = [synthetic.to_u8(f) for f in synthetic.render_sequence(scene, Rs, ts)]
    return scene, Rs, ts, frames


def render_stereo_loop(n_frames=STEREO_FRAMES, count=None):
    """The scene of tests/test_stereo_loop_e2e.py at 752x480 over a 2.3 pi
    circle of `n_frames`: scene, GT camera-to-world poses, uint8 (left,
    right) pairs of the 0.2 m rig; the first `count` of them if given."""
    import numpy as np

    from orbslam3_cpp_fork_tpu_torch.datasets import synthetic

    scene = synthetic.make_ring_scene(seed=13, n_points=900, size_range=(9, 15), width=STEREO_WIDTH,
                                      height=STEREO_HEIGHT)
    Rs, ts = synthetic.circle_trajectory(n_frames=n_frames, radius=2.5, total_angle=STEREO_TURNS * np.pi)
    count = n_frames if count is None else count
    pairs = [
        (synthetic.to_u8(synthetic.render_frame(scene, Rs[i], ts[i])),
         synthetic.to_u8(synthetic.render_frame(scene, *synthetic.stereo_right_pose(Rs[i], ts[i], STEREO_BASELINE))))
        for i in range(count)
    ]
    return scene, Rs[:count], ts[:count], pairs


def render_rgbd():
    """tests/test_stereo.py's RGB-D sequence at 640x480: scene, GT poses,
    uint8 frames and depth maps in meters."""
    from orbslam3_cpp_fork_tpu_torch.datasets import synthetic

    scene = synthetic.make_scene(seed=5, n_points=1500)
    Rs, ts = synthetic.smooth_trajectory(n_frames=RGBD_FRAMES, step=0.12, yaw_rate=0.002)
    frames = [(synthetic.to_u8(synthetic.render_frame(scene, R, t)), synthetic.render_depth(scene, R, t))
              for R, t in zip(Rs, ts)]
    return scene, Rs, ts, frames


def stereo_config(scene, orb_params, **kw):
    """The stereo/RGB-D TrackerConfig of tests/test_stereo.py's rigs: bf =
    0.2 fx, th_depth = 0.2 x 40; the reference's defaults otherwise."""
    from orbslam3_cpp_fork_tpu_torch import convert
    from orbslam3_cpp_fork_tpu_torch.runtime.tracker import Sensor, TrackerConfig

    K = scene.K
    return TrackerConfig(
        camera=convert.camera_from_numpy(K[0, 0], K[1, 1], K[0, 2], K[1, 2]), width=scene.width,
        height=scene.height, orb=orb_params, bf=STEREO_BASELINE * float(K[0, 0]), th_depth=STEREO_BASELINE * 40.0,
        **{"sensor": Sensor.STEREO, **kw},
    )


def revisit(Rs, ts, ev):
    """Ground-truth distance (m) of a loop event's two camera centres and
    the angle (deg) between their optical axes."""
    import numpy as np

    a, b = ev["kf_frame"], ev["match_frame"]
    cosang = float(np.clip(Rs[a][:, 2] @ Rs[b][:, 2], -1.0, 1.0))
    return float(np.linalg.norm(ts[a] - ts[b])), float(np.degrees(np.arccos(cosang)))


def counted(dev):
    """Zero the describe-launch counters; returns a reader of both."""
    import torch

    from orbslam3_cpp_fork_tpu_torch.ops import patches

    counter = patches.describe_counter(dev)
    torch.cuda.synchronize()
    counter.zero_()
    patches.describe_launches = 0
    return lambda: (int(counter), patches.describe_launches)


def spy_dead_reckoned(trk):
    """The ids of the frames the tracker records while not OK: a
    RECENTLY_LOST frame enters the trajectory with its constant-velocity
    prediction, as the reference's does (ROADMAP R8)."""
    dead, record = set(), trk._record_trajectory

    def spy(frame):
        if trk.state.name != "OK":
            dead.add(frame.frame_id)
        return record(frame)

    trk._record_trajectory = spy
    return dead


def tracked_mask(ts_est, dead):
    """Which exported poses (stamps every 0.05 s) were tracked, not predicted."""
    import numpy as np

    return np.asarray([int(round(t / 0.05)) not in dead for t in ts_est], bool)


def aligned_centre_error(ts_est, Twc, ts_gt, n_pre, dead, c_est, target):
    """Distance (m) of camera centre `c_est` from `target` after the Sim(3)
    that aligns the tracked poses before frame `n_pre` with the ground-truth
    centres `ts_gt`; and that alignment's scale."""
    import numpy as np

    from orbslam3_cpp_fork_tpu_torch.utils.evaluation import align_umeyama

    pre = (ts_est < n_pre * 0.05 - 1e-6) & tracked_mask(ts_est, dead)
    s, R, t = align_umeyama(Twc[pre, :3, 3], ts_gt[np.round(ts_est[pre] / 0.05).astype(int)], True)
    return float(np.linalg.norm(s * (R @ c_est) + t - target)), float(s), int(pre.sum())


def loop_report(name, trk, Rs, ts):
    """Log the loop closer's events, the global BAs and the loop stage's
    timings; returns (loop events, global BAs applied)."""
    import numpy as np

    lc = trk.loop_closer
    loops = [e for e in lc.events if e["kind"] == "loop"]
    gbas = [e for e in trk.events if e["kind"] == "gba_apply"]
    for ev in loops:
        d, ang = revisit(Rs, ts, ev)
        log(f"{name}: loop closed: keyframe {ev['kf']} (frame {ev['kf_frame']}) -> {ev['match']} (frame "
            f"{ev['match_frame']}), scale {ev['scale']:.4f}; ground truth: centres {d:.3f} m apart, optical axes "
            f"{ang:.1f} deg apart")
    summ = trk.timers.summary()
    v = np.asarray(lc.validate_s) * 1e3
    log(f"{name}: loops closed {lc.n_loops_closed}; global BAs applied {len(gbas)} {gbas}; loop step "
        + (f"mean {summ['map_loop']['mean_ms']:.2f} ms over {summ['map_loop']['count']} keyframes" if "map_loop" in summ
           else "not run")
        + (f"; global BA {summ['global_ba']['mean_ms']:.2f} ms (host clock, {summ['global_ba']['count']} runs)"
           if "global_ba" in summ else "")
        + (f"; validation fetches {len(v)}: median {np.median(v):.2f} ms, max {v.max():.2f} ms (each waits for the "
           f"work queued before it on the stream)" if len(v) else ""))
    return loops, gbas


def run_loop_sync(dev, scene, frames, orb_params):
    import numpy as np

    from orbslam3_cpp_fork_tpu_torch import convert
    from orbslam3_cpp_fork_tpu_torch.runtime.tracker import MonoTracker, TrackerConfig

    K = scene.K
    cfg = TrackerConfig(
        camera=convert.camera_from_numpy(K[0, 0], K[1, 1], K[0, 2], K[1, 2]),
        width=scene.width, height=scene.height, orb=orb_params, async_mapping=False,
    )
    trk = MonoTracker(cfg, dev)
    if not (cfg.enable_loop_closing and cfg.enable_global_ba and trk.loop_closer is not None):
        fail("loop: the default TrackerConfig does not close loops")
    read = counted(dev)
    t0 = time.perf_counter()
    ok = [trk.track(f, i * 0.05) is not None for i, f in enumerate(frames)]
    secs = time.perf_counter() - t0
    ts_est, Twc = trk.export_trajectory()
    return trk, np.asarray(ok), ts_est, Twc, read(), secs


def phase_loop(dev, orb_params, gate_ate):
    import threading

    import numpy as np

    from orbslam3_cpp_fork_tpu_torch.datasets import synthetic
    from orbslam3_cpp_fork_tpu_torch.utils.evaluation import ate_rmse

    scene, Rs, ts, frames = render_loop()
    n = len(frames)
    stamps = np.arange(n) * 0.05
    launches = 0

    # Part A: the synchronous control, twice.
    runs = []
    for r in range(2):
        trk, ok, ts_est, Twc, (cnt, host), secs = run_loop_sync(dev, scene, frames, orb_params)
        if cnt != n or host != n:
            fail(f"loop A: orb_describe ran {cnt} times on the card ({host} by the wrapper) for {n} frames")
        launches += cnt
        runs.append((trk, ok, ts_est, Twc))
        log(f"loop A run {r + 1}: tracked {int(ok.sum())}/{n} frames, state {trk.state.name}, keyframes "
            f"{trk.map.n_keyframes()}, landmarks {trk.map.n_landmarks()}, {secs:.2f} s ({n / secs:.3f} fps)")
    trk, ok, ts_est, Twc = runs[0]
    loops, gbas = loop_report("loop A", trk, Rs, ts)
    ate = ate_rmse(ts_est, Twc[:, :3, 3], stamps, ts)
    bound = max(LOOP_JAX_ATE_M, LOOP_PORT_ATE_M) + TOL_LOOP_ATE_M
    same = runs[0][3].shape == runs[1][3].shape and np.array_equal(runs[0][3], runs[1][3])
    log(f"loop A: scale-aligned ATE RMSE {ate.rmse_scaled:.6f} m over {ate.n_pairs} frames (scale {ate.scale:.4f}); "
        f"bound max({LOOP_JAX_ATE_M:.6f}, {LOOP_PORT_ATE_M:.6f}) + {TOL_LOOP_ATE_M} = {bound:.6f} m; second run "
        f"bitwise equal to the first: {same}")
    if not loops or trk.loop_closer.n_loops_closed < 1:
        fail("loop A: no loop closed")
    bad = [ev for ev in loops if revisit(Rs, ts, ev)[1] > LOOP_REVISIT_DEG]
    if bad:
        fail(f"loop A: loops between views more than {LOOP_REVISIT_DEG} degrees apart: {bad}")
    if not gbas:
        fail("loop A: no global BA applied")
    if ok.sum() <= LOOP_MIN_TRACKED or trk.state.name != "OK":
        fail(f"loop A: {int(ok.sum())} frames tracked (> {LOOP_MIN_TRACKED} required), state {trk.state.name}")
    if not same:
        fail("loop A: the second run's trajectory differs from the first")
    if gate_ate and not ate.rmse_scaled <= bound:
        fail(f"loop A: scale-aligned ATE {ate.rmse_scaled:.6f} m > {bound:.6f} m")

    # Part B: the default mode through System, free-running.
    system = make_system(dev, scene, orb_params, enable_loop_closing=True)
    trk = system.tracker
    if trk.loop_worker is None or trk.worker is None:
        fail("loop B: the default mode has no loop worker")
    seen = dict(stale=[], loop_threads=[], dead_reckoned=spy_dead_reckoned(trk))
    finish, loop_step = trk._finish_tracked_frame, trk._loop_step

    def finish_spy(frame, n_in):
        ids = frame.lm_idx[frame.lm_idx >= 0]
        if len(ids) and not trk.map.lm_valid[ids].all():
            seen["stale"].append((frame.frame_id, int((~trk.map.lm_valid[ids]).sum())))
        return finish(frame, n_in)

    def loop_spy(k, map_ref, frame=None):
        n0 = trk.loop_closer.n_loops_closed
        out = loop_step(k, map_ref, frame=frame)
        if trk.loop_closer.n_loops_closed > n0:
            seen["loop_threads"].append(threading.current_thread().name)
        return out

    trk._finish_tracked_frame, trk._loop_step = finish_spy, loop_spy
    read = counted(dev)
    t0 = time.perf_counter()
    for i, f in enumerate(frames):
        system.track_monocular(f, i * 0.05)
    t_track = time.perf_counter() - t0
    ts_b, Twc_b = trk.export_trajectory()  # flushes every worker (re-raising their failures)
    cnt, host = read()
    loops_b, gbas_b = loop_report("loop B", trk, Rs, ts)
    ate_all = ate_rmse(ts_b, Twc_b[:, :3, 3], stamps, ts)
    tracked = tracked_mask(ts_b, seen["dead_reckoned"])
    ate_b = ate_rmse(ts_b[tracked], Twc_b[tracked, :3, 3], stamps, ts)
    bound_b = ASYNC_ATE_FACTOR * ate.rmse_scaled + ASYNC_ATE_SLACK_M
    drops = [c for cs in trk.frame_causes.values() for c in cs if c.startswith("map_correction_rebase")]
    log(f"loop B: state {trk.state.name}; pipelined frames {trk.n_pipelined_frames}; loss events {trk.n_lost_events}; "
        f"{len(ts_b)} poses exported for {n} frames; loops closed on threads {seen['loop_threads']}; "
        f"map_correction_rebase events {len(drops)} dropping {sum(int(c.split('drop')[1]) for c in drops)} in-flight "
        f"frames; loop worker busy {trk.loop_worker.busy_s:.2f} s; {n / t_track:.3f} fps over the track() calls; "
        f"scale-aligned ATE RMSE over every exported pose {ate_all.rmse_scaled:.6f} m; dead-reckoned RECENTLY_LOST "
        f"poses among them (ROADMAP R8) {sorted(seen['dead_reckoned'])}; over the {int(tracked.sum())} tracked "
        f"poses {ate_b.rmse_scaled:.6f} m; bound {ASYNC_ATE_FACTOR} x {ate.rmse_scaled:.6f} + {ASYNC_ATE_SLACK_M} = "
        f"{bound_b:.6f} m")
    if cnt != n or host != n:
        fail(f"loop B: orb_describe ran {cnt} times on the card ({host} by the wrapper) for {n} frames")
    launches += cnt
    if not seen["loop_threads"] or any(t != "loop_closing" for t in seen["loop_threads"]):
        fail(f"loop B: loops closed on threads {seen['loop_threads']} (the loop thread required)")
    if len(ts_b) / n <= ASYNC_MIN_COVERAGE or not np.all(np.diff(ts_b) > 0) or not np.isfinite(Twc_b).all():
        fail(f"loop B: {len(ts_b)} of {n} poses exported, or not in order, or not finite")
    if seen["stale"]:
        fail(f"loop B: tracked frames bound to dead landmarks: {seen['stale'][:10]}")
    if int(tracked.sum()) < LOOP_ASYNC_REF_TRACKED - LOOP_ASYNC_TRACKED_MARGIN:
        fail(f"loop B: {int(tracked.sum())} poses tracked while OK (>= {LOOP_ASYNC_REF_TRACKED} - "
             f"{LOOP_ASYNC_TRACKED_MARGIN}, the reference's fewest on a CPU less the margin, required)")
    if gate_ate and not ate_b.rmse_scaled <= bound_b:
        fail(f"loop B: scale-aligned ATE {ate_b.rmse_scaled:.6f} m > {bound_b:.6f} m")

    # Part C: teleport back to frame TELEPORT_TO's pose.
    img = synthetic.to_u8(synthetic.render_frame(scene, Rs[TELEPORT_TO], ts[TELEPORT_TO]))
    fid0 = trk.frame_id
    read = counted(dev)
    states, recovered_at, pose = [], None, None
    for j in range(TELEPORT_FRAMES):
        system.track_monocular(img, (n + j) * 0.05)
        states.append(trk.state.name)
        last = trk.last
        if recovered_at is None and trk.state.name == "OK" and last.frame_id >= fid0 and last.R is not None:
            recovered_at, pose = j, (last.R.copy(), last.t.copy())
    cnt, host = read()
    relocs = [e for e in trk.events if e["kind"] == "reloc"]
    ts_c, Twc_c = trk.export_trajectory()
    err, s, n_al = float("nan"), float("nan"), 0
    if pose is not None:
        err, s, n_al = aligned_centre_error(
            ts_c, Twc_c, ts, n, seen["dead_reckoned"], -pose[0].T @ pose[1], ts[TELEPORT_TO],
        )
    log(f"loop C: states {states}; relocalized at teleported frame {recovered_at}; relocalizations {relocs}; "
        f"relocalized centre {err:.4f} m from frame {TELEPORT_TO}'s ground truth (Sim(3)-aligned by the {n_al} "
        f"tracked pre-teleport poses, scale {s:.4f}); describe launches {cnt} for {TELEPORT_FRAMES} frames")
    system.shutdown()  # re-raises a failure of any worker thread
    if cnt != TELEPORT_FRAMES or host != TELEPORT_FRAMES:
        fail(f"loop C: orb_describe ran {cnt} times on the card ({host} by the wrapper) for {TELEPORT_FRAMES} frames")
    launches += cnt
    if recovered_at is None or recovered_at > RELOC_WITHIN:
        fail(f"loop C: not relocalized within {RELOC_WITHIN} frames (at {recovered_at})")
    if not err < RELOC_TOL_M:
        fail(f"loop C: relocalized centre {err:.4f} m from the ground truth (< {RELOC_TOL_M} m required)")
    return launches, runs[0][0]  # loop A's first tracker: the scale phase solves its map


def run_stereo_sync(dev, scene, pairs, orb_params):
    """Part A's synchronous stereo run: the tracker in the reference's
    default configuration but for async_mapping=False."""
    import numpy as np

    from orbslam3_cpp_fork_tpu_torch.runtime.tracker import Tracker

    trk = Tracker(stereo_config(scene, orb_params, async_mapping=False), dev)
    if not (trk.cfg.enable_loop_closing and trk.cfg.enable_global_ba and trk.loop_closer is not None):
        fail("stereo A: the default TrackerConfig does not close loops")
    read = counted(dev)
    t0 = time.perf_counter()
    poses = [trk.track_stereo(l, r, i * 0.05) for i, (l, r) in enumerate(pairs)]
    secs = time.perf_counter() - t0
    ts_est, Twc = trk.export_trajectory()
    return trk, poses, ts_est, Twc, read(), secs


def remap_check(dev, scene, R_wc, t_wc):
    """One raw pair of the unrectified pinhole rig of tests/test_rectify.py,
    at its 752x480, through System's rectification on the card; returns the
    describe launches. The pair is the stereo scene at (R_wc, t_wc) seen by
    the rectified rig (System's K_new, R1, R2), carried into each raw camera
    by the inverse of its rectification map (rectify_points, then
    remap_bilinear on the CPU). Gates: the card's remap equals the CPU's
    within REMAP_TOL of the gray range; the pair initializes the map (state
    OK, two describe launches); the depths of the new landmarks against the
    rendered depth at their keypoints: the median relative error within
    REMAP_DEPTH_BIAS, the median of its size within REMAP_DEPTH_SPREAD."""
    import dataclasses

    import numpy as np
    import torch

    from orbslam3_cpp_fork_tpu_torch.datasets import synthetic
    from orbslam3_cpp_fork_tpu_torch.ops.camera import Camera
    from orbslam3_cpp_fork_tpu_torch.ops.image import remap_bilinear
    from orbslam3_cpp_fork_tpu_torch.ops.orb import OrbParams
    from orbslam3_cpp_fork_tpu_torch.runtime.tracker import Sensor
    from orbslam3_cpp_fork_tpu_torch.utils import rectify

    T = np.eye(4)
    T[:3, :3] = rectify._rodrigues_inv(np.array([0.004, -0.015, 0.008]))
    T[:3, 3] = [0.110, 0.0004, -0.0008]
    K1 = np.array([[458.0, 0, 367.2], [0, 457.3, 248.4], [0, 0, 1.0]])
    K2 = np.array([[457.6, 0, 379.9], [0, 456.1, 255.2], [0, 0, 1.0]])
    d1, d2 = np.array([-0.28, 0.074, 1.8e-4, 1.5e-5, 0.0]), np.array([-0.284, 0.076, -1.0e-4, 2.0e-5, 0.0])

    class Rig:
        K, width, height = K1.astype(np.float32), 752, 480

    system = make_system(
        dev, Rig, OrbParams(n_features=N_FEATURES), async_mapping=False, sensor=Sensor.STEREO,
        camera=Camera.pinhole(K1[0, 0], K1[1, 1], K1[0, 2], K1[1, 2], tuple(d1)),
        camera2=Camera.pinhole(K2[0, 0], K2[1, 1], K2[0, 2], K2[1, 2], tuple(d2)),
        Tlr=T, stereo_th_depth=40.0,
    )
    r = system._rect
    if r is None:
        fail("stereo C: the unrectified pinhole rig was not rectified")
    # Camera-to-world poses of the rectified views: x_rect = R1 x_c1 and
    # x_rect = R2 x_c2, camera 2 at t_c1_c2 in camera 1.
    R_l, c_l = R_wc @ r.R1.T, t_wc
    R_r, c_r = R_wc @ T[:3, :3] @ r.R2.T, t_wc + R_wc @ T[:3, 3]
    if not (np.allclose(R_l, R_r, atol=1e-9) and np.allclose(R_l.T @ (c_r - c_l), [r.baseline, 0, 0], atol=1e-9)):
        fail("stereo C: the rectified views are not a rectified pair")
    width, height = Rig.width, Rig.height
    rect_scene = dataclasses.replace(scene, width=width, height=height, K=r.K_new.astype(np.float32))
    u, v = np.meshgrid(np.arange(width, dtype=np.float64), np.arange(height, dtype=np.float64))
    grid = np.stack([u.ravel(), v.ravel()], 1)
    raw = []
    for K, d, R_rect, R_v, c_v in ((K1, d1, r.R1, R_l, c_l), (K2, d2, r.R2, R_r, c_r)):
        m = rectify.rectify_points(grid, K, d, R_rect, r.K_new).astype(np.float32)
        img = torch.from_numpy(synthetic.render_frame(rect_scene, R_v.astype(np.float32), c_v.astype(np.float32)))
        mx, my = (torch.from_numpy(np.ascontiguousarray(m[:, k].reshape(height, width))) for k in (0, 1))
        raw.append(synthetic.to_u8(remap_bilinear(img, mx, my).numpy()))
    img_l, img_r = (x.astype(np.float32) for x in raw)
    got_l, got_r = system._remap_pair(img_l, img_r)
    ref_l = remap_bilinear(torch.from_numpy(img_l), torch.from_numpy(r.map1_x), torch.from_numpy(r.map1_y)).numpy()
    ref_r = remap_bilinear(torch.from_numpy(img_r), torch.from_numpy(r.map2_x), torch.from_numpy(r.map2_y)).numpy()
    err = float(max(np.abs(got_l - ref_l).max(), np.abs(got_r - ref_r).max()))
    read = counted(dev)
    pose = system.track_stereo(raw[0], raw[1], 0.0)
    cnt, host = read()
    trk = system.tracker
    ids = trk.last.lm_idx[trk.last.lm_idx >= 0]
    xy = np.round(trk.last.xy[trk.last.lm_idx >= 0]).astype(int)
    true = synthetic.render_depth(rect_scene, R_l.astype(np.float32), c_l.astype(np.float32))[xy[:, 1], xy[:, 0]]
    on = true > 0
    rel = (trk.map.lm_pos[ids[on], 2] - true[on]) / true[on]
    bias, spread = (float(np.median(x)) if on.any() else float("nan") for x in (rel, np.abs(rel)))
    system.shutdown()
    log(f"stereo C: the unrectified rig's raw pair (752x480, baseline {r.baseline:.4f} m, bf {r.bf:.3f}): "
        f"remap_bilinear on the card vs the CPU max |diff| {err:.3e} gray levels (gate {REMAP_TOL * 255:.4f}); "
        f"state {trk.state.name}, {len(ids)} landmarks; relative depth error over {int(on.sum())} of them: median "
        f"{bias:.4f} (gate {REMAP_DEPTH_BIAS}), median of its size {spread:.4f} (gate {REMAP_DEPTH_SPREAD}); describe "
        f"launches {cnt}")
    if not err <= REMAP_TOL * 255:
        fail(f"stereo C: remap_bilinear differs from the CPU by {err:.3e} gray levels")
    if pose is None or trk.state.name != "OK":
        fail(f"stereo C: the rectified pair did not initialize the map (state {trk.state.name})")
    if not (abs(bias) < REMAP_DEPTH_BIAS and spread < REMAP_DEPTH_SPREAD):
        fail(f"stereo C: the rectified pair's landmark depths are off: median relative error {bias}, of its size "
             f"{spread}")
    if cnt != 2 or host != 2:
        fail(f"stereo C: orb_describe ran {cnt} times on the card ({host} by the wrapper) for one rectified pair")
    return cnt


def phase_stereo(dev, orb_params, gate_ate):
    """Stereo and RGB-D on the card (module docstring, phase 9)."""
    import numpy as np

    from orbslam3_cpp_fork_tpu_torch.runtime.tracker import Sensor, Tracker
    from orbslam3_cpp_fork_tpu_torch.utils.evaluation import ate_rmse

    scene, Rs, ts, pairs = render_stereo_loop()
    scene_b, Rs_b, ts_b, frames_b = render_rgbd()
    n = len(pairs)
    stamps = np.arange(n) * 0.05
    launches = 0

    # The fused describe kernel against its plain version on this phase's
    # pyramids: a stereo pair's two 752x480 images and a 640x480 RGB-D
    # frame (not counted: the counts are zeroed before each run below).
    worst = max(
        hold_describe(f"stereo {name} ({img.shape[1]}x{img.shape[0]}, {N_FEATURES} features)",
                      *frame_levels(dev, img, orb_params))
        for name, img in (("left", pairs[0][0]), ("right", pairs[0][1]), ("RGB-D", frames_b[0][0]))
    )

    # Part A: synchronous stereo with loop closing and the global BA, twice.
    runs = []
    for r in range(2):
        trk, poses, ts_est, Twc, (cnt, host), secs = run_stereo_sync(dev, scene, pairs, orb_params)
        if cnt != 2 * n or host != 2 * n:
            fail(f"stereo A: orb_describe ran {cnt} times on the card ({host} by the wrapper) for {n} pairs")
        launches += cnt
        ok = np.asarray([T is not None for T in poses])
        runs.append((trk, poses, ts_est, Twc))
        log(f"stereo A run {r + 1}: tracked {int(ok.sum())}/{n} pairs, state {trk.state.name}, keyframes "
            f"{trk.map.n_keyframes()}, landmarks {trk.map.n_landmarks()}, {secs:.2f} s ({n / secs:.3f} fps)")
    trk, poses, ts_est, Twc = runs[0]
    ok = np.asarray([T is not None for T in poses])
    loops, gbas = loop_report("stereo A", trk, Rs, ts)
    ate = ate_rmse(ts_est, Twc[:, :3, 3], stamps, ts)
    bound = min(max(STEREO_JAX_ATE_M, STEREO_PORT_ATE_M) + TOL_LOOP_ATE_M, STEREO_MAX_ATE_M)
    same = Twc.shape == runs[1][3].shape and np.array_equal(Twc, runs[1][3])
    log(f"stereo A: unscaled ATE RMSE {ate.rmse:.6f} m over {ate.n_pairs} frames (scale {ate.scale:.4f}, "
        f"scale-aligned {ate.rmse_scaled:.6f} m); bound min(max({STEREO_JAX_ATE_M:.6f}, {STEREO_PORT_ATE_M:.6f}) + "
        f"{TOL_LOOP_ATE_M}, {STEREO_MAX_ATE_M}) = {bound:.6f} m; loop closer fix_scale {trk.loop_closer.cfg.fix_scale}; "
        f"second run bitwise equal to the first: {same}")
    if not ok[0]:
        fail("stereo A: not initialized at frame 0")
    if ok.sum() <= STEREO_MIN_TRACKED:
        fail(f"stereo A: {int(ok.sum())} frames tracked (> {STEREO_MIN_TRACKED} required)")
    if not loops or not trk.loop_closer.cfg.fix_scale:
        fail(f"stereo A: loops {loops}, fix_scale {trk.loop_closer.cfg.fix_scale} (a loop in SE(3) required)")
    if not gbas:
        fail("stereo A: no global BA applied")
    if not same:
        fail("stereo A: the second run's trajectory differs from the first")
    if not abs(ate.scale - 1.0) < STEREO_SCALE_TOL:
        fail(f"stereo A: scale {ate.scale:.4f} (|scale - 1| < {STEREO_SCALE_TOL} required)")
    if gate_ate and not ate.rmse <= bound:
        fail(f"stereo A: unscaled ATE {ate.rmse:.6f} m > {bound:.6f} m")

    # Part B: RGB-D.
    trk_b = Tracker(stereo_config(scene_b, orb_params, sensor=Sensor.RGBD, async_mapping=False), dev)
    read = counted(dev)
    t0 = time.perf_counter()
    ok_b = [trk_b.track_rgbd(img, dep, i * 0.05) is not None for i, (img, dep) in enumerate(frames_b)]
    secs = time.perf_counter() - t0
    cnt, host = read()
    ts_e, Twc_e = trk_b.export_trajectory()
    ate_b = ate_rmse(ts_e, Twc_e[:, :3, 3], np.arange(len(frames_b)) * 0.05, ts_b)
    bound_b = max(RGBD_JAX_ATE_M, RGBD_PORT_ATE_M) + TOL_LOOP_ATE_M
    log(f"stereo B (RGB-D, 640x480): tracked {sum(ok_b)}/{len(frames_b)}, {secs:.2f} s; unscaled ATE "
        f"{ate_b.rmse:.6f} m (bound max({RGBD_JAX_ATE_M:.6f}, {RGBD_PORT_ATE_M:.6f}) + {TOL_LOOP_ATE_M} = "
        f"{bound_b:.6f} m), scale {ate_b.scale:.4f}; describe launches {cnt}")
    if cnt != len(frames_b) or host != len(frames_b):
        fail(f"stereo B: orb_describe ran {cnt} times on the card ({host} by the wrapper) for {len(frames_b)} frames")
    launches_rgbd = cnt
    if not all(ok_b):
        fail("stereo B: not every RGB-D frame tracked")
    if not abs(ate_b.scale - 1.0) < RGBD_SCALE_TOL:
        fail(f"stereo B: scale {ate_b.scale:.4f} (|scale - 1| < {RGBD_SCALE_TOL} required)")
    if gate_ate and not ate_b.rmse <= bound_b:
        fail(f"stereo B: unscaled ATE {ate_b.rmse:.6f} m > {bound_b:.6f} m")

    # Part C: the default mode through System on part A's pairs.
    K = scene.K
    system = make_system(dev, scene, orb_params, enable_loop_closing=True, sensor=Sensor.STEREO,
                         bf=STEREO_BASELINE * float(K[0, 0]), stereo_th_depth=40.0)
    trk = system.tracker
    if trk.worker is None or trk.loop_worker is None or not trk.loop_closer.cfg.fix_scale:
        fail("stereo C: the default mode has no workers or closes loops in Sim(3)")
    dead = spy_dead_reckoned(trk)
    read = counted(dev)
    t0 = time.perf_counter()
    for i, (l, r) in enumerate(pairs):
        system.track_stereo(l, r, i * 0.05)
    t_track = time.perf_counter() - t0
    ts_c, Twc_c = trk.export_trajectory()  # flushes every worker (re-raising their failures)
    cnt, host = read()
    loops_c, _ = loop_report("stereo C", trk, Rs, ts)
    tracked = tracked_mask(ts_c, dead)
    ate_c = ate_rmse(ts_c[tracked], Twc_c[tracked, :3, 3], stamps, ts)
    bound_c = ASYNC_ATE_FACTOR * ate.rmse + ASYNC_ATE_SLACK_M
    system.shutdown()  # re-raises a failure of any worker thread
    log(f"stereo C: state {trk.state.name}; {len(ts_c)} poses exported for {n} pairs, {int(tracked.sum())} tracked "
        f"while OK; loss events {trk.n_lost_events}; {n / t_track:.3f} fps over the track() calls; unscaled ATE of the "
        f"tracked poses {ate_c.rmse:.6f} m (scale {ate_c.scale:.4f}); bound {ASYNC_ATE_FACTOR} x {ate.rmse:.6f} + "
        f"{ASYNC_ATE_SLACK_M} = {bound_c:.6f} m; describe launches {cnt}")
    if cnt != 2 * n or host != 2 * n:
        fail(f"stereo C: orb_describe ran {cnt} times on the card ({host} by the wrapper) for {n} pairs")
    launches += cnt
    if len(ts_c) / n <= ASYNC_MIN_COVERAGE or not np.all(np.diff(ts_c) > 0) or not np.isfinite(Twc_c).all():
        fail(f"stereo C: {len(ts_c)} of {n} poses exported, or not in order, or not finite")
    if gate_ate and not ate_c.rmse <= bound_c:
        fail(f"stereo C: unscaled ATE of the tracked poses {ate_c.rmse:.6f} m > {bound_c:.6f} m")
    launches += remap_check(dev, scene, Rs[0], ts[0])
    return launches, launches_rgbd, worst, float(ate.rmse)  # part A's unscaled ATE


def render_merge():
    """The scene of tests/test_atlas_merge.py: uint8 frames (the tracker's
    own conversion of the float renders), the blind stretch flat."""
    import numpy as np

    from orbslam3_cpp_fork_tpu_torch.datasets import synthetic

    scene = synthetic.make_ring_scene(seed=11, n_points=900, size_range=(9, 15))
    Rs, ts = synthetic.circle_trajectory(n_frames=MERGE_FRAMES, radius=2.5, total_angle=2.5 * np.pi)
    flat = synthetic.to_u8(np.full((scene.height, scene.width), MERGE_FLAT, np.float32))
    frames = [flat if MERGE_BLIND[0] <= i < MERGE_BLIND[1] else synthetic.to_u8(synthetic.render_frame(scene, R, t))
              for i, (R, t) in enumerate(zip(Rs, ts))]
    return scene, Rs, ts, frames


def merge_tracker(trk):
    """Collapse the RECENTLY_LOST window and the relocalization patience (as
    tests/test_atlas_merge.py does)."""
    trk.cfg.time_recently_lost = MERGE_RECENTLY_LOST_S
    trk.reloc_patience = MERGE_RELOC_PATIENCE


def merge_ms(trk):
    """Host milliseconds of each merge the tracker executed (its `merge`
    span)."""
    return [x * 1e3 for x in trk.timers.samples.get("merge", [])]


def run_merge_sync(dev, scene, frames, ts_gt, orb_params):
    """Part A: the synchronous tracker with loop closing over the scene. At
    the frame whose loop step welds the maps the trajectory is exported (a
    synchronous export changes no state) and its poses tracked while OK are
    scored: the weld's own accuracy, before later corrections."""
    import numpy as np

    from orbslam3_cpp_fork_tpu_torch import convert
    from orbslam3_cpp_fork_tpu_torch.runtime.tracker import Tracker, TrackerConfig
    from orbslam3_cpp_fork_tpu_torch.utils.evaluation import ate_rmse

    K = scene.K
    trk = Tracker(TrackerConfig(
        camera=convert.camera_from_numpy(K[0, 0], K[1, 1], K[0, 2], K[1, 2]), width=scene.width,
        height=scene.height, orb=orb_params, async_mapping=False, enable_loop_closing=True,
    ), dev)
    merge_tracker(trk)
    dead = spy_dead_reckoned(trk)
    read = counted(dev)
    maps_seen, weld, t_weld = 1, None, 0.0
    t0 = time.perf_counter()
    for i, f in enumerate(frames):
        n_maps = trk.atlas.n_maps()
        trk.track(f, i * 0.05)
        maps_seen = max(maps_seen, trk.atlas.n_maps())
        if weld is None and n_maps == 2 and trk.atlas.n_maps() == 1:
            t1 = time.perf_counter()
            ts_w, Twc_w = trk.export_trajectory()
            keep = tracked_mask(ts_w, dead)
            weld = (i, float(ate_rmse(ts_w[keep], Twc_w[keep, :3, 3], np.arange(len(frames)) * 0.05,
                                      ts_gt).rmse_scaled), int(keep.sum()))
            t_weld = time.perf_counter() - t1
    secs = time.perf_counter() - t0 - t_weld
    ts_est, Twc = trk.export_trajectory()
    return trk, maps_seen, ts_est, Twc, read(), secs, merge_ms(trk), dead, weld


def per_map_ate(trk, ts_est, Twc, keep, stamps, ts_gt):
    """The largest scale-aligned ATE RMSE over the maps of the Atlas, each
    map's kept exported poses aligned on their own (a record of a merged-away
    map counts in the map it was welded into, as export_trajectory resolves
    it)."""
    return max([r.rmse_scaled for r in per_map_ates(trk, ts_est, Twc, keep, stamps, ts_gt).values()], default=0.0)


def per_map_ates(trk, ts_est, Twc, keep, stamps, ts_gt):
    """`per_map_ate`'s alignment of each map with at least 10 kept poses:
    {map id: its ATE result}."""
    import numpy as np

    from orbslam3_cpp_fork_tpu_torch.utils.evaluation import ate_rmse

    maps_by_id = {m.map_id: m for m in trk.atlas.maps}
    mids = []
    for _, _, mid, k, _, _ in trk.trajectory:
        while (mid, k) in trk._kf_alias:
            mid, k = trk._kf_alias[(mid, k)]
        m = maps_by_id.get(mid)
        if m is not None and m.kf_valid[k]:
            mids.append(mid)
    mids = np.asarray(mids)
    if len(mids) != len(ts_est):
        fail("per-map ATE: the trajectory records do not match the exported poses")
    out = {}
    for mid in np.unique(mids):
        sel = keep & (mids == mid)
        if sel.sum() >= 10:
            out[int(mid)] = ate_rmse(ts_est[sel], Twc[sel, :3, 3], stamps, ts_gt)
    return out


def atlas_arrays(atlas):
    """Every array field of every map of an Atlas, by name."""
    import numpy as np

    return [{k: v for k, v in vars(m).items() if isinstance(v, np.ndarray)} for m in atlas.maps]


def phase_merge(dev, orb_params, gate_ate):
    """The multi-map Atlas on the card (module docstring, phase 10)."""
    import tempfile

    import numpy as np

    from orbslam3_cpp_fork_tpu_torch.runtime import checkpoint
    from orbslam3_cpp_fork_tpu_torch.utils.evaluation import ate_rmse

    t_phase = time.perf_counter()
    scene, Rs, ts, frames = render_merge()
    n = len(frames)
    stamps = np.arange(n) * 0.05
    launches = 0

    # The fused describe kernel against its plain version on this scene's
    # 640x480 pyramid and on the flat frame, which has no keypoint (not
    # counted: the counts are zeroed before each run below).
    worst = hold_describe(f"merge scene frame 0 ({scene.width}x{scene.height}, {N_FEATURES} features)",
                          *frame_levels(dev, frames[0], orb_params))
    flat_levels = frame_levels(dev, frames[MERGE_BLIND[0]], orb_params)
    if bool(flat_levels[3].any()):
        fail("merge: the flat frame has keypoints")
    worst = max(worst, hold_describe("the merge scene's flat frame (no keypoints)", *flat_levels))

    # Part A: synchronous, twice.
    runs = []
    for r in range(2):
        trk, maps_seen, ts_est, Twc, (cnt, host), secs, ms, dead, weld = run_merge_sync(
            dev, scene, frames, ts, orb_params)
        if cnt != n or host != n:
            fail(f"merge A: orb_describe ran {cnt} times on the card ({host} by the wrapper) for {n} frames")
        launches += cnt
        runs.append((trk, maps_seen, ts_est, Twc, ms, dead, weld))
        log(f"merge A run {r + 1}: {len(ts_est)} poses exported for {n} frames, at most {maps_seen} maps, merges "
            f"{[e for e in trk.events if e['kind'] == 'merge']}, {trk.atlas.n_maps()} map(s) at the end, state "
            f"{trk.state.name}, keyframes {trk.map.n_keyframes()}, landmarks {trk.map.n_landmarks()}; {secs:.2f} s "
            f"({secs / n * 1e3:.1f} ms a frame), merge {', '.join(f'{x:.1f}' for x in ms)} ms on the host clock")
    trk, maps_seen, ts_est, Twc, ms_a, dead, weld = runs[0]
    # ROADMAP R12: a frame whose tracking fails is exported with its failed
    # pose optimization's pose while RECENTLY_LOST, in both implementations;
    # the ATE is gated over the poses tracked while OK and reported over all.
    tracked = tracked_mask(ts_est, dead)
    ate = ate_rmse(ts_est[tracked], Twc[tracked, :3, 3], stamps, ts)
    ate_all = ate_rmse(ts_est, Twc[:, :3, 3], stamps, ts)
    bound = min(max(MERGE_JAX_WELD_ATE_M, MERGE_PORT_WELD_ATE_M) + TOL_LOOP_ATE_M, MERGE_MAX_ATE_M)
    same = Twc.shape == runs[1][3].shape and np.array_equal(Twc, runs[1][3])
    merges = [e for e in trk.events if e["kind"] == "merge"]
    weld_ate = weld[1] if weld is not None else float("nan")
    lost_after_weld = sorted(f for f in dead if weld is not None and f > weld[0])
    log(f"merge A: at the weld (frame {weld and weld[0]}) scale-aligned ATE RMSE of the {weld and weld[2]} poses "
        f"tracked while OK {weld_ate:.6f} m, bound min(max({MERGE_JAX_WELD_ATE_M:.6f}, {MERGE_PORT_WELD_ATE_M:.6f}) "
        f"+ {TOL_LOOP_ATE_M}, {MERGE_MAX_ATE_M}) = {bound:.6f} m; at the end, after the loop and its global BA, of the "
        f"{int(tracked.sum())} poses tracked while OK {ate.rmse_scaled:.6f} m (scale {ate.scale:.4f}; bound "
        f"{MERGE_END_MAX_ATE_M:.6f} m, the CPU spread's largest + {TOL_LOOP_ATE_M}; frames lost after the weld "
        f"{lost_after_weld}), of every exported pose {ate_all.rmse_scaled:.6f} m (RECENTLY_LOST frames "
        f"{sorted(dead)}, ROADMAP R12); the CPU runs of the scene scored at the end: reference "
        f"{MERGE_JAX_ATE_M:.6f} m, port {MERGE_PORT_ATE_M:.6f} m (every exported pose); loops "
        f"{trk.loop_closer.n_loops_closed}; second run bitwise equal to the first: {same}")
    if maps_seen < 2:
        fail("merge A: no second Atlas map after the blind stretch")
    if trk.loop_closer.n_merges < 1 or not merges or merges[0]["src_map"] != 1 or merges[0]["dst_map"] != 0:
        fail(f"merge A: merges {merges} (map 1 welded into map 0 required)")
    if trk.atlas.n_maps() != 1 or trk.state.name != "OK":
        fail(f"merge A: {trk.atlas.n_maps()} maps, state {trk.state.name} at the end (1 map, OK required)")
    if len(ts_est) <= MERGE_MIN_POSES or tracked.sum() <= MERGE_MIN_POSES or not np.isfinite(Twc).all():
        fail(f"merge A: {len(ts_est)} poses exported, {int(tracked.sum())} tracked (> {MERGE_MIN_POSES} finite "
             "required)")
    if not same:
        fail("merge A: the second run's trajectory differs from the first")
    if weld is None or (gate_ate and not weld_ate <= bound):
        fail(f"merge A: scale-aligned ATE at the weld {weld_ate:.6f} m > {bound:.6f} m")
    if gate_ate and not ate.rmse_scaled <= MERGE_END_MAX_ATE_M:
        fail(f"merge A: scale-aligned ATE at the end {ate.rmse_scaled:.6f} m > {MERGE_END_MAX_ATE_M:.6f} m")

    # Part B: the default mode through System (mapping and loop workers, the
    # background global BA; a merge is parked for the track thread).
    system = make_system(dev, scene, orb_params, enable_loop_closing=True)
    trk_b = system.tracker
    if trk_b.worker is None or trk_b.loop_worker is None:
        fail("merge B: the default mode has no workers")
    merge_tracker(trk_b)
    dead = spy_dead_reckoned(trk_b)
    read = counted(dev)
    maps_b = 1
    t0 = time.perf_counter()
    for i, f in enumerate(frames):
        system.track_monocular(f, i * 0.05)
        maps_b = max(maps_b, system.atlas.n_maps())
    t_track = time.perf_counter() - t0
    ts_b, Twc_b = trk_b.export_trajectory()  # flushes every worker (re-raising their failures)
    cnt, host = read()
    system.shutdown()  # re-raises a failure of any worker thread
    tracked = tracked_mask(ts_b, dead)
    ate_b = per_map_ate(trk_b, ts_b, Twc_b, tracked, stamps, ts)
    ate_b_all = ate_rmse(ts_b, Twc_b[:, :3, 3], stamps, ts)
    bound_b = MERGE_END_MAX_ATE_M
    log(f"merge B: at most {maps_b} maps, merges {system.n_merges} executed "
        f"{[e for e in trk_b.events if e['kind'] == 'merge']}, {system.atlas.n_maps()} map(s) at the end, state "
        f"{trk_b.state.name}; {len(ts_b)} poses exported, {int(tracked.sum())} tracked while OK; loss events "
        f"{trk_b.n_lost_events}; {n / t_track:.3f} fps over the track() calls; merge "
        f"{', '.join(f'{x:.1f}' for x in merge_ms(trk_b))} ms; scale-aligned ATE of the tracked poses, the worst "
        f"map's, {ate_b:.6f} m (every exported pose in one alignment {ate_b_all.rmse_scaled:.6f} m); bound "
        f"{bound_b:.6f} m, part A's; describe launches {cnt}")
    if cnt != n or host != n:
        fail(f"merge B: orb_describe ran {cnt} times on the card ({host} by the wrapper) for {n} frames")
    launches += cnt
    if maps_b < 2:
        fail("merge B: no second Atlas map after the blind stretch")
    if not np.all(np.diff(ts_b) > 0) or not np.isfinite(Twc_b).all():
        fail("merge B: the exported poses are not in time order or not finite")
    if system.n_merges < MERGE_ASYNC_REF_MERGES:
        fail(f"merge B: {system.n_merges} merges (>= {MERGE_ASYNC_REF_MERGES}, the reference's fewest, required)")
    if system.n_merges >= 1 and system.atlas.n_maps() != 1:
        fail(f"merge B: {system.atlas.n_maps()} maps after a merge (the poses must share one frame)")
    if gate_ate and not ate_b <= bound_b:
        fail(f"merge B: scale-aligned ATE of the tracked poses {ate_b:.6f} m > {bound_b:.6f} m")

    # Part C: part A's Atlas through a checkpoint into a fresh synchronous
    # System, then localization mode over frames 10-19.
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "atlas.npz")
        extra = {"sensor": "MONOCULAR", "kfdb_seed": trk.kfdb._seed, "kfdb_n_words": trk.kfdb.n_words}
        checkpoint.save_atlas(trk.atlas, path, extra=extra)
        system_c = make_system(dev, scene, orb_params, async_mapping=False, enable_loop_closing=True, load_atlas=path)
    trk_c = system_c.tracker
    saved, loaded = atlas_arrays(trk.atlas), atlas_arrays(trk_c.atlas)
    diff = [k for a, b in zip(saved, loaded) for k in a if not np.array_equal(a[k], b[k])]
    state0 = system_c.get_tracking_state().name
    system_c.activate_localization_mode()
    m_c = trk_c.map
    n_kf0 = m_c.n_keyframes()
    read = counted(dev)
    poses = [(i, system_c.track_monocular(frames[i], float(stamps[i]))) for i in range(*CKPT_FRAMES)]
    cnt, host = read()
    ok = [(i, T) for i, T in poses if T is not None]
    err = float("nan")
    if ok:
        i0, T0 = ok[-1]
        j = int(np.argmin(np.abs(ts_est - stamps[i0])))
        err = float(np.linalg.norm(T0[:3, 3] - np.linalg.inv(Twc[j])[:3, 3]))
    n_c = CKPT_FRAMES[1] - CKPT_FRAMES[0]
    log(f"merge C: {len(saved)} map(s) saved and loaded, differing arrays {diff}; state after the load {state0}; "
        f"poses at frames {[i for i, _ in ok]}; keyframes {n_kf0} -> {m_c.n_keyframes()}; last pose {err:.4f} m "
        f"from the saved trajectory's; describe launches {cnt}")
    system_c.shutdown()
    if diff or len(loaded) != len(saved):
        fail(f"merge C: arrays differ after the round trip: {diff}")
    if state0 != "LOST":
        fail(f"merge C: state {state0} after the load (LOST required)")
    if not ok or m_c.n_keyframes() != n_kf0:
        fail(f"merge C: no pose came back ({len(ok)}) or keyframes were added ({n_kf0} -> {m_c.n_keyframes()})")
    if not err < CKPT_TOL_M:
        fail(f"merge C: relocalized pose {err:.4f} m from the saved trajectory's (< {CKPT_TOL_M} required)")
    if cnt != n_c or host != n_c:
        fail(f"merge C: orb_describe ran {cnt} times on the card ({host} by the wrapper) for {n_c} frames")
    launches += cnt
    secs = time.perf_counter() - t_phase
    log(f"merge: phase {secs:.1f} s for {2 * n + n + n_c} frames ({secs / (3 * n + n_c) * 1e3:.1f} ms a frame on the "
        f"host clock, builds and checks included), part A merge {np.mean(ms_a):.1f} ms; {card_line()}")
    return launches, worst


def bob_state(t):
    """tests/test_vi_tracking_e2e.py's trajectory: a 2 m circle at 0.35 rad/s
    with 0.25 m of vertical bobbing at 3 rad/s (the excitation that makes mono
    scale observable), the camera (= body) looking outward. Returns Rwb, p,
    the world acceleration and the body rates."""
    import numpy as np

    th = VI_OMEGA * t
    c, s = np.cos(th), np.sin(th)
    p = np.array([VI_RADIUS * c, VI_RADIUS * s, VI_BOB_A * np.sin(VI_BOB_W * t)])
    a_w = np.array([-VI_RADIUS * VI_OMEGA**2 * c, -VI_RADIUS * VI_OMEGA**2 * s,
                    -VI_BOB_A * VI_BOB_W**2 * np.sin(VI_BOB_W * t)])
    x_b, z_b = np.array([-s, c, 0.0]), np.array([c, s, 0.0])
    Rwb = np.stack([x_b, np.cross(z_b, x_b), z_b], axis=1)
    return Rwb.astype(np.float32), p.astype(np.float32), a_w, Rwb.T @ np.array([0.0, 0.0, VI_OMEGA])


def bob_imu_rows(t0, t1):
    """Exact IMU rows [t, acc, gyro] over (t0, t1] at VI_IMU_HZ (midpoint
    samples), as tests/test_vi_tracking_e2e.py's `imu_rows`."""
    import numpy as np

    g_w = np.array([0.0, 0.0, -9.81])
    n = int(round((t1 - t0) * VI_IMU_HZ))
    rows = []
    for i in range(n):
        Rwb, _, a_w, w_b = bob_state(t0 + (i + 0.5) * (t1 - t0) / n)
        rows.append(np.concatenate([[t0 + (i + 1) * (t1 - t0) / n], Rwb.T @ (a_w - g_w), w_b]))
    return np.asarray(rows, np.float32)


def bob_camera(t, Tbc=None):
    """The camera's pose (Rwc, twc) at time t on `bob_state`'s body: Rwc =
    Rwb Rbc, twc = twb + Rwb tbc for a body-from-camera `Tbc` (4x4), the
    body's own pose without one."""
    import numpy as np

    Rwb, p = bob_state(t)[:2]
    if Tbc is None:
        return Rwb, p
    T = np.asarray(Tbc, np.float64)
    Rwb64 = Rwb.astype(np.float64)
    return (Rwb64 @ T[:3, :3]).astype(np.float32), (p + Rwb64 @ T[:3, 3]).astype(np.float32)


def render_inertial(width, height, stereo=False, n_frames=None, ring=None, render=True, Tbc=None, seed=5,
                    baseline=STEREO_BASELINE):
    """The scene of tests/test_vi_tracking_e2e.py (make_ring_scene(seed=5),
    or another `seed`, its ring resized by `ring`) at width x height over
    `n_frames` frames at VI_FPS: stamps, ground-truth camera poses
    (`bob_camera` with the rig `Tbc`), uint8 frames (or (left, right) pairs
    of a rig of `baseline` m; None unless `render`) and each frame's IMU
    rows (the body's; None for the first)."""
    import numpy as np

    from orbslam3_cpp_fork_tpu_torch.datasets import synthetic

    scene = synthetic.make_ring_scene(seed=seed, width=width, height=height, **(ring or {}))
    n_frames = VI_FRAMES if n_frames is None else n_frames
    stamps = np.arange(n_frames) / VI_FPS
    Rs, ts = (np.stack(x) for x in zip(*[bob_camera(t, Tbc) for t in stamps]))

    def img(R, t):
        return synthetic.to_u8(synthetic.render_frame(scene, R, t))

    frames = [(img(R, t), img(*synthetic.stereo_right_pose(R, t, baseline))) if stereo else img(R, t)
              for R, t in zip(Rs, ts)] if render else None
    rows = [None] + [bob_imu_rows(stamps[i - 1], stamps[i]) for i in range(1, n_frames)]
    return scene, stamps, Rs, ts, frames, rows


def vi_config(scene, orb_params, sensor, **kw):
    """tests/test_vi_tracking_e2e.py's TrackerConfig: the default ImuSettings
    at 200 Hz, its shortened ladder, loop closing off, synchronous."""
    from orbslam3_cpp_fork_tpu_torch import convert
    from orbslam3_cpp_fork_tpu_torch.runtime.tracker import ImuSettings, TrackerConfig

    K = scene.K
    extra = dict(bf=STEREO_BASELINE * float(K[0, 0]), th_depth=STEREO_BASELINE * 40.0) if sensor.name != "IMU_MONOCULAR" else {}
    return TrackerConfig(
        camera=convert.camera_from_numpy(K[0, 0], K[1, 1], K[0, 2], K[1, 2]), width=scene.width,
        height=scene.height, sensor=sensor, orb=orb_params, imu=ImuSettings(freq=VI_IMU_HZ), **VI_LADDER,
        enable_loop_closing=False, async_mapping=False, **extra, **kw,
    )


def render_inertial_long(width=VIL_SIZE[0], height=VIL_SIZE[1], n_frames=VIL_FRAMES, render=True):
    """The inertial long phase's sequence: `render_inertial` over two laps
    with the camera on EuRoC's rig (EUROC_T_B_C1)."""
    return render_inertial(width, height, n_frames=n_frames, render=render, Tbc=EUROC_T_B_C1, seed=VIL_SEED)


def scale_branch(s, applied):
    """The branch a ScaleRefinement call took, from the scale it estimated
    (None: the chain was too short to solve) and whether it re-aligned the
    map (LocalMapping::ScaleRefinement's three outcomes)."""
    import math

    if s is None:
        return "skipped"
    if not math.isfinite(s) or s < 0.1:
        return "rejected"
    return "applied" if applied else "no change needed"


def _host(x):
    import numpy as np

    return x.detach().cpu().numpy() if hasattr(x, "detach") else np.asarray(x)


def record_inertial_path(trk, vi, pose_graph, solver):
    """Wrap the inertial path's stages on a tracker instance (the port's or
    the reference's: the names are the same; `vi` is its optim.inertial
    module, `pose_graph` the module its loop closer solves the essential
    graph with and `solver` that function's name) and return the lists each
    call appends to:
    - "fiba": every FullInertialBA (keyframe, its frame, priors, iterations,
      host ms, whether a loop's global BA ran it);
    - "refine": every ScaleRefinement call (frame, seconds since the first
      inertial keyframe, the scale it estimated, its branch, host ms);
    - "graph": every essential graph (keyframe, mode, the largest move of a
      keyframe's gravity direction in its body frame, Rwb^T e_z, and of a
      vertex scale across it, host ms);
    - "gba": every global BA after a loop (keyframe, "inertial" or
      "visual", "inline" or "background", host ms of the request);
    - "init": every IMU initialization (keyframe, its frame, fix_scale,
      whether it took, the scale and the gravity rotation Ryw it applied to
      the map, the largest change of a keyframe centre's or landmark's
      distance from the world origin across that re-alignment, host ms);
    - "bg": every background inertial global BA (keyframe, its frame).
    A FullInertialBA's and a background inertial global BA's entry also
    holds its whole-chain problem: keyframes optimized, route ("dense" up
    to vi_full_kf_cap keyframes, else "sparse"), observation rows and
    stereo rows."""
    import threading

    import numpy as np

    from orbslam3_cpp_fork_tpu_torch.optim.pose_graph import FREE_DIMS

    rec = dict(fiba=[], refine=[], graph=[], gba=[], init=[], bg=[])
    in_gba, builds = [False], threading.local()  # builds.got: this thread's recorded whole-chain builds
    Rbc = np.asarray(trk.Rbc, np.float64) if getattr(trk, "Rbc", None) is not None else np.eye(3)

    def wrap(obj, name, fn):
        real = getattr(obj, name)
        setattr(obj, name, lambda *a, **kw: fn(real, *a, **kw))

    def build(real, opt_kfs, *a, **kw):
        out = real(opt_kfs, *a, **kw)
        if getattr(builds, "got", None) is not None:
            n = len(dict.fromkeys(int(x) for x in opt_kfs))
            v = st = np.zeros(0, bool)
            if out is not None:
                v = _host(out[0].obs_valid).astype(bool)
                st = v & _host(out[0].obs_stereo).astype(bool)
            builds.got.append(dict(kfs=n, route="sparse" if n > trk.cfg.vi_full_kf_cap else "dense",
                                   rows=int(v.sum()), stereo_rows=int(st.sum())))
        return out

    def with_build(real, *a, **kw):
        """Call `real` and return (its output, its first whole-chain build's
        stats or {})."""
        builds.got = got = []
        try:
            out = real(*a, **kw)
        finally:
            builds.got = None
        return out, (got[0] if got else {})

    def fiba(real, k, prior_g, prior_a, iters=15):
        t0 = time.perf_counter()
        out, prob = with_build(real, k, prior_g, prior_a, iters)
        rec["fiba"].append(dict(kf=int(k), frame=int(trk.map.kf_frame_id[k]), prior_g=float(prior_g),
                                prior_a=float(prior_a), iters=int(iters), loop_gba=in_gba[0],
                                ms=1e3 * (time.perf_counter() - t0), **prob))
        return out

    def background(real, k):
        out, prob = with_build(real, k)
        rec["bg"].append(dict(kf=int(k), frame=int(trk.map.kf_frame_id[k]), **prob))
        return out

    def init(real, frame, k, prior_g, prior_a, fix_scale):
        m, seen = trk.map, []
        real_apply = m.apply_gravity_scale

        def apply(Ryw, s, *a, **kw):
            def dists():
                c = -np.einsum("kji,kj->ki", m.kf_R[m.kf_valid], m.kf_t[m.kf_valid])
                return np.concatenate([np.linalg.norm(c, axis=1), np.linalg.norm(m.lm_pos[m.lm_valid], axis=1)])

            d0 = dists()
            out = real_apply(Ryw, s, *a, **kw)
            seen.append((float(s), float(np.abs(dists() - d0).max()) if len(d0) else 0.0, np.asarray(Ryw).tolist()))
            return out

        t0 = time.perf_counter()
        m.apply_gravity_scale = apply
        try:
            ok = real(frame, k, prior_g, prior_a, fix_scale)
        finally:
            del m.apply_gravity_scale
        rec["init"].append(dict(kf=int(k), frame=int(frame.frame_id), fix_scale=bool(fix_scale), ok=bool(ok),
                                s=seen[0][0] if seen else None, rescaled=seen[0][1] if seen else None,
                                Ryw=seen[0][2] if seen else None,
                                ms=1e3 * (time.perf_counter() - t0)))
        return ok

    def refine(real, frame, k):
        got, real_init = [], vi.inertial_init

        def init(*a, **kw):
            res = real_init(*a, **kw)
            got.append(float(_host(res.scale)))
            return res

        big0, t0 = trk.map.big_change_idx, time.perf_counter()
        vi.inertial_init = init
        try:
            out = real(frame, k)
        finally:
            vi.inertial_init = real_init
        s = got[0] if got else None
        rec["refine"].append(dict(frame=int(frame.frame_id), t=float(frame.timestamp - trk.map.imu_t0), s=s,
                                  branch=scale_branch(s, trk.map.big_change_idx != big0),
                                  ms=1e3 * (time.perf_counter() - t0)))
        return out

    def graph(real, k, c, *a):
        m = trk.loop_closer.m
        seen, real_solve = [], getattr(pose_graph, solver)

        def solve(*sa, **skw):
            out = real_solve(*sa, **skw)
            s_out = out.s if hasattr(out, "s") else out[0]
            seen.append((_host(sa[-1] if "free_dims" not in skw else skw["free_dims"]), _host(sa[0]), _host(s_out)))
            return out

        live = m.kf_valid.copy()
        g0 = m.kf_R[:, :, 2].astype(np.float64) @ Rbc.T  # Rwb^T e_z = Rbc Rcw e_z
        t0 = time.perf_counter()
        setattr(pose_graph, solver, solve)
        try:
            out = real(k, c, *a)
        finally:
            setattr(pose_graph, solver, real_solve)
        ms = 1e3 * (time.perf_counter() - t0)
        g1 = m.kf_R[:, :, 2].astype(np.float64) @ Rbc.T
        both = live & m.kf_valid
        mode = None
        if seen:
            dims = np.asarray(seen[0][0], np.float64)
            mode = next((name for name, d in FREE_DIMS.items() if np.array_equal(d, dims)), "other")
        rec["graph"].append(dict(kf=int(k), match=int(c), mode=mode, ms=ms,
                                 gravity_moved=float(np.abs(g1[both] - g0[both]).max()) if both.any() else 0.0,
                                 scale_moved=float(np.abs(seen[0][2][:len(seen[0][1])] - seen[0][1]).max())
                                 if seen else 0.0))
        return out

    def gba_request(real, k, c):
        kinds = []
        wraps = [(name, getattr(trk, name)) for name in ("_full_inertial_ba", "_vi_global_ba_background", "_global_ba",
                                                          "_gba_gather")]
        for name, fn in wraps:
            setattr(trk, name, lambda *a, _fn=fn, _n=name, **kw: (kinds.append(_n), _fn(*a, **kw))[1])
        in_gba[0], t0 = True, time.perf_counter()
        try:
            out = real(k, c)
        finally:
            in_gba[0] = False
            for name, fn in wraps:
                setattr(trk, name, fn)
        kind = "inertial" if {"_full_inertial_ba", "_vi_global_ba_background"} & set(kinds) else \
            "visual" if kinds else "none"
        rec["gba"].append(dict(kf=int(k), kind=kind, ms=1e3 * (time.perf_counter() - t0),
                               where="background" if trk.worker is not None else "inline"))
        return out

    wrap(trk, "_build_vi_problem", build)
    wrap(trk, "_full_inertial_ba", fiba)
    wrap(trk, "_vi_global_ba_background", background)
    wrap(trk, "_initialize_imu", init)
    wrap(trk, "_scale_refinement", refine)
    if trk.loop_closer is not None:
        wrap(trk.loop_closer, "_essential_graph", graph)
        if trk.loop_closer.global_ba_hook is not None:
            wrap(trk.loop_closer, "global_ba_hook", gba_request)
    return rec


def inertial_long_config(scene, n_features=VIL_FEATURES, **kw):
    """The inertial long phase's TrackerConfig: IMU_MONOCULAR with EuRoC's
    rig at 200 Hz, the reference's default ladder (the TrackerConfig
    defaults), loop closing and the global BA on, synchronous."""
    import numpy as np

    from orbslam3_cpp_fork_tpu_torch import convert
    from orbslam3_cpp_fork_tpu_torch.ops.orb import OrbParams
    from orbslam3_cpp_fork_tpu_torch.runtime.tracker import ImuSettings, Sensor, TrackerConfig

    K = scene.K
    return TrackerConfig(
        camera=convert.camera_from_numpy(K[0, 0], K[1, 1], K[0, 2], K[1, 2]), width=scene.width,
        height=scene.height, sensor=Sensor.IMU_MONOCULAR, orb=OrbParams(n_features=n_features),
        imu=ImuSettings(freq=VI_IMU_HZ, Tbc=np.asarray(EUROC_T_B_C1, np.float32)), enable_loop_closing=True,
        async_mapping=False, **kw,
    )


def render_stereo_inertial_long(width=SIL_SIZE[0], height=SIL_SIZE[1], n_frames=SIL_FRAMES, render=True):
    """The stereo inertial long phase's sequence: the inertial long scene's
    trajectory and rig (EUROC_T_B_C1) as rectified pairs of EuRoC's
    baseline, on the ring resized to a room (SIL_RING)."""
    return render_inertial(width, height, stereo=True, n_frames=n_frames, ring=SIL_RING, render=render,
                           Tbc=EUROC_T_B_C1, seed=SIL_SEED, baseline=SIL_BASELINE)


def stereo_inertial_long_config(scene, n_features=SIL_FEATURES, **kw):
    """The stereo inertial long phase's TrackerConfig: IMU_STEREO with
    EuRoC's rig at 200 Hz, bf = SIL_BASELINE x fx, th_depth = SIL_TH_DEPTH
    baselines, the reference's default ladder, loop closing and the global
    BA on, synchronous."""
    import numpy as np

    from orbslam3_cpp_fork_tpu_torch import convert
    from orbslam3_cpp_fork_tpu_torch.ops.orb import OrbParams
    from orbslam3_cpp_fork_tpu_torch.runtime.tracker import ImuSettings, Sensor, TrackerConfig

    K = scene.K
    return TrackerConfig(
        camera=convert.camera_from_numpy(K[0, 0], K[1, 1], K[0, 2], K[1, 2]), width=scene.width,
        height=scene.height, sensor=Sensor.IMU_STEREO, orb=OrbParams(n_features=n_features),
        imu=ImuSettings(freq=VI_IMU_HZ, Tbc=np.asarray(EUROC_T_B_C1, np.float32)),
        bf=SIL_BASELINE * float(K[0, 0]), th_depth=SIL_BASELINE * SIL_TH_DEPTH, enable_loop_closing=True,
        async_mapping=False, **kw,
    )


def vim_blind(i):
    """Whether frame i of the inertial merge scene is flat."""
    return any(a <= i < b for a, b in VIM_BLIND)


def render_inertial_merge(width=VIL_SIZE[0], height=VIL_SIZE[1], n_frames=VIM_FRAMES, render=True):
    """The inertial merge phase's sequence: `render_inertial_long` over
    `n_frames` with the frames of VIM_BLIND flat (a covered lens; the IMU
    rows go on)."""
    import numpy as np

    from orbslam3_cpp_fork_tpu_torch.datasets import synthetic

    scene, stamps, Rs, ts, frames, rows = render_inertial_long(width, height, n_frames, render)
    if frames is not None:
        flat = synthetic.to_u8(np.full((height, width), VIM_FLAT, np.float32))
        frames = [flat if vim_blind(i) else f for i, f in enumerate(frames)]
    return scene, stamps, Rs, ts, frames, rows


def tilt_deg(a, b):
    """The angles (degrees) between directions a and b (..., 3), from the
    chord of the unit vectors (arccos of their dot product loses the small
    angles of float32 inputs)."""
    import numpy as np

    a, b = (np.asarray(x, np.float64) for x in (a, b))
    a, b = (x / np.linalg.norm(x, axis=-1, keepdims=True) for x in (a, b))
    return np.degrees(2.0 * np.arcsin(np.clip(np.linalg.norm(a - b, axis=-1) / 2.0, 0.0, 1.0)))


def weld_tilt_deg(RM):
    """The angle (degrees) between RM e_z and e_z: how far a weld tilts the
    welded map's gravity-aligned world."""
    import numpy as np

    return float(tilt_deg(np.asarray(RM, np.float64)[:, 2], [0.0, 0.0, 1.0]))


def record_atlas_path(trk):
    """Wrap the Atlas path on a tracker instance (the port's or the
    reference's: the names are the same) and return the lists each call
    appends to:
    - "spawn": every `_spawn_or_reset_map` call: its branch ("spawn" keeps
      the active map, "reset" discards one of fewer than 10 keyframes), the
      frame, the map's id, keyframes and IMU stage before, and after it the
      active map's id and keyframes and the database rows left in the old
      map's namespace; a reset also lists the frames recorded in the map it
      discards (ROADMAP R24);
    - "weld": every `Atlas.merge_into`: the frame, the source and destination
      ids, the keyframes moved, the weld (sM, RM, tM) and its tilt."""
    import numpy as np

    rec = dict(spawn=[], weld=[])
    real_sor, atlas = trk._spawn_or_reset_map, trk.atlas
    real_merge = atlas.merge_into
    K = trk.cfg.map_cfg.max_keyframes

    def spawn_or_reset():
        m = trk.map
        r = dict(frame=int(trk.frame_id), kind="reset" if m.n_keyframes() < VIM_KEEP_MIN_KFS else "spawn",
                 map_id=int(m.map_id), kfs=int(m.n_keyframes()), stage=int(m.imu_stage))
        if r["kind"] == "reset":
            # ROADMAP R24: these frames' records name the discarded map's
            # slots, which the reset map reuses under the same id.
            r["orphans"] = [int(f) for f, _, mid, *_ in trk.trajectory if mid == r["map_id"]]
        out = real_sor()
        ns = r["map_id"] % 16
        r.update(active_id=int(trk.map.map_id), active_kfs=int(trk.map.n_keyframes()),
                 rows_left=int(np.asarray(trk.kfdb.present[ns * K:(ns + 1) * K]).sum()), maps=int(atlas.n_maps()))
        rec["spawn"].append(r)
        return out

    def merge_into(dst_idx, src_idx, M):
        s, R, t = M
        rec["weld"].append(dict(frame=int(trk.frame_id), src=int(atlas.maps[src_idx].map_id),
                                dst=int(atlas.maps[dst_idx].map_id), kfs=int(atlas.maps[src_idx].n_keyframes()),
                                s=float(s), R=np.array(R, np.float64).tolist(), t=np.array(t, np.float64).tolist(),
                                tilt_deg=weld_tilt_deg(R)))
        return real_merge(dst_idx, src_idx, M)

    trk._spawn_or_reset_map = spawn_or_reset
    atlas.merge_into = merge_into
    return rec


def graph_captures(trk):
    """CUDA graphs the port's tracker has captured (the VI pose
    optimizations' and the preintegration's `GraphedCall`s: one per input
    shape each)."""
    calls = [*trk._vi_pose_calls.values(), trk._preint_call]
    return sum(len(c._graphs) for c in calls if c is not None)


def drive_inertial_merge(trk, frames, stamps, rows, ts, on_frame=None):
    """Part A's run of the inertial merge scene (the port's or the
    reference's tracker, `record_inertial_path` already on it): every frame
    tracked, the Atlas path recorded (`record_atlas_path`), the trajectory
    exported and scored at the weld's frame (`vim_ate`; a synchronous
    export changes no state). Returns a report: the spawns and resets, the
    welds, each map's IMU stages by frame, keyframe frames and imu_t0 (a
    reset map's start over), frames tracked outside the blind stretches,
    maps seen, the weld's ATE, host ms a frame, the dead-reckoned frames and
    the seconds. `on_frame(i)` is called after each frame."""
    atlas_rec = record_atlas_path(trk)
    dead = spy_dead_reckoned(trk)
    stages, kf_frames, t0s, ms = {}, {}, {}, []
    maps_seen, tracked, weld, t_weld = 1, 0, None, 0.0
    t0 = time.perf_counter()
    for i, f in enumerate(frames):
        n_maps, n_kf, mid = trk.atlas.n_maps(), trk.n_kf_inserted, trk.map.map_id
        t1 = time.perf_counter()
        T = trk.track(f, float(stamps[i]), imu=rows[i])
        ms.append(1e3 * (time.perf_counter() - t1))
        m = trk.map
        maps_seen = max(maps_seen, trk.atlas.n_maps())
        tracked += T is not None and trk.state.name == "OK" and not vim_blind(i)
        if any(r["frame"] == i and r["kind"] == "reset" for r in atlas_rec["spawn"]):
            for d in (stages, kf_frames, t0s):  # the reset map starts over
                d.pop(int(m.map_id), None)
        stages.setdefault(int(m.map_id), {}).setdefault(int(m.imu_stage), i)
        if m.imu_t0 >= 0:
            t0s.setdefault(int(m.map_id), float(m.imu_t0))
        if trk.n_kf_inserted > n_kf and m.map_id == mid:
            kf_frames.setdefault(int(m.map_id), []).append(i)
        if weld is None and n_maps > 1 and trk.atlas.n_maps() < n_maps:
            t2 = time.perf_counter()
            weld = dict(frame=i, **vim_ate(trk, atlas_rec["spawn"], dead, stamps, ts))
            t_weld = time.perf_counter() - t2
        if on_frame is not None:
            on_frame(i)
    secs = time.perf_counter() - t0 - t_weld
    n_out = sum(not vim_blind(i) for i in range(len(frames)))
    return dict(spawn=atlas_rec["spawn"], welds=atlas_rec["weld"], stages=stages, kf_frames=kf_frames, imu_t0=t0s,
                tracked=tracked, n_outside=n_out, maps_seen=maps_seen, weld=weld, ms=ms, dead=dead, seconds=secs)


def vim_ate(trk, spawns, dead, stamps, ts):
    """Scale-aligned ATE of a tracker's exported poses: "ate" over the
    poses tracked while OK in a map that still holds them, "ate_all" over
    every pose tracked while OK, with the frames a reset discarded (ROADMAP
    R24: their records resolve to the reset map's keyframes in the same
    slots) reported apart; their scales and counts, and the plane normal's
    |n_z| of the first set's centres."""
    import numpy as np

    from orbslam3_cpp_fork_tpu_torch.utils.evaluation import ate_rmse

    ts_est, Twc = trk.export_trajectory()
    orphans = {f for r in spawns for f in r.get("orphans", ())}
    fids = np.asarray([int(round(t * VI_FPS)) for t in ts_est])
    tracked = np.asarray([f not in dead for f in fids], bool)
    keep = tracked & np.asarray([f not in orphans for f in fids], bool)
    a, b = (ate_rmse(ts_est[x], Twc[x, :3, 3], stamps, ts) for x in (keep, tracked))
    pos = Twc[keep, :3, 3] - Twc[keep, :3, 3].mean(0)
    return dict(ate=float(a.rmse_scaled), scale=float(a.scale), n=int(keep.sum()), ate_all=float(b.rmse_scaled),
                n_all=int(tracked.sum()), orphans=sorted(orphans), n_z=abs(float(np.linalg.svd(pos)[2][2][2])))


def vim_viba2_keyframes(report, ref_offset):
    """How many of the last map's keyframes lie between its VIBA2 frame and
    the frame `ref_offset` frames after its first keyframe (imu_t0): the
    reference's CPU offset laid on this run. (map id, VIBA2 frame, imu_t0
    frame, keyframes apart; None where a stage was not reached.)"""
    welds = report["welds"]
    mid = welds[0]["src"] if welds else max(report["stages"], default=None)
    if mid is None or mid not in report["kf_frames"] or mid not in report["imu_t0"]:
        return mid, None, None, None
    kfs, viba2 = report["kf_frames"][mid], report["stages"][mid].get(3)
    f0 = int(round(report["imu_t0"][mid] * VI_FPS))
    ref_at = next((j for j, f in enumerate(kfs) if f >= f0 + ref_offset), len(kfs))
    return mid, viba2, f0, abs(kfs.index(viba2) - ref_at) if viba2 in kfs else None


class PreintCount:
    """Counts the preintegration calls and measurement rows of a run, and
    their host time (the enqueue of their launches): those of the frame path
    (`Tracker._preintegrate_rows`, a CUDA graph replay each on the card) and
    the eager ones (`ops.imu.preintegrate` called directly: the keyframes'
    re-integrations)."""

    def __init__(self):
        from orbslam3_cpp_fork_tpu_torch.ops import imu
        from orbslam3_cpp_fork_tpu_torch.runtime.tracker import Tracker

        self.saved = [(imu, "preintegrate", imu.preintegrate), (Tracker, "_preintegrate_rows", Tracker._preintegrate_rows)]
        self.n = {"frame": [0, 0, 0.0], "eager": [0, 0, 0.0]}  # calls, rows, seconds
        depth = [0]

        def wrap(kind, fn, rows_of):
            def counted(*a, **kw):
                depth[0] += 1
                t0 = time.perf_counter()
                try:
                    return fn(*a, **kw)
                finally:
                    depth[0] -= 1
                    if depth[0] == 0:  # a graph's capture calls preintegrate inside the frame path
                        c = self.n[kind]
                        c[0] += 1
                        c[1] += rows_of(*a)
                        c[2] += time.perf_counter() - t0
            return counted

        imu.preintegrate = wrap("eager", imu.preintegrate, lambda acc, *a: int(acc.shape[-2]))
        Tracker._preintegrate_rows = wrap("frame", Tracker._preintegrate_rows,
                                          lambda trk, rows, *a: 0 if rows is None else len(rows))

    def close(self):
        for owner, name, fn in self.saved:
            setattr(owner, name, fn)


def preint_launches(dev):
    """Kernel launches of one preintegration on the card: per call and per
    measurement row, fitted from calls of 1 and 21 rows (torch.profiler)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from orbslam3_cpp_fork_tpu_torch.ops import imu

    calib = imu.ImuCalib.create(1.7e-4, 2e-3, 1.9e-5, 3e-3, VI_IMU_HZ, device=dev)
    z = torch.zeros(3, device=dev)
    counts = {}
    for n in (1, 21):
        rows = torch.rand((n, 7), device=dev)
        imu.preintegrate(rows[:, 1:4], rows[:, 4:7], rows[:, 0], calib, z, z)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            imu.preintegrate(rows[:, 1:4], rows[:, 4:7], rows[:, 0], calib, z, z)
            torch.cuda.synchronize()
        counts[n] = sum(e.count for e in prof.key_averages()
                        if e.device_type == DeviceType.CUDA and not e.key.startswith(("Memcpy", "Memset")))
    per_row = (counts[21] - counts[1]) / 20.0
    return counts[1] - per_row, per_row


def vi_report(name, trk, poses, stamps, Rs, ts, secs, dead=None):
    """Stages reached and when, frames tracked, ATE and the gravity normal of
    one inertial run; returns (ate result, |n_z|, exported stamps, Twc)."""
    import numpy as np

    from orbslam3_cpp_fork_tpu_torch.utils.evaluation import ate_rmse

    ts_est, Twc = trk.export_trajectory()
    if len(ts_est) < 3:
        fail(f"{name}: {len(ts_est)} poses exported")
    keep = np.ones(len(ts_est), bool)
    if dead is not None:
        keep = np.asarray([int(round(t * VI_FPS)) not in dead for t in ts_est], bool)
    ate = ate_rmse(ts_est[keep], Twc[keep, :3, 3], stamps, ts)
    pos = Twc[:, :3, 3] - Twc[:, :3, 3].mean(0)
    n_z = abs(float(np.linalg.svd(pos)[2][2][2])) if len(pos) >= 3 else 0.0
    spans = trk.timers.summary()
    vi_ba = spans.get("map_local_vi_ba", {})
    log(f"{name}: state {trk.state.name}, IMU stage {trk.map.imu_stage}, tracked {sum(T is not None for T in poses)}"
        f"/{len(poses)}, keyframes {trk.map.n_keyframes()}; {secs:.2f} s, {1e3 * secs / len(poses):.1f} ms a frame "
        f"(host clock); local VI BA {vi_ba.get('count', 0)} calls, mean {vi_ba.get('mean_ms', 0.0):.1f} ms; "
        f"ATE {ate.rmse:.6f} m unscaled, {ate.rmse_scaled:.6f} m scale-aligned (scale {ate.scale:.4f}) over "
        f"{ate.n_pairs} poses; gravity normal |n_z| {n_z:.4f}")
    return ate, n_z, ts_est, Twc


def run_vi_sync(dev, scene, frames, rows, stamps, orb_params, sensor):
    """One synchronous inertial run over `frames`; the stages reached and the
    frame each was reached at, the poses, the describe counts and the
    seconds."""
    from orbslam3_cpp_fork_tpu_torch.runtime.tracker import Tracker

    trk = Tracker(vi_config(scene, orb_params, sensor), dev)
    read = counted(dev)
    stages, poses = {}, []
    t0 = time.perf_counter()
    for i, f in enumerate(frames):
        if sensor.name == "IMU_STEREO":
            poses.append(trk.track_stereo(f[0], f[1], float(stamps[i]), imu=rows[i]))
        else:
            poses.append(trk.track(f, float(stamps[i]), imu=rows[i]))
        stages.setdefault(int(trk.map.imu_stage), i)
    return trk, stages, poses, read(), time.perf_counter() - t0


LOOP_PROBE_SCALES = (0.366, 2.73)  # the loop scale one card run closed the loop scene at, and its inverse


def loop_scale_probe(dev, orb_params):
    """Loop A once, then loop B plain and with its loop's Sim(3) moved along
    the direction its reprojections cannot see, (s, R, t) -> (f s, R, f t),
    to each of LOOP_PROBE_SCALES: the exported poses tracked while OK must
    stay within loop B's bound whatever scale the loop takes (ROADMAP R25,
    R26). Prints one JSON line a run; gates nothing."""
    import numpy as np

    from orbslam3_cpp_fork_tpu_torch.utils.evaluation import align_umeyama, ate_rmse

    scene, Rs, ts, frames = render_loop()
    stamps = np.arange(len(frames)) * 0.05
    trk, ok, ts_est, Twc, _, secs = run_loop_sync(dev, scene, frames, orb_params)
    ate = ate_rmse(ts_est, Twc[:, :3, 3], stamps, ts)
    bound = ASYNC_ATE_FACTOR * ate.rmse_scaled + ASYNC_ATE_SLACK_M
    log(json.dumps(dict(run="loop A", ate=ate.rmse_scaled, tracked=int(ok.sum()), loops=[
        (e["kf"], e["match"], e["scale"]) for e in trk.loop_closer.events if e["kind"] == "loop"])))
    for target in (None, *LOOP_PROBE_SCALES):
        system = make_system(dev, scene, orb_params, enable_loop_closing=True)
        trk = system.tracker
        lc = trk.loop_closer
        dead = spy_dead_reckoned(trk)
        if target is not None:
            correct = lc._correct_loop

            def forced(k, c, s, R, t, target=target, correct=correct):
                f = target / s
                return correct(k, c, f * s, R, f * np.asarray(t))

            lc._correct_loop = forced
        t0 = time.perf_counter()
        for i, f in enumerate(frames):
            system.track_monocular(f, i * 0.05)
        ts_b, Twc_b = trk.export_trajectory()
        tracked = tracked_mask(ts_b, dead)
        ate_b = ate_rmse(ts_b[tracked], Twc_b[tracked, :3, 3], stamps, ts)
        m = trk.map
        kfs = np.nonzero(m.kf_valid)[0]
        C = np.stack([-m.kf_R[k].T @ m.kf_t[k] for k in kfs])
        G = ts[m.kf_frame_id[kfs]]
        s_, R_, t_ = align_umeyama(C, G, True)
        kf_ate = float(np.sqrt(np.mean(np.sum((s_ * C @ R_.T + t_ - G) ** 2, 1))))
        log(json.dumps(dict(run="loop B", loop_scale=target, ate_tracked=ate_b.rmse_scaled, bound=bound,
                            tracked=int(tracked.sum()), exported=len(ts_b), keyframe_ate=kf_ate,
                            loss_events=trk.n_lost_events, secs=time.perf_counter() - t0, loops=[
                                (e["kf"], e["kf_frame"], e["match"], e["scale"]) for e in lc.events
                                if e["kind"] == "loop"])))
        system.shutdown()


def phase_inertial(dev, orb_params, gate_ate):
    """The inertial slice on the card (module docstring, phase 11)."""
    import numpy as np

    from orbslam3_cpp_fork_tpu_torch.runtime.tracker import Sensor
    from orbslam3_cpp_fork_tpu_torch.utils.settings import ImuSettings

    launches = 0
    scene, stamps, Rs, ts, frames, rows = render_inertial(*VI_MONO_SIZE)
    n = len(frames)
    worst = hold_describe(f"the inertial scene ({VI_MONO_SIZE[0]}x{VI_MONO_SIZE[1]}, {N_FEATURES} features)",
                          *frame_levels(dev, frames[0], orb_params))

    # Part A: IMU_MONOCULAR, synchronous, twice.
    count = PreintCount()
    try:
        trk, stages, poses, (cnt, host), secs = run_vi_sync(dev, scene, frames, rows, stamps, orb_params,
                                                            Sensor.IMU_MONOCULAR)
        pre = {k: (c / n, r / n, 1e3 * t / n) for k, (c, r, t) in count.n.items()}
    finally:
        count.close()
    if cnt != n or host != n:
        fail(f"inertial A: orb_describe ran {cnt} times on the card ({host} by the wrapper) for {n} frames")
    launches += cnt
    m = VI_RERUN_FRAMES
    _, stages2, poses2, (cnt, host), secs2 = run_vi_sync(dev, scene, frames[:m], rows[:m], stamps[:m], orb_params,
                                                        Sensor.IMU_MONOCULAR)
    if cnt != m or host != m:
        fail(f"inertial A: orb_describe ran {cnt} times on the card ({host} by the wrapper) for {m} frames")
    launches += cnt
    log(f"inertial A: IMU stages reached at frames {stages}; the rerun of the first {m} frames at {stages2} "
        f"({secs2:.2f} s)")
    ate, n_z, ts_est, Twc = vi_report("inertial A (IMU_MONOCULAR, synchronous)", trk, poses, stamps, Rs, ts, secs)
    per_call, per_row = preint_launches(dev)
    (fc, fr, fms), (ec, er, ems) = pre["frame"], pre["eager"]
    log(f"inertial A: preintegration a frame: {fc:.2f} calls of the frame path ({fr:.1f} rows, {fms:.1f} ms of host "
        f"time; each one CUDA graph replay) and {ec:.2f} eager calls ({er:.1f} rows, {ems:.1f} ms: the keyframes' "
        f"re-integrations); one call is {per_call:.1f} + {per_row:.1f} a row kernels (torch.profiler), so "
        f"~{(fc + ec) * per_call + (fr + er) * per_row:.0f} kernels a frame (ROADMAP X7)")
    same = all((a is None and b is None) or (a is not None and b is not None and np.array_equal(a, b))
               for a, b in zip(poses[:m], poses2))
    bound = min(max(VI_JAX_ATE_M, VI_PORT_ATE_M) + TOL_LOOP_ATE_M, VI_MAX_ATE_M)
    log(f"inertial A: bound min(max({VI_JAX_ATE_M:.6f}, {VI_PORT_ATE_M:.6f}) + {TOL_LOOP_ATE_M}, {VI_MAX_ATE_M}) = "
        f"{bound:.6f} m; the rerun's poses bitwise equal to the first run's: {same}")
    tracked = sum(T is not None for T in poses)
    if trk.map.imu_stage < 1:
        fail(f"inertial A: the IMU never initialized (stages {stages})")
    if trk.state.name != "OK" or tracked <= VI_MIN_TRACKED:
        fail(f"inertial A: state {trk.state.name}, {tracked} of {n} tracked (> {VI_MIN_TRACKED} required)")
    if not abs(ate.scale - 1.0) < VI_SCALE_TOL:
        fail(f"inertial A: scale {ate.scale:.4f} (|scale - 1| < {VI_SCALE_TOL} required)")
    if gate_ate and not ate.rmse_scaled <= bound:
        fail(f"inertial A: scale-aligned ATE {ate.rmse_scaled:.6f} m > {bound:.6f} m")
    if not n_z > VI_GRAVITY_NZ:
        fail(f"inertial A: the trajectory's plane normal |n_z| {n_z:.4f} (> {VI_GRAVITY_NZ} required)")
    if not same:
        fail(f"inertial A: the rerun's poses of the first {m} frames differ from the first run's")

    # Part B: the default mode through System (mapping worker, the ladder on
    # the worker against shim frames, loop closing off).
    imu = ImuSettings(noise_gyro=1.7e-4, noise_acc=2e-3, walk_gyro=1.9e-5, walk_acc=3e-3, frequency=VI_IMU_HZ,
                      Tbc=np.eye(4, dtype=np.float32))
    system = make_system(dev, scene, orb_params, sensor=Sensor.IMU_MONOCULAR, imu=imu)
    trk_b = system.tracker
    if trk_b.worker is None:
        fail("inertial B: the default mode has no mapping worker")
    dead = spy_dead_reckoned(trk_b)
    n = VI_ASYNC_FRAMES
    read = counted(dev)
    t0 = time.perf_counter()
    poses_b = [system.track_monocular(f, float(stamps[i]), imu=rows[i]) for i, f in enumerate(frames[:n])]
    secs_b = time.perf_counter() - t0
    ate_b, _, ts_b, Twc_b = vi_report("inertial B (IMU_MONOCULAR, default mode through System)", trk_b, poses_b,
                                      stamps[:n], Rs[:n], ts[:n], secs_b, dead=dead)
    cnt, host = read()
    system.shutdown()  # re-raises a failure of the mapping thread
    bound_b = ASYNC_ATE_FACTOR * ate.rmse_scaled + ASYNC_ATE_SLACK_M
    log(f"inertial B: {len(ts_b)} poses exported for {n} frames, {len(ts_b) - len(dead & set(range(n)))} tracked "
        f"while OK; IMU stage {trk_b.map.imu_stage}; bound {ASYNC_ATE_FACTOR} x {ate.rmse_scaled:.6f} + "
        f"{ASYNC_ATE_SLACK_M} = {bound_b:.6f} m; describe launches {cnt}")
    if cnt != n or host != n:
        fail(f"inertial B: orb_describe ran {cnt} times on the card ({host} by the wrapper) for {n} frames")
    launches += cnt
    if trk_b.map.imu_stage < 1:
        fail("inertial B: the IMU never initialized")
    if len(ts_b) / n <= ASYNC_MIN_COVERAGE or not np.all(np.diff(ts_b) > 0) or not np.isfinite(Twc_b).all():
        fail(f"inertial B: {len(ts_b)} of {n} poses exported, or not in order, or not finite")
    if not abs(ate_b.scale - 1.0) < VI_ASYNC_SCALE_TOL:
        fail(f"inertial B: scale {ate_b.scale:.4f} (|scale - 1| < {VI_ASYNC_SCALE_TOL} required)")
    if gate_ate and not ate_b.rmse_scaled <= bound_b:
        fail(f"inertial B: scale-aligned ATE of the tracked poses {ate_b.rmse_scaled:.6f} m > {bound_b:.6f} m")

    # Part C: IMU_STEREO on the same trajectory, rendered as pairs.
    n = VI_STEREO_FRAMES
    scene_c, stamps, Rs, ts, pairs, rows_c = render_inertial(*VI_STEREO_SIZE, stereo=True, n_frames=n)
    worst = max(worst, *(hold_describe(f"an inertial stereo pair's {side} ({VI_STEREO_SIZE[0]}x{VI_STEREO_SIZE[1]})",
                                       *frame_levels(dev, img, orb_params))
                         for side, img in (("left", pairs[0][0]), ("right", pairs[0][1]))))
    trk_c, stages_c, poses_c, (cnt, host), secs_c = run_vi_sync(dev, scene_c, pairs, rows_c, stamps, orb_params,
                                                                Sensor.IMU_STEREO)
    ate_c, _, _, _ = vi_report("inertial C (IMU_STEREO, synchronous)", trk_c, poses_c, stamps, Rs, ts, secs_c)
    bound_c = max(VI_STEREO_JAX_ATE_M, VI_STEREO_PORT_ATE_M) + TOL_LOOP_ATE_M
    log(f"inertial C: IMU stages reached at frames {stages_c}; unscaled ATE bound max({VI_STEREO_JAX_ATE_M:.6f}, "
        f"{VI_STEREO_PORT_ATE_M:.6f}) + {TOL_LOOP_ATE_M} = {bound_c:.6f} m; describe launches {cnt}")
    if cnt != 2 * n or host != 2 * n:
        fail(f"inertial C: orb_describe ran {cnt} times on the card ({host} by the wrapper) for {n} pairs")
    launches += cnt
    if poses_c[0] is None or trk_c.map.imu_stage < 1:
        fail(f"inertial C: initialized at frame 0: {poses_c[0] is not None}; IMU stages {stages_c}")
    if not abs(ate_c.scale - 1.0) < STEREO_SCALE_TOL:
        fail(f"inertial C: scale {ate_c.scale:.4f} (|scale - 1| < {STEREO_SCALE_TOL} required)")
    if gate_ate and not ate_c.rmse <= bound_c:
        fail(f"inertial C: unscaled ATE {ate_c.rmse:.6f} m > {bound_c:.6f} m")
    return launches, worst, float(ate.rmse_scaled), trk  # part A's ATE and tracker


def phase_entry(dev):
    """The port's entry(): fused_track_step at the reference's shapes on the
    card, one describe launch a call, held against the same fn on the CPU."""
    import numpy as np
    import torch

    from orbslam3_cpp_fork_tpu_torch.entry import entry

    fn, args = entry()
    if any(a.device != dev for a in args):
        fail(f"entry: inputs on {sorted({str(a.device) for a in args})}, not on {dev}")
    fn(*args)  # the first call of its shapes
    read = counted(dev)
    t0 = time.perf_counter()
    R2, t2, n_in = fn(*args)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    cnt, host = read()
    R2, t2, n_in = R2.cpu().numpy(), t2.cpu().numpy(), int(n_in)
    fn_c, args_c = entry("cpu")
    Rc, tc, nc = fn_c(*args_c)
    Rc, tc, nc = Rc.numpy(), tc.numpy(), int(nc)
    err = max(float(np.abs(R2 - Rc).max()), float(np.abs(t2 - tc).max()))
    log(f"entry: fused_track_step at 640x480, L = 2048, 1000 features: n_in {n_in} (CPU {nc}), pose vs the CPU's "
        f"{err:.3g} (tolerance {ENTRY_TOL}); {1e3 * secs:.1f} ms a call (host clock, synchronized); describe "
        f"launches {cnt} on the card ({host} by the wrapper) for 1 call")
    if cnt != 1 or host != 1:
        fail(f"entry: orb_describe ran {cnt} times on the card ({host} by the wrapper) for one call")
    if not (np.isfinite(R2).all() and np.isfinite(t2).all()):
        fail("entry: the pose is not finite")
    if n_in != nc or not err <= ENTRY_TOL:
        fail(f"entry: card (n_in {n_in}) against CPU (n_in {nc}): pose {err:.3g} apart (<= {ENTRY_TOL} required)")
    return cnt


def euroc_settings(path, scene, fps, extra="", n_features=N_FEATURES):
    """A File.version 1.0 settings file for a rendered pinhole camera, the
    main path's ORB (1000 features unless `n_features`, 8 levels)."""
    K = scene.K
    Path(path).write_text(
        f"""%YAML:1.0
File.version: "1.0"
Camera.type: "PinHole"
Camera1.fx: {float(K[0, 0])!r}
Camera1.fy: {float(K[1, 1])!r}
Camera1.cx: {float(K[0, 2])!r}
Camera1.cy: {float(K[1, 2])!r}
Camera.width: {scene.width}
Camera.height: {scene.height}
Camera.fps: {fps}
Camera.RGB: 0
ORBextractor.nFeatures: {n_features}
ORBextractor.scaleFactor: 1.2
ORBextractor.nLevels: {N_LEVELS}
ORBextractor.iniThFAST: 20
ORBextractor.minThFAST: 7
{extra}""")


SHELL_IMU_YAML = """IMU.NoiseGyro: 1.7e-4
IMU.NoiseAcc: 2.0e-3
IMU.GyroWalk: 1.9e-5
IMU.AccWalk: 3.0e-3
IMU.Frequency: 200.0
IMU.T_b_c1: !!opencv-matrix
   rows: 4
   cols: 4
   dt: f
   data: [1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 0.0, 1.0]
"""


def write_euroc_tree(root, seq, stamps, frames, imu_rows=None):
    """An EuRoC (ASL) sequence: mav0/cam0/data/<ns>.png (and cam1 for
    (left, right) pairs) and mav0/imu0/data.csv (t_ns, gyro, acc; from
    `imu_rows` [t, acc, gyro], else a gravity-only stream at 200 Hz). Stamps
    start near 0: the drivers and the tracker hold IMU times as float32
    (ROADMAP R17)."""
    import numpy as np

    from orbslam3_cpp_fork_tpu_torch.utils.viewer import save_png

    mav = Path(root) / seq / "mav0"
    stereo = isinstance(frames[0], tuple)
    for i, (t, f) in enumerate(zip(stamps, frames)):
        for cam, img in zip(("cam0", "cam1"), f if stereo else (f,)):
            d = mav / cam / "data"
            d.mkdir(parents=True, exist_ok=True)
            save_png(str(d / f"{int(round(t * 1e9))}.png"), np.asarray(img, np.uint8))
    if imu_rows is None:
        t_imu = np.arange(int(stamps[-1] * 200) + 2) / 200.0
        imu_rows = np.concatenate([t_imu[:, None], np.tile([[0.0, 0.0, 9.81, 0.0, 0.0, 0.0]], (len(t_imu), 1))], 1)
    (mav / "imu0").mkdir(parents=True, exist_ok=True)
    with open(mav / "imu0" / "data.csv", "w") as fh:
        fh.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
        for r in np.asarray(imu_rows, np.float32):
            vals = [float(x) for x in (*r[4:7], *r[1:4])]
            fh.write(f"{int(round(float(r[0]) * 1e9))}," + ",".join(repr(v) for v in vals) + "\n")


def run_driver(name, argv, spy=None):
    """main(argv) of a port driver, in this process; returns the System it
    built (`spy(system)` is called before the first frame)."""
    import importlib

    module = importlib.import_module(f"orbslam3_cpp_fork_tpu_torch.examples.{name}")
    real, built = module.System, []

    def make(*a, **kw):
        system = real(*a, **kw)
        built.append(system)
        if spy is not None:
            spy(system)
        return system

    module.System = make
    try:
        module.main(argv)
    finally:
        module.System = real
    return built[0]


def poll_state(port, at_frame, out, stop):
    """Fetch the live viewer's /state.json until it reports a frame at or
    after `at_frame`; keep that one state in `out`."""
    import json
    import urllib.error
    import urllib.request

    while not stop.is_set():
        try:
            state = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{port}/state.json", timeout=5).read())
        except (urllib.error.URLError, ConnectionError, TimeoutError):
            state = None
        if state is not None and state["frame_id"] >= at_frame:
            out.append(state)
            return
        stop.wait(0.1)


def free_port():
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def driver_poses(name, path, n, dt, dead, min_poses=None):
    """The poses a driver exported (TUM file): stamps, Twc, which of them
    were tracked while OK; gated in time order, finite, > 80% of n (at least
    `min_poses` when given)."""
    import numpy as np

    from orbslam3_cpp_fork_tpu_torch.utils.trajectory import read_tum

    ts_est, Twc = read_tum(str(path))
    few = len(ts_est) / n <= ASYNC_MIN_COVERAGE if min_poses is None else len(ts_est) < min_poses
    if few or not np.all(np.diff(ts_est) > 0) or not np.isfinite(Twc).all():
        fail(f"{name}: {len(ts_est)} of {n} poses exported, or not in order, or not finite")
    return ts_est, Twc, np.asarray([int(round(t / dt)) not in dead for t in ts_est], bool)


def phase_shell(dev, orb_params, stereo_ate, vi_ate, gate_ate):
    """The port's drivers in-process on EuRoC trees (module docstring,
    phase 13)."""
    import os
    import tempfile
    import threading

    import numpy as np

    from orbslam3_cpp_fork_tpu_torch.utils.evaluation import ate_rmse

    launches = 0
    scene, Rs, ts, frames = render_ring(SHELL_FRAMES)
    n = len(frames)
    stamps = np.arange(n) * 0.05
    with tempfile.TemporaryDirectory() as tmp:
        root = Path(tmp)
        # Part A: mono_euroc in the default mode with both viewers.
        write_euroc_tree(root, "RING", stamps, frames)
        euroc_settings(root / "mono.yaml", scene, 20)
        port, state, stop = free_port(), [], threading.Event()
        poller = threading.Thread(target=poll_state, args=(port, SHELL_STATE_AT, state, stop), daemon=True)
        cwd = os.getcwd()
        os.chdir(root)  # viewer_out/ goes here
        read = counted(dev)
        t0 = time.perf_counter()
        poller.start()
        try:
            system = run_driver("mono_euroc", [
                str(root / "mono.yaml"), str(root), "RING", "--traj", str(root / "f.txt"), "--kf-traj",
                str(root / "kf.txt"), "--viewer", "--live-viewer", "--live-viewer-port", str(port),
                "--log-level", "WARNING", "--device", str(dev),
            ])
        finally:
            stop.set()
            poller.join(timeout=30)
            os.chdir(cwd)
        secs = time.perf_counter() - t0
        cnt, host = read()
        ts_est, Twc, _ = driver_poses("shell A", root / "f.txt", n, 0.05, set())
        ate = ate_rmse(ts_est, Twc[:, :3, 3], stamps, ts)
        have = {f: (root / "viewer_out" / f).is_file() for f in ("map.ply", "map.html", "frame_000000.png")}
        kf_lines = len((root / "kf.txt").read_text().splitlines())
        bound = max(SHELL_JAX_ATE_M, SHELL_PORT_ATE_M) + TOL_LOOP_ATE_M
        trk = system.tracker
        log(f"shell A (mono_euroc, default mode, {n} frames of the bench ring at 752x480, --viewer --live-viewer): "
            f"{len(ts_est)} poses exported, {kf_lines} keyframe poses; state {trk.state.name}, pipelined frames "
            f"{trk.n_pipelined_frames}; scale-aligned ATE {ate.rmse_scaled:.6f} m over {ate.n_pairs} poses (scale "
            f"{ate.scale:.4f}); bound max({SHELL_JAX_ATE_M:.6f}, {SHELL_PORT_ATE_M:.6f}) + {TOL_LOOP_ATE_M} = "
            f"{bound:.6f} m; {secs:.2f} s with the "
            f"driver's start and shutdown; describe launches {cnt}; viewer files {have}")
        if cnt != n or host != n:
            fail(f"shell A: orb_describe ran {cnt} times on the card ({host} by the wrapper) for {n} frames")
        launches += cnt
        if not all(have.values()):
            fail(f"shell A: viewer files missing: {have}")
        if not state:
            fail(f"shell A: the live viewer's /state.json never reported frame {SHELL_STATE_AT} or later")
        st = state[0]
        log(f"shell A: /state.json at frame {st['frame_id']}: state {st['state']}, {st['n_keyframes']} keyframes, "
            f"{st['n_landmarks']} landmarks, {len(st['points'])} points, {len(st['traj'])} trajectory centres")
        if not (st["n_landmarks"] > 0 and len(st["points"]) == st["n_landmarks"] and st["n_keyframes"] >= 2
                and len(st["traj"]) == st["n_keyframes"]):
            fail(f"shell A: the live state does not report the live map: {({k: st[k] for k in ('n_keyframes', 'n_landmarks')})}")
        if gate_ate and not ate.rmse_scaled <= bound:
            fail(f"shell A: scale-aligned ATE {ate.rmse_scaled:.6f} m > {bound:.6f} m")

        # Part B: stereo_euroc, 30 pairs of the stereo phase's rig, the
        # default mode (the stereo phase's part C rules).
        scene_s, Rs_s, ts_s, pairs = render_stereo_loop(count=SHELL_STEREO_PAIRS)
        m = len(pairs)
        stamps_s = np.arange(m) * 0.05
        write_euroc_tree(root, "STEREO", stamps_s, pairs)
        K = scene_s.K
        euroc_settings(root / "stereo.yaml", scene_s, 30,
                       f"Camera.bf: {STEREO_BASELINE * float(K[0, 0])!r}\nStereo.ThDepth: 40.0\n")
        spied = []
        read = counted(dev)
        t0 = time.perf_counter()
        system = run_driver("stereo_euroc", [str(root / "stereo.yaml"), str(root), "STEREO", "--traj",
                                             str(root / "s.txt"), "--kf-traj", str(root / "skf.txt"),
                                             "--log-level", "WARNING", "--device", str(dev)],
                            spy=lambda system: spied.append(spy_dead_reckoned(system.tracker)))
        secs = time.perf_counter() - t0
        cnt, host = read()
        ts_e, Twc_e, tracked = driver_poses("shell B", root / "s.txt", m, 0.05, spied[0])
        ate_s = ate_rmse(ts_e[tracked], Twc_e[tracked, :3, 3], stamps_s, ts_s)
        bound_s = ASYNC_ATE_FACTOR * stereo_ate + ASYNC_ATE_SLACK_M
        log(f"shell B (stereo_euroc, default mode, {m} pairs at 752x480): {len(ts_e)} poses exported, "
            f"{int(tracked.sum())} tracked while OK; unscaled ATE of those {ate_s.rmse:.6f} m (scale {ate_s.scale:.4f}); "
            f"bound {ASYNC_ATE_FACTOR} x {stereo_ate:.6f} + {ASYNC_ATE_SLACK_M} = {bound_s:.6f} m; {secs:.2f} s; "
            f"describe launches {cnt}; the System's sensor {system.sensor.name}")
        if cnt != 2 * m or host != 2 * m:
            fail(f"shell B: orb_describe ran {cnt} times on the card ({host} by the wrapper) for {m} pairs")
        launches += cnt
        if gate_ate and not ate_s.rmse <= bound_s:
            fail(f"shell B: unscaled ATE of the tracked poses {ate_s.rmse:.6f} m > {bound_s:.6f} m")

        # Part C: mono_inertial_euroc on the inertial phase's scene, the
        # default mode (the inertial phase's part B rules).
        scene_v, stamps_v, Rs_v, ts_v, frames_v, rows = render_inertial(*VI_MONO_SIZE, n_frames=SHELL_VI_FRAMES)
        k = len(frames_v)
        write_euroc_tree(root, "BOB", stamps_v, frames_v, imu_rows=np.concatenate(rows[1:]))
        euroc_settings(root / "vi.yaml", scene_v, 30, SHELL_IMU_YAML)
        spied = []
        read = counted(dev)
        t0 = time.perf_counter()
        system = run_driver("mono_inertial_euroc", [str(root / "vi.yaml"), str(root), "BOB", "--traj",
                                                    str(root / "v.txt"), "--kf-traj", str(root / "vkf.txt"),
                                                    "--log-level", "WARNING", "--device", str(dev)],
                            spy=lambda system: spied.append(spy_dead_reckoned(system.tracker)))
        secs = time.perf_counter() - t0
        cnt, host = read()
        ts_e, Twc_e, tracked = driver_poses("shell C", root / "v.txt", k, 1.0 / VI_FPS, spied[0])
        ate_v = ate_rmse(ts_e[tracked], Twc_e[tracked, :3, 3], stamps_v, ts_v)
        bound_v = ASYNC_ATE_FACTOR * vi_ate + ASYNC_ATE_SLACK_M
        stage = system.tracker.map.imu_stage
        log(f"shell C (mono_inertial_euroc, default mode, {k} frames at 752x480 with 200 Hz IMU rows): "
            f"{len(ts_e)} poses exported, {int(tracked.sum())} tracked while OK; IMU stage {stage}; scale-aligned ATE "
            f"of those {ate_v.rmse_scaled:.6f} m (scale {ate_v.scale:.4f}); bound {ASYNC_ATE_FACTOR} x {vi_ate:.6f} + "
            f"{ASYNC_ATE_SLACK_M} = {bound_v:.6f} m; {secs:.2f} s; describe launches {cnt}")
        if cnt != k or host != k:
            fail(f"shell C: orb_describe ran {cnt} times on the card ({host} by the wrapper) for {k} frames")
        launches += cnt
        if stage < 1:
            fail("shell C: the IMU never initialized")
        if not abs(ate_v.scale - 1.0) < VI_ASYNC_SCALE_TOL:
            fail(f"shell C: scale {ate_v.scale:.4f} (|scale - 1| < {VI_ASYNC_SCALE_TOL} required)")
        if gate_ate and not ate_v.rmse_scaled <= bound_v:
            fail(f"shell C: scale-aligned ATE of the tracked poses {ate_v.rmse_scaled:.6f} m > {bound_v:.6f} m")
    return launches


def scene_with(scene, width, height, K):
    """The scene seen through another pinhole camera."""
    import dataclasses

    import numpy as np

    fx, fy, cx, cy = K
    K = np.array([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]], np.float32)
    return dataclasses.replace(scene, width=int(width), height=int(height), K=K)


def warp_maps(cam, width, height, f_render, size_render, nearest=False):
    """(map_x, map_y, inside) that give each pixel of a `cam` image (pinhole
    with radtan distortion, or KB8) its source in an ideal pinhole render of
    focal `f_render` and size `size_render` centred on the axis: through the
    port's own model (undistort_points / unproject). `inside`: the source
    lies in the render and, for KB8, within FISHEYE_THETA_MAX of the axis."""
    import numpy as np
    import torch

    from orbslam3_cpp_fork_tpu_torch.ops import camera

    v, u = np.mgrid[0:height, 0:width].astype(np.float32)
    uv = torch.from_numpy(np.stack([u, v], -1).reshape(-1, 2))
    if cam.kind == camera.PINHOLE:
        ideal = camera.undistort_points(cam, uv).numpy()
        x, y = (ideal[:, 0] - cam.cx) / cam.fx, (ideal[:, 1] - cam.cy) / cam.fy
        inside = np.ones(len(x), bool)
    else:
        b = camera.unproject(cam, uv).numpy()
        x, y = b[:, 0], b[:, 1]
        back = camera.project(cam, torch.from_numpy(b)).numpy()
        inside = (np.degrees(np.arctan(np.hypot(x, y))) < FISHEYE_THETA_MAX) & (
            np.abs(back - uv.numpy()).max(1) < 0.5)
    sw, sh = size_render
    mx = (f_render[0] * x + (sw - 1) / 2.0).astype(np.float32)
    my = (f_render[1] * y + (sh - 1) / 2.0).astype(np.float32)
    inside &= (mx >= 0) & (mx <= sw - 1) & (my >= 0) & (my <= sh - 1)
    if nearest:
        mx, my = np.round(mx), np.round(my)
    return mx.reshape(height, width), my.reshape(height, width), inside.reshape(height, width)


def warped_frame(scene, R_wc, t_wc, maps, f_render, size_render, depth=False):
    """A frame of `scene` at pose (R_wc, t_wc) as the camera of `maps` sees
    it: rendered with an ideal pinhole, then remapped (bilinear for
    intensity, nearest for depth in meters). Outside the rendered field of
    view: FISHEYE_BACKGROUND (0 for depth)."""
    import numpy as np
    import torch

    from orbslam3_cpp_fork_tpu_torch.datasets import synthetic
    from orbslam3_cpp_fork_tpu_torch.ops.image import remap_bilinear

    sw, sh = size_render
    ideal = scene_with(scene, sw, sh, (f_render[0], f_render[1], (sw - 1) / 2.0, (sh - 1) / 2.0))
    mx, my, inside = maps
    if depth:
        d = synthetic.render_depth(ideal, R_wc, t_wc)
        ix, iy = np.clip(mx, 0, sw - 1).astype(np.int64), np.clip(my, 0, sh - 1).astype(np.int64)
        return np.where(inside, d[iy, ix], 0.0).astype(np.float32)
    img = synthetic.render_frame(ideal, R_wc, t_wc)
    out = remap_bilinear(torch.from_numpy(img), torch.from_numpy(mx), torch.from_numpy(my)).numpy()
    return synthetic.to_u8(np.where(inside, out, FISHEYE_BACKGROUND))


def driver_scene(name, small=False, count=None):
    """The rendered sequence a driver runs on: a dict with the frames (or
    (left, right) pairs), depth maps, IMU rows, stamps, ground-truth
    camera-to-world poses, the cameras and the ORB budget. `small`: the CPU
    tests' size (5 frames, 320x240, fisheye 256x256, 800
    features); `count`: the first frames only."""
    import numpy as np

    from orbslam3_cpp_fork_tpu_torch.datasets import synthetic, tumvi
    from orbslam3_cpp_fork_tpu_torch.ops.camera import Camera

    inertial = "inertial" in name
    stereo = name.startswith("stereo")
    layout = ("kitti" if "kitti" in name else "tumvi" if "tumvi" in name else "euroc" if "euroc" in name
              else "tum")
    n = (DRIVER_SI_EUROC_PAIRS if layout == "euroc" else DRIVER_VI_FRAMES if inertial else DRIVER_FRAMES)
    n = min(n, 5) if small else n
    n = n if count is None else count
    out = dict(layout=layout, stereo=stereo, inertial=inertial, n=n, depth=None, rows=None)
    # KITTI: the bench ring's scene and circle. The TUM and TUM-VI trees:
    # room-sized rings inside their rigs' ThDepth (TUM: depths 2.5-6.5 m;
    # TUM-VI, 0.1 m baseline: 1.4-3.5 m; its inertial drivers' bobbing 2 m
    # circle: 1.5-7.5 m).
    room = {"tum": dict(r_inner=3.5, r_outer=5.5, half_height=2.0),
            "tumvi": dict(r_inner=2.0, r_outer=3.5, half_height=1.5)}.get(layout, {})
    if inertial:
        w, h = (320, 240) if small else VI_STEREO_SIZE
        ring = dict(r_inner=3.5, r_outer=5.5, half_height=2.0) if layout == "tumvi" else None
        scene, stamps, Rs, ts, _, rows = render_inertial(w, h, n_frames=n, ring=ring, render=False)
        out.update(stamps=stamps, rows=rows, dt=1.0 / VI_FPS)
    else:
        fps = {"kitti": KITTI_FPS, "tum": TUM_FPS, "tumvi": TUMVI_FPS}[layout]
        w, h = ((320, 240) if small else {"kitti": KITTI_SIZE, "tum": TUM_SIZE, "tumvi": (752, 480)}[layout])
        scene = synthetic.make_ring_scene(seed=17, n_points=2400 if room else 1600, size_range=(9, 15), width=w,
                                          height=h, **room)
        radius = {"tum": 1.0, "tumvi": 0.6}.get(layout, 2.5)
        Rs, ts = synthetic.circle_trajectory(n_frames=300, radius=radius, total_angle=2.3 * np.pi)
        Rs, ts = Rs[:n], ts[:n]
        out.update(stamps=np.arange(n) / fps, dt=1.0 / fps)
    out.update(Rs=Rs, ts=ts)
    if layout == "kitti":
        K = (200.0, 200.0, 159.5, 119.5) if small else KITTI_K
        scene = scene_with(scene, w, h, K)
        cam = Camera.pinhole(*K)
        bf = KITTI_BF * (K[0] / KITTI_K[0])
        frames = [synthetic.to_u8(synthetic.render_frame(scene, R, t)) for R, t in zip(Rs, ts)]
        if stereo:
            right = [synthetic.to_u8(synthetic.render_frame(scene, *synthetic.stereo_right_pose(R, t, bf / K[0])))
                     for R, t in zip(Rs, ts)]
            frames = list(zip(frames, right))
        out.update(cams=(cam,), bf=bf, features=800 if small else KITTI_FEATURES)
    elif layout == "tum":
        K = (TUM_K[0] / 2, TUM_K[1] / 2, TUM_K[2] / 2, TUM_K[3] / 2) if small else TUM_K
        if inertial:
            K = tuple(float(v) for v in (scene.K[0, 0], scene.K[1, 1], scene.K[0, 2], scene.K[1, 2]))
            cam = Camera.pinhole(*K)
        else:
            cam = Camera.pinhole(*K, dist=TUM_DIST)
        f_r, size_r = (cam.fx, cam.fy), (w, h)
        maps = warp_maps(cam, w, h, f_r, size_r)
        dmaps = warp_maps(cam, w, h, f_r, size_r, nearest=True)
        frames = [warped_frame(scene, R, t, maps, f_r, size_r) for R, t in zip(Rs, ts)]
        depth = [warped_frame(scene, R, t, dmaps, f_r, size_r, depth=True) for R, t in zip(Rs, ts)]
        # rgbd_inertial: the inertial phase's RGB-D rig (bf = 0.2 fx).
        out.update(cams=(cam,), depth=depth, bf=STEREO_BASELINE * K[0] if inertial else TUM_BF * (K[0] / TUM_K[0]),
                   features=800 if small else (N_FEATURES if inertial else TUM_FEATURES))
    elif layout == "tumvi":
        c1, c2, T12 = tumvi.default_cameras()
        side = 256 if small else TUMVI_SIZE
        if small:
            c1, c2 = c1.scaled(0.5, 0.5), c2.scaled(0.5, 0.5)
        tan_max = np.tan(np.radians(FISHEYE_THETA_MAX))
        f_r = (c1.fx, c1.fy)
        size_r = (int(2 * np.ceil(c1.fx * tan_max)) + 1,) * 2
        frames = []
        maps = [warp_maps(c, side, side, f_r, size_r) for c in (c1, c2)]
        for R, t in zip(Rs, ts):
            left = warped_frame(scene, R, t, maps[0], f_r, size_r)
            if stereo:
                R_r, t_r = R @ T12[:3, :3].astype(np.float32), t + R @ T12[:3, 3].astype(np.float32)
                frames.append((left, warped_frame(scene, R_r, t_r, maps[1], f_r, size_r)))
            else:
                frames.append(left)
        out.update(cams=(c1, c2), T12=T12, features=800 if small else TUMVI_FEATURES[name])
    else:  # stereo_inertial_euroc: the inertial phase's C rig
        K = scene.K
        frames = [(synthetic.to_u8(synthetic.render_frame(scene, R, t)),
                   synthetic.to_u8(synthetic.render_frame(scene, *synthetic.stereo_right_pose(R, t, STEREO_BASELINE))))
                  for R, t in zip(Rs, ts)]
        out.update(cams=(Camera.pinhole(K[0, 0], K[1, 1], K[0, 2], K[1, 2]),), bf=STEREO_BASELINE * float(K[0, 0]),
                   features=800 if small else N_FEATURES)
    out.update(frames=frames, width=w if layout != "tumvi" else side, height=h if layout != "tumvi" else side,
               fps=1.0 / out["dt"])
    return out


def write_driver_settings(path, name, sc):
    """The File.version 1.0 settings of a driver's tree: its family's
    camera (pinhole with TUM1's distortion, or TUM-VI's two KB8 cameras and
    Stereo.T_c1_c2 with the full overlap), rig and ORB budget; the shell
    phase's identity IMU block for the inertial drivers."""
    c1 = sc["cams"][0]
    kb8 = sc["layout"] == "tumvi"
    lines = ['%YAML:1.0', 'File.version: "1.0"', f'Camera.type: "{"KannalaBrandt8" if kb8 else "PinHole"}"']
    names = ("k1", "k2", "k3", "k4") if kb8 else ("k1", "k2", "p1", "p2", "k3")
    for i, c in enumerate(sc["cams"][: 2 if (kb8 and sc["stereo"]) else 1], 1):
        lines += [f"Camera{i}.{k}: {v!r}" for k, v in zip(("fx", "fy", "cx", "cy"), (c.fx, c.fy, c.cx, c.cy))]
        lines += [f"Camera{i}.{k}: {v!r}" for k, v in zip(names, c.dist) if v]
    if kb8 and sc["stereo"]:
        data = ", ".join(repr(float(v)) for v in sc["T12"].reshape(-1))
        lines += ["Stereo.T_c1_c2: !!opencv-matrix", "   rows: 4", "   cols: 4", "   dt: f", f"   data: [{data}]"]
        lines += [f"Camera{i}.overlapping{e}: {v}" for i in (1, 2) for e, v in (("Begin", 0), ("End", 511))]
        lines += [f"Stereo.ThDepth: {TUM_TH_DEPTH}"]  # Stereo[-Inertial]/TUM-VI.yaml
    elif sc["stereo"] or sc["depth"] is not None:
        th = {"kitti": KITTI_TH_DEPTH, "tum": TUM_TH_DEPTH}.get(sc["layout"], 40.0)
        lines += [f"Camera.bf: {float(sc['bf'])!r}", f"Stereo.ThDepth: {th}"]
    lines += [f"Camera.width: {sc['width']}", f"Camera.height: {sc['height']}", f"Camera.fps: {sc['fps']!r}",
              "Camera.RGB: 0", f"ORBextractor.nFeatures: {sc['features']}", "ORBextractor.scaleFactor: 1.2",
              f"ORBextractor.nLevels: {N_LEVELS}", "ORBextractor.iniThFAST: 20", "ORBextractor.minThFAST: 7"]
    Path(path).write_text("\n".join(lines) + "\n" + (SHELL_IMU_YAML if sc["inertial"] else ""))


def write_kitti_tree(root, stamps, frames):
    """KITTI odometry: sequences/00/image_0 (and image_1)/%06d.png, times.txt."""
    import numpy as np

    from orbslam3_cpp_fork_tpu_torch.utils.viewer import save_png

    base = Path(root) / "sequences" / "00"
    stereo = isinstance(frames[0], tuple)
    for cam in ("image_0", "image_1") if stereo else ("image_0",):
        (base / cam).mkdir(parents=True, exist_ok=True)
    for i, f in enumerate(frames):
        for cam, img in zip(("image_0", "image_1"), f if stereo else (f,)):
            save_png(str(base / cam / f"{i:06d}.png"), np.asarray(img, np.uint8))
    (base / "times.txt").write_text("".join(f"{t:.6e}\n" for t in stamps))


def write_tum_tree(root, seq, stamps, frames, depths, imu_rows=None):
    """TUM RGB-D: rgb/ and depth/ PNGs (16-bit depth at TUM_DEPTH_FACTOR a
    meter, 0 past its range), rgb.txt and depth.txt (depth stamped 4 ms
    late, as the association allows), and for an inertial tree imu.csv
    (t_ns, gyro, acc) from rows [t, acc, gyro]."""
    import numpy as np
    from PIL import Image

    from orbslam3_cpp_fork_tpu_torch.utils.viewer import save_png

    base = Path(root) / seq
    (base / "rgb").mkdir(parents=True, exist_ok=True)
    (base / "depth").mkdir(parents=True, exist_ok=True)
    rgb, dep = ["# color images"], ["# depth maps"]
    for t, img, d in zip(stamps, frames, depths):
        save_png(str(base / "rgb" / f"{t:.6f}.png"), np.asarray(img, np.uint8))
        raw = np.round(np.asarray(d, np.float64) * TUM_DEPTH_FACTOR)
        Image.fromarray(np.where(raw <= 65535, raw, 0).astype(np.uint16)).save(str(base / "depth" / f"{t + 0.004:.6f}.png"))
        rgb.append(f"{t:.6f} rgb/{t:.6f}.png")
        dep.append(f"{t + 0.004:.6f} depth/{t + 0.004:.6f}.png")
    (base / "rgb.txt").write_text("\n".join(rgb) + "\n")
    (base / "depth.txt").write_text("\n".join(dep) + "\n")
    if imu_rows is not None:
        with open(base / "imu.csv", "w") as fh:
            fh.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
            for r in np.asarray(imu_rows, np.float32):
                vals = [float(x) for x in (*r[4:7], *r[1:4])]
                fh.write(f"{int(round(float(r[0]) * 1e9))}," + ",".join(repr(v) for v in vals) + "\n")


def write_driver_tree(root, name, sc):
    """The tree and settings of a driver's scene under `root`; returns the
    driver's positional arguments (settings, dataset root, sequence)."""
    import numpy as np

    root = Path(root)
    rows = np.concatenate(sc["rows"][1:]) if sc["rows"] is not None else None
    if sc["layout"] == "kitti":
        write_kitti_tree(root, sc["stamps"], sc["frames"])
        seq = "00"
    elif sc["layout"] == "tum":
        seq = "rgbd_dataset_synthetic"
        write_tum_tree(root, seq, sc["stamps"], sc["frames"], sc["depth"], rows)
    elif sc["layout"] == "tumvi":
        seq = "room1"
        write_euroc_tree(root, f"dataset-{seq}_512_16", sc["stamps"], sc["frames"], imu_rows=rows)
    else:
        seq = "MH_SYN"
        write_euroc_tree(root, seq, sc["stamps"], sc["frames"], imu_rows=rows)
    write_driver_settings(root / f"{name}.yaml", name, sc)
    return [str(root / f"{name}.yaml"), str(root), seq]


def driver_describe_checks(dev):
    """The fused describe kernel and the batched patch gather against their
    plain versions on the new pyramids (a KITTI frame at 1241x376 with 2,000
    features, two waves of blocks; a 512x512 fisheye frame), and
    `orb.compute_descriptors` (the
    patch-gather kernel, one launch a call) on the card against the same
    call on the CPU. Returns (max angle error, compute_descriptors
    launches)."""
    import numpy as np
    import torch

    from orbslam3_cpp_fork_tpu_torch.ops import orb, patches
    from orbslam3_cpp_fork_tpu_torch.ops.orb import OrbParams

    err, kitti = 0.0, None
    for name, feats in (("mono_kitti", KITTI_FEATURES), ("stereo_tumvi", TUMVI_FEATURES["stereo_tumvi"])):
        sc = driver_scene(name, count=1)
        f0 = sc["frames"][0][0] if sc["stereo"] else sc["frames"][0]
        levels = frame_levels(dev, f0, OrbParams(n_features=feats))
        kitti = kitti or levels
        err = max(err, hold_describe(f"{name}'s {f0.shape[1]}x{f0.shape[0]} pyramid, {feats} features", *levels))
        hold_gather(f"{name}'s {f0.shape[1]}x{f0.shape[0]} pyramid, {feats} features", *levels[:3])
    # compute_descriptors on level 0 of the KITTI frame, angles from the
    # CPU (the same bins on both sides): bits exact.
    lv, bl, kp, valid = kitti
    xy = kp[0][valid[: len(kp[0])]].contiguous()
    angle = orb.compute_angles(lv[0].cpu(), xy.cpu())
    n0 = patches.launches
    words, bits = orb.compute_descriptors(bl[0], xy, angle.to(dev))
    torch.cuda.synchronize()
    n = patches.launches - n0
    w_c, b_c = orb.compute_descriptors(bl[0].cpu(), xy.cpu(), angle)
    same = bool(torch.equal(words.cpu(), w_c)) and bool(torch.equal(bits.cpu(), b_c))
    log(f"drivers: orb.compute_descriptors on the card, {len(xy)} keypoints of level 0: {n} patch_gather launch(es); "
        f"words and bits equal to the CPU's: {same}")
    if n != 1 or not same:
        fail(f"drivers: compute_descriptors launched patch_gather {n} times or differs from the CPU")
    return err, n


def phase_drivers(dev, gate_ate):
    """The ten drivers the shell phase does not run (module docstring)."""
    import tempfile

    import numpy as np

    from orbslam3_cpp_fork_tpu_torch.utils.evaluation import ate_rmse

    describe_err, cd_launches = driver_describe_checks(dev)
    launches, report = 0, {}
    with tempfile.TemporaryDirectory() as tmp:
        for name in DRIVER_NAMES:
            t0 = time.perf_counter()
            sc = driver_scene(name)
            root = Path(tmp) / name
            argv = write_driver_tree(root, name, sc)
            t_tree = time.perf_counter() - t0
            spied, read = [], counted(dev)
            t0 = time.perf_counter()
            system = run_driver(name, [*argv, "--traj", str(root / "f.txt"), "--kf-traj", str(root / "kf.txt"),
                                       "--log-level", "WARNING", "--device", str(dev)],
                                spy=lambda system: spied.append(spy_dead_reckoned(system.tracker)))
            secs = time.perf_counter() - t0
            cnt, host = read()
            n = sc["n"]
            ts_e, Twc_e, tracked = driver_poses(f"drivers {name}", root / "f.txt", n, sc["dt"], spied[0])
            ate = ate_rmse(ts_e[tracked], Twc_e[tracked, :3, 3], sc["stamps"], sc["ts"])
            scaled = name.startswith("mono")
            err = ate.rmse_scaled if scaled else ate.rmse
            want = n * (2 if sc["stereo"] else 1)
            ref = DRIVER_ATE_M.get(name)
            bound = max(ref) + TOL_LOOP_ATE_M if ref else None
            stage = system.tracker.map.imu_stage
            report[name] = dict(exported=len(ts_e), tracked=int(tracked.sum()), frames=n, ate=err, scale=ate.scale,
                                launches=cnt, seconds=secs, imu_stage=int(stage))
            log(f"drivers {name} ({sc['layout']} layout, {sc['width']}x{sc['height']}, {sc['features']} features, "
                f"{n} {'pairs' if sc['stereo'] else 'frames'}, default mode): {len(ts_e)} poses exported, "
                f"{int(tracked.sum())} tracked while OK; {'scale-aligned' if scaled else 'unscaled'} ATE of those "
                f"{err:.6f} m (scale {ate.scale:.4f}); bound "
                + (f"max({ref[0]:.6f}, {ref[1]:.6f}) + {TOL_LOOP_ATE_M} = {bound:.6f} m"
                   if bound else "none measured") + f"; IMU stage {stage}; {secs:.2f} s with the driver's start and "
                f"shutdown ({1e3 * secs / n:.1f} ms a {'pair' if sc['stereo'] else 'frame'}, host clock; the tree "
                f"{t_tree:.2f} s); describe launches {cnt}")
            if cnt != want or host != want:
                fail(f"drivers {name}: orb_describe ran {cnt} times on the card ({host} by the wrapper) for {want}")
            launches += cnt
            if sc["inertial"]:
                if stage < 1:
                    fail(f"drivers {name}: the IMU never initialized")
                if not abs(ate.scale - 1.0) < DRIVER_VI_SCALE_TOL:
                    fail(f"drivers {name}: scale {ate.scale:.4f} (|scale - 1| < {DRIVER_VI_SCALE_TOL} required)")
            elif not scaled and not abs(ate.scale - 1.0) < DRIVER_SCALE_TOL:
                fail(f"drivers {name}: scale {ate.scale:.4f} (|scale - 1| < {DRIVER_SCALE_TOL} required)")
            if not np.isfinite(err):
                fail(f"drivers {name}: the ATE is not finite")
            if gate_ate and bound is None:
                fail(f"drivers {name}: no CPU constant in DRIVER_ATE_M")
            if gate_ate and not err <= bound:
                fail(f"drivers {name}: ATE of the tracked poses {err:.6f} m > {bound:.6f} m")
    return launches, describe_err, cd_launches, report


def long_frames(scene, Rs, ts, seed=3):
    """tests/test_long_sequence.py's frames, one at a time: each render plus
    N(0, 3) noise from one generator, clipped to 0..255, float32."""
    import numpy as np

    from orbslam3_cpp_fork_tpu_torch.datasets import synthetic

    rng = np.random.default_rng(seed)
    for R, t in zip(Rs, ts):
        img = synthetic.render_frame(scene, R, t)
        yield np.clip(img + rng.normal(0, 3.0, img.shape), 0, 255).astype(np.float32)


def render_long(n_frames=LONG_FRAMES):
    """tests/test_long_sequence.py's scene and two-lap circle: scene,
    stamps, camera-to-world poses."""
    import numpy as np

    from orbslam3_cpp_fork_tpu_torch.datasets import synthetic

    scene = synthetic.make_ring_scene(seed=11, n_points=1600, size_range=(8, 14), width=640, height=480)
    Rs, ts = synthetic.circle_trajectory(n_frames=LONG_FRAMES, radius=2.5, total_angle=LONG_TURNS * np.pi)
    return scene, np.arange(n_frames) * 0.05, Rs[:n_frames], ts[:n_frames]


def long_config(scene):
    """tests/test_long_sequence.py's TrackerConfig: synchronous, 800
    features, loop closing on."""
    from orbslam3_cpp_fork_tpu_torch import convert
    from orbslam3_cpp_fork_tpu_torch.ops.orb import OrbParams
    from orbslam3_cpp_fork_tpu_torch.runtime.tracker import TrackerConfig

    K = scene.K
    return TrackerConfig(async_mapping=False, camera=convert.camera_from_numpy(K[0, 0], K[1, 1], K[0, 2], K[1, 2]),
                         width=scene.width, height=scene.height, orb=OrbParams(n_features=LONG_FEATURES),
                         enable_loop_closing=True)


def covisibility_rows_differ(m):
    """Live keyframes whose covisibility row (`MapState.covisibility_weights`,
    the native graph where it is built) differs from the dense product of
    the live rows of `obs`."""
    import numpy as np

    live = np.nonzero(m.kf_valid)[0]
    obs = m.obs[live].astype(np.float32)
    dense = (obs @ obs.T).astype(np.int64)
    np.fill_diagonal(dense, 0)
    return sum(not np.array_equal(m.covisibility_weights(int(k)).astype(np.int64)[live], dense[i])
               for i, k in enumerate(live))


LOOP_STAGES = ("window", "fuse", "essential_graph", "global_ba")


def keyframe_ate(m, ts):
    """Scale-aligned ATE (m) of a map's live keyframe centres against the
    true centres `ts` of their frames."""
    import numpy as np

    from orbslam3_cpp_fork_tpu_torch.utils.evaluation import ate_rmse

    live = np.nonzero(m.kf_valid)[0]
    centres = -np.einsum("kji,kj->ki", m.kf_R[live].astype(np.float64), m.kf_t[live].astype(np.float64))
    return ate_rmse(m.kf_frame_id[live].astype(np.float64), centres, np.arange(len(ts), dtype=np.float64),
                    np.asarray(ts, np.float64), max_dt=0.5).rmse_scaled


def record_loop_stages(trk, ts, keep=False):
    """Wrap the loop stages of a tracker's loop closer on the instance (the
    port's or the reference's: the names are the same) and return the list
    that each loop correction appends a record to: the keyframe, the match
    and the Sim(3) (s, R, t) the correction was given, the candidate
    validations and projection counts of its loop step, and for each stage
    of LOOP_STAGES the host ms and the keyframe ATE after it (`keyframe_ate`
    against the true centres `ts`; "before" is the map the correction
    started from). The window stage ends where SearchAndFuse starts, and
    the global BA is the loop closer's `global_ba_hook`. With `keep`, each
    stage also keeps copies of what it wrote: keyframe poses and landmark
    positions, and after the fuse the landmark tables."""
    import numpy as np

    lc = trk.loop_closer
    loops, seen = [], dict(validations=[], projections=[], queries=[])
    clock = {}

    def copies(stage):
        m = lc.m
        if not keep:
            return {}
        if stage == "fuse":
            return dict(lm_valid=m.lm_valid.copy(), lm_replaced=m.lm_replaced.copy(), kf_lm_idx=m.kf_lm_idx.copy(),
                        obs=m.obs.copy())
        return dict(kf_valid=m.kf_valid.copy(), kf_R=m.kf_R.copy(), kf_t=m.kf_t.copy(), lm_valid=m.lm_valid.copy(),
                    lm_pos=m.lm_pos.copy())

    def close(stage):
        now = time.perf_counter()
        rec = loops[-1]
        rec["stages"][stage] = dict(ms=1e3 * (now - clock["t"]), ate=keyframe_ate(lc.m, ts), **copies(stage))
        clock["t"] = time.perf_counter()

    def wrap(obj, name, before=None, after=None, note=None):
        real = getattr(obj, name)

        def run(*a, **kw):
            if before is not None:
                before(*a)
            out = real(*a, **kw)
            if note is not None:
                note(a, out)
            if after is not None:
                after()
            return out

        setattr(obj, name, run)

    def start(k, c, s, R, t):
        loops.append(dict(kf=int(k), match=int(c), s=float(s), R=np.array(R), t=np.array(t),
                          **{key: list(v) for key, v in seen.items()},
                          stages=dict(before=dict(ms=0.0, ate=keyframe_ate(lc.m, ts)))))
        for v in seen.values():
            v.clear()
        clock["t"] = time.perf_counter()

    wrap(lc, "_validate_candidate",
         note=lambda a, out: seen["validations"].append((int(a[0]), int(a[1]), None if out is None else (
             float(out[0]), np.array(out[1]), np.array(out[2]), int(out[3])))))
    wrap(lc, "_projection_matches", note=lambda a, out: seen["projections"].append((int(a[0]), int(a[1]), int(out))))
    wrap(lc.kfdb, "query_groups", note=lambda a, out: seen["queries"].append(
        ([int(g) for g in out[0]], [float(x) for x in out[1]])))
    wrap(lc, "_correct_loop_locked", before=start)
    wrap(lc, "_search_and_fuse", before=lambda *a: close("window"), after=lambda: close("fuse"))
    wrap(lc, "_essential_graph", after=lambda: close("essential_graph"))
    if lc.global_ba_hook is not None:
        wrap(lc, "global_ba_hook", after=lambda: close("global_ba"))
    return loops


def drive_long(trk, scene, stamps, Rs, ts):
    """Track the long phase's frames. Just before every keyframe cull, counts
    the live keyframes whose covisibility row differs from the dense
    product (the cull's first step queries the same rows, so the check moves
    no decision). After every frame that closed a loop, records the loop's
    Sim(3) scale, the scale-aligned ATE of the poses exported so far, the
    ground truth of its two frames (`revisit`: centre distance, angle of the
    optical axes) and the keyframe ATE after each stage of its correction
    (`record_loop_stages`; ROADMAP C4's split). Returns (frames tracked, ms a
    frame, those records, the differing rows of every cull call, the host ms
    of each loop's stages)."""
    from orbslam3_cpp_fork_tpu_torch.utils.evaluation import ate_rmse

    n_tracked, ms, after_loop, differ = 0, [], [], []
    stages = record_loop_stages(trk, ts)
    real_cull = trk._cull_keyframes

    def cull(k):
        differ.append(covisibility_rows_differ(trk.map))
        return real_cull(k)

    trk._cull_keyframes = cull
    try:
        for i, img in enumerate(long_frames(scene, Rs, ts)):
            t1 = time.perf_counter()
            if trk.track(img, float(stamps[i])) is not None:
                n_tracked += 1
            ms.append(1e3 * (time.perf_counter() - t1))
            loops = [e for e in trk.loop_closer.events if e["kind"] == "loop"]
            if len(loops) > len(after_loop):
                ts_est, Twc = trk.export_trajectory()  # synchronous: nothing in flight
                ate = ate_rmse(ts_est, Twc[:, :3, 3], stamps, ts)
                for j, ev in enumerate(loops[len(after_loop):], start=len(after_loop)):
                    dist, deg = revisit(Rs, ts, ev)
                    after_loop.append(dict(
                        frame=i, kf=int(ev["kf"]), match=int(ev["match"]), sim3_scale=float(ev["scale"]),
                        ate=ate.rmse_scaled, align_scale=float(ate.scale), truth_m=dist, truth_deg=deg,
                        kf_ate={name: st["ate"] for name, st in stages[j]["stages"].items()}))
    finally:
        del trk._cull_keyframes
    return n_tracked, ms, after_loop, differ, [{name: st["ms"] for name, st in rec["stages"].items()} for rec in stages]


def loop_stage_lines(name, after_loop, stage_ms=None):
    """Log each closed loop of `drive_long`'s records: its Sim(3) scale, the
    ground truth of its two frames beside the LOOP_REVISIT_DEG bar that
    tells a true revisit, the keyframe ATE before the correction and after
    each of its stages, and with `stage_ms` the host ms of each stage."""
    for j, rec in enumerate(after_loop):
        log(f"{name}: loop at frame {rec['frame']} (keyframe {rec['kf']} -> {rec['match']}, Sim(3) scale "
            f"{rec['sim3_scale']:.4f}): ground truth {rec['truth_m']:.3f} m apart, optical axes {rec['truth_deg']:.1f} "
            f"deg apart ({'within' if rec['truth_deg'] <= LOOP_REVISIT_DEG else 'beyond'} the {LOOP_REVISIT_DEG:.0f} "
            f"deg of a true revisit); scale-aligned ATE of the poses exported so far {rec['ate']:.6f} m")
        ates = ", ".join(f"{st} {ate:.6f} m" for st, ate in rec["kf_ate"].items())
        log(f"{name}: loop at frame {rec['frame']}: keyframe ATE {ates}")
        if stage_ms is not None and j < len(stage_ms):
            log(f"{name}: loop at frame {rec['frame']}: host ms "
                + ", ".join(f"{st} {v:.1f}" for st, v in stage_ms[j].items() if st != "before"))


def cull_report(name, trk):
    """Log the tracker's keyframe-culling counts (`Tracker.cull_stats`) and
    the covisibility route; returns them as a dict."""
    import dataclasses

    import numpy as np

    from orbslam3_cpp_fork_tpu_torch import native

    st = trk.cull_stats
    r = np.asarray(st.redundancy, np.float64)
    rep = {k: v for k, v in dataclasses.asdict(st).items() if k != "redundancy"}
    rep.update(backend=native.backend(), redundancy_max=float(r.max(initial=0.0)),
               redundancy_median=float(np.median(r)) if len(r) else 0.0,
               redundancy_at_least_0_8=int((r >= 0.8).sum()), redundancy_at_least_0_9=int((r >= 0.9).sum()))
    log(f"{name}: mapgraph backend: {rep['backend']}")
    log(f"{name}: keyframe culling: {st.calls} calls, {st.culled} keyframes culled; valid keyframes below weight 15 "
        f"(never candidates) {st.not_neighbour}; candidates {st.candidates}: protected {st.protected}, inertial gap "
        f"{st.inertial_gap}, < 10 landmarks {st.few_landmarks}, redundancy below the bar {st.below_redundancy}, "
        f"left at the call's bound {st.max_cull}, culled {st.culled}; redundant fraction over {len(r)} candidates: "
        f"max {rep['redundancy_max']:.4f}, median {rep['redundancy_median']:.4f}, >= 0.8: "
        f"{rep['redundancy_at_least_0_8']}, >= 0.9: {rep['redundancy_at_least_0_9']}")
    return rep


def save_cull_state(trk, path):
    """What keyframe culling reads of the tracker's map, compact: the live
    keyframes' slots, landmark ids, levels, frame ids and `obs` rows (bit
    packed), the landmarks' validity (bit packed), the reference keyframe,
    the capacities and the card it ran on (tests/test_torch_cull_state.py)."""
    import numpy as np

    m = trk.map
    live = np.nonzero(m.kf_valid)[0]
    np.savez_compressed(
        path, slots=live.astype(np.int16), kf_lm_idx=m.kf_lm_idx[live].astype(np.int16),
        kf_level=m.kf_level[live].astype(np.int8), kf_frame_id=m.kf_frame_id[live],
        obs=np.packbits(m.obs[live], axis=1), lm_valid=np.packbits(m.lm_valid), ref_kf=trk.ref_kf,
        n_kf_inserted=trk.n_kf_inserted, max_keyframes=m.cfg.max_keyframes, max_landmarks=m.cfg.max_landmarks,
        n_features=m.cfg.n_features, card=card_line(),
    )
    log(f"long: the final map's cull inputs written to {path}")


def phase_long(dev, n_frames, gate, long_state=None):
    """tests/test_long_sequence.py's 560 frames on the card (module
    docstring); with `long_state`, the final map's cull inputs are written
    there (`save_cull_state`)."""
    import numpy as np

    from orbslam3_cpp_fork_tpu_torch.runtime.tracker import Tracker, TrackState
    from orbslam3_cpp_fork_tpu_torch.utils.evaluation import ate_rmse

    scene, stamps, Rs, ts = render_long(n_frames)
    trk = Tracker(long_config(scene), dev)
    removed = [0]
    real_remove = trk.map.remove_landmarks

    def remove_landmarks(ids):
        removed[0] += len(ids)
        return real_remove(ids)

    trk.map.remove_landmarks = remove_landmarks
    read = counted(dev)
    t0 = time.perf_counter()
    n_tracked, ms, after_loop, differ, stage_ms = drive_long(trk, scene, stamps, Rs, ts)
    secs = time.perf_counter() - t0
    cnt, host = read()
    m = trk.map
    ts_est, Twc = trk.export_trajectory()
    ate = ate_rmse(ts_est, Twc[:, :3, 3], stamps, ts)
    loops, gbas = loop_report("long", trk, Rs, ts)
    loop_stage_lines("long", after_loop, stage_ms)
    culls = cull_report("long", trk)
    log(f"long: covisibility rows that differ from the dense obs @ obs.T just before a cull: "
        f"{sum(differ)} over {len(differ)} cull calls")
    if long_state:
        save_cull_state(trk, long_state)
    n_kf, n_lm = m.n_keyframes(), m.n_landmarks()
    report = dict(frames=n_frames, tracked=n_tracked, exported=len(ts_est), keyframes=n_kf,
                  keyframes_inserted=int(trk.n_kf_inserted), landmarks=n_lm, loops=int(trk.loop_closer.n_loops_closed),
                  landmarks_removed=removed[0], ate=ate.rmse_scaled, scale=ate.scale, launches=cnt,
                  ms_median=float(np.median(ms)), ms_p99=float(np.percentile(ms, 99)), seconds=secs,
                  after_loop=after_loop, loop_stage_ms=stage_ms, culls=culls, covisibility_rows_differ=sum(differ))
    log(f"long ({n_frames} noisy frames at 640x480, {LONG_FEATURES} features, synchronous, loop closing on): state "
        f"{trk.state.name}; tracked {n_tracked}/{n_frames} (> {LONG_MIN_TRACKED} required); keyframes {n_kf} alive of "
        f"{trk.n_kf_inserted} inserted (cap {m.cfg.max_keyframes}; < {LONG_MAX_KF_FRAC} x frames required), landmarks "
        f"{n_lm} (cap {m.cfg.max_landmarks}), {removed[0]} landmarks removed; loops closed "
        f"{trk.loop_closer.n_loops_closed}, global BAs {len(gbas)}; {len(ts_est)} poses exported; scale-aligned ATE "
        f"{ate.rmse_scaled:.6f} m over {ate.n_pairs} poses (scale {ate.scale:.4f}; < {LONG_MAX_ATE_M} m required); "
        f"{np.median(ms):.1f} ms a frame median, {np.percentile(ms, 99):.1f} ms p99, {secs:.1f} s in all (host "
        f"clock); describe launches {cnt}")
    if cnt != n_frames or host != n_frames:
        fail(f"long: orb_describe ran {cnt} times on the card ({host} by the wrapper) for {n_frames} frames")
    if sum(differ):
        fail(f"long: the covisibility graph's rows differ from the dense product in {sum(differ)} cases")
    if not np.isfinite(m.lm_pos[m.lm_valid]).all():
        fail("long: the map is not finite")
    if gate:
        if trk.state != TrackState.OK or not n_tracked > LONG_MIN_TRACKED * n_frames:
            fail(f"long: state {trk.state.name}, {n_tracked} of {n_frames} frames tracked")
        if trk.loop_closer.n_loops_closed < 1:
            fail("long: the revisit closed no loop")
        if not (n_kf < LONG_MAX_KF_FRAC * n_frames and n_lm < m.cfg.max_landmarks):
            fail(f"long: culling did not bound the map ({n_kf} keyframes, {n_lm} landmarks)")
        if not (len(ts_est) > LONG_MIN_EXPORTED * n_frames and ate.rmse_scaled < LONG_MAX_ATE_M):
            fail(f"long: {len(ts_est)} poses exported, scale-aligned ATE {ate.rmse_scaled:.6f} m")
    return cnt, report


def imu_yaml(Tbc):
    """SHELL_IMU_YAML's noise and rate with IMU.T_b_c1 = `Tbc` (4x4)."""
    data = ", ".join(repr(float(x)) for row in Tbc for x in row)
    return SHELL_IMU_YAML.split("IMU.T_b_c1:")[0] + (
        f"IMU.T_b_c1: !!opencv-matrix\n   rows: 4\n   cols: 4\n   dt: f\n   data: [{data}]\n")


def inertial_path_lines(name, rec, Rs, ts, events):
    """Log an inertial run's ScaleRefinement calls and, for each loop, its
    keyframes, ground truth, essential-graph mode and what moved across it,
    and the global BA that followed."""
    for r in rec["refine"]:
        log(f"{name}: ScaleRefinement at frame {r['frame']} ({r['t']:.2f} s after the first inertial keyframe): s "
            f"{'-' if r['s'] is None else format(r['s'], '.6f')}, {r['branch']}, {r['ms']:.1f} ms (host clock)")
    loops = [e for e in events if e["kind"] == "loop"]
    for j, ev in enumerate(loops):
        dist, deg = revisit(Rs, ts, ev)
        g = rec["graph"][j] if j < len(rec["graph"]) else {}
        b = rec["gba"][j] if j < len(rec["gba"]) else {}
        log(f"{name}: loop keyframe {ev['kf']} (frame {ev['kf_frame']}) -> {ev['match']} (frame {ev['match_frame']}), "
            f"Sim(3) scale {ev['scale']:.6f}; ground truth {dist:.3f} m, optical axes {deg:.1f} deg apart; essential "
            f"graph {g.get('mode')} in {g.get('ms', float('nan')):.1f} ms, across it the largest move of a body gravity "
            f"direction {g.get('gravity_moved', float('nan')):.2e} and of a vertex scale "
            f"{g.get('scale_moved', float('nan')):.2e}; global BA {b.get('kind')} ({b.get('where')}) "
            f"{b.get('ms', float('nan')):.1f} ms (host clock)")
    return loops


def phase_inertial_long(dev, n_frames, gate):
    """The inertial path past its init on the card (module docstring, phase
    17). Returns (describe launches, the describe kernel's angle error, a
    report)."""
    import os
    import tempfile

    import numpy as np

    from orbslam3_cpp_fork_tpu_torch.ops.orb import OrbParams
    from orbslam3_cpp_fork_tpu_torch.optim import inertial as vi
    from orbslam3_cpp_fork_tpu_torch.optim import pose_graph
    from orbslam3_cpp_fork_tpu_torch.runtime.tracker import Tracker
    from orbslam3_cpp_fork_tpu_torch.utils.evaluation import ate_rmse

    scene, stamps, Rs, ts, frames, rows = render_inertial_long(n_frames=n_frames)
    worst = hold_describe(f"the inertial long scene on EuRoC's rig ({VIL_SIZE[0]}x{VIL_SIZE[1]}, {VIL_FEATURES} "
                          "features)", *frame_levels(dev, frames[0], OrbParams(n_features=VIL_FEATURES)))

    # Part A: the synchronous tracker over every frame.
    trk = Tracker(inertial_long_config(scene), dev)
    rec = record_inertial_path(trk, vi, pose_graph, "optimize_pose_graph")
    read = counted(dev)
    stages, kf_frames, ms, n_tracked = {}, [], [], 0
    t0 = time.perf_counter()
    for i, f in enumerate(frames):
        n_kf = trk.n_kf_inserted
        t1 = time.perf_counter()
        n_tracked += trk.track(f, float(stamps[i]), imu=rows[i]) is not None
        ms.append(1e3 * (time.perf_counter() - t1))
        stages.setdefault(int(trk.map.imu_stage), i)
        if trk.n_kf_inserted > n_kf:
            kf_frames.append(i)
    secs = time.perf_counter() - t0
    cnt, host = read()
    ts_est, Twc = trk.export_trajectory()
    ate = ate_rmse(ts_est, Twc[:, :3, 3], stamps, ts)
    pos = Twc[:, :3, 3] - Twc[:, :3, 3].mean(0)
    n_z = abs(float(np.linalg.svd(pos)[2][2][2]))
    loops = inertial_path_lines("inertial long A", rec, Rs, ts, trk.loop_closer.events)
    names = {1: "IMU init", 2: "VIBA1", 3: "VIBA2"}
    log("inertial long A: " + "; ".join(f"{names[s]} at frame {f} ({stamps[f]:.1f} s)" for s, f in sorted(stages.items())
                                         if s in names)
        + "; FullInertialBA calls (frame, priors g/a, iterations, ms): "
        + ", ".join(f"({r['frame']}, {r['prior_g']:g}/{r['prior_a']:g}, {r['iters']}, {r['ms']:.1f})" for r in rec["fiba"]))
    viba2 = stages.get(3)
    ref_at = next((j for j, f in enumerate(kf_frames) if f >= VIL_JAX_VIBA2_FRAME), len(kf_frames))
    viba2_kfs = abs(kf_frames.index(viba2) - ref_at) if viba2 in kf_frames else None
    bound = max(VIL_JAX_ATE_M, VIL_PORT_ATE_M) + TOL_LOOP_ATE_M
    n = len(frames)
    report = dict(frames=n, tracked=n_tracked, stages={names[s]: f for s, f in stages.items() if s in names},
                  refinements=rec["refine"], fiba=rec["fiba"], graphs=rec["graph"], gbas=rec["gba"],
                  loops=[dict(kf=e["kf"], match=e["match"], kf_frame=e["kf_frame"], match_frame=e["match_frame"],
                              deg=revisit(Rs, ts, e)[1]) for e in loops],
                  ate=ate.rmse_scaled, scale=ate.scale, n_z=n_z, launches_a=cnt, seconds_a=secs,
                  ms_median=float(np.median(ms)), ms_p99=float(np.percentile(ms, 99)))
    log(f"inertial long A (IMU_MONOCULAR on EuRoC's T_b_c1, {n} frames at {VIL_SIZE[0]}x{VIL_SIZE[1]}, "
        f"{VIL_FEATURES} features, synchronous, loop closing on): state {trk.state.name}, IMU stage "
        f"{trk.map.imu_stage}, tracked {n_tracked}/{n}; keyframes {trk.map.n_keyframes()}, landmarks "
        f"{trk.map.n_landmarks()}; VIBA2 at frame {viba2}, the reference's CPU run at {VIL_JAX_VIBA2_FRAME} "
        f"({viba2_kfs} keyframes apart); ScaleRefinement calls {len(rec['refine'])} (the reference's CPU run: "
        f"{VIL_JAX_REFINEMENTS}); loops {len(loops)}, global BAs after them {len(rec['gba'])}; scale-aligned ATE "
        f"{ate.rmse_scaled:.6f} m (scale {ate.scale:.4f}) over {ate.n_pairs} poses, bound max({VIL_JAX_ATE_M:.6f}, "
        f"{VIL_PORT_ATE_M:.6f}) + {TOL_LOOP_ATE_M} = {bound:.6f} m; plane normal |n_z| {n_z:.4f}; "
        f"{np.median(ms):.1f} ms a frame median, {np.percentile(ms, 99):.1f} ms p99, {secs:.1f} s in all (host clock); "
        f"describe launches {cnt}")
    if cnt != n or host != n:
        fail(f"inertial long A: orb_describe ran {cnt} times on the card ({host} by the wrapper) for {n} frames")
    for g in rec["graph"]:
        if g["mode"] != "4dof" or not (g["gravity_moved"] < VIL_GRAVITY_TOL and g["scale_moved"] < VIL_GRAVITY_TOL):
            fail(f"inertial long A: an essential graph in mode {g['mode']} moved a body gravity direction by "
                 f"{g['gravity_moved']:.3g} and a vertex scale by {g['scale_moved']:.3g} (4dof, < {VIL_GRAVITY_TOL})")
    if len(rec["gba"]) != len(loops) or any(b["kind"] != "inertial" for b in rec["gba"]):
        fail(f"inertial long A: global BAs after the {len(loops)} loops: {[b['kind'] for b in rec['gba']]} (one "
             "inertial each required)")
    if gate:
        if trk.state.name != "OK" or not n_tracked > VIL_MIN_TRACKED * n:
            fail(f"inertial long A: state {trk.state.name}, {n_tracked} of {n} tracked (> {VIL_MIN_TRACKED} required)")
        if trk.map.imu_stage != 3 or viba2_kfs is None or viba2_kfs > 1:
            fail(f"inertial long A: IMU stage {trk.map.imu_stage}, VIBA2 at frame {viba2}, {viba2_kfs} keyframes from "
                 f"the reference's frame {VIL_JAX_VIBA2_FRAME} (within one required)")
        if len(rec["refine"]) != VIL_JAX_REFINEMENTS:
            fail(f"inertial long A: ScaleRefinement called {len(rec['refine'])} times, the reference "
                 f"{VIL_JAX_REFINEMENTS}")
        if not loops or any(revisit(Rs, ts, e)[1] > LOOP_REVISIT_DEG for e in loops):
            fail(f"inertial long A: loops {[(e['kf_frame'], e['match_frame']) for e in loops]}: none, or not a true "
                 f"revisit (optical axes within {LOOP_REVISIT_DEG} deg required)")
        if not abs(ate.scale - 1.0) < VI_SCALE_TOL or not n_z > VI_GRAVITY_NZ:
            fail(f"inertial long A: scale {ate.scale:.4f}, plane normal |n_z| {n_z:.4f}")
        if not ate.rmse_scaled <= bound:
            fail(f"inertial long A: scale-aligned ATE {ate.rmse_scaled:.6f} m > {bound:.6f} m")

    # Part B: the mono_inertial_euroc driver in the default mode on an
    # EuRoC tree whose settings carry EuRoC's T_b_c1. The default mode can
    # lose the map and spawn another (both implementations do on this
    # scene), so the IMU stage is the highest any map reached and the ATE
    # and scale are each map's own (the merge phase's part B rule).
    k = min(VIL_DRIVER_FRAMES, n)
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        root = Path(tmp)
        write_euroc_tree(root, "BOB", stamps[:k], frames[:k], imu_rows=np.concatenate(rows[1:k]))
        euroc_settings(root / "vil.yaml", scene, VI_FPS, imu_yaml(EUROC_T_B_C1))
        spied, recs, top = [], [], dict(stage=0, frame=None, n=0)

        def spy(system):
            trk_s = system.tracker
            spied.append(spy_dead_reckoned(trk_s))
            recs.append(record_inertial_path(trk_s, vi, pose_graph, "optimize_pose_graph"))
            real = system.track_monocular

            def track(img, t, imu=None):
                out = real(img, t, imu=imu)
                if trk_s.map.imu_stage > top["stage"]:
                    top.update(stage=int(trk_s.map.imu_stage), frame=top["n"])
                top["n"] += 1
                return out

            system.track_monocular = track

        read = counted(dev)
        t0 = time.perf_counter()
        system = run_driver("mono_inertial_euroc", [str(root / "vil.yaml"), str(root), "BOB", "--traj",
                                                    str(root / "t.txt"), "--kf-traj", str(root / "kf.txt"),
                                                    "--log-level", "WARNING", "--device", str(dev)], spy=spy)
        secs_b = time.perf_counter() - t0
        cnt_b, host_b = read()
        ts_e, _, tracked = driver_poses("inertial long B", root / "t.txt", k, 1.0 / VI_FPS, spied[0])
    trk_b = system.tracker
    ts_x, Twc_x = trk_b.export_trajectory()
    keep = np.asarray([int(round(t * VI_FPS)) not in spied[0] for t in ts_x], bool)
    per_map = per_map_ates(trk_b, ts_x, Twc_x, keep, stamps[:k], ts[:k])
    loops_b = inertial_path_lines("inertial long B", recs[0], Rs, ts, trk_b.loop_closer.events)
    bg = sum(b["kind"] == "inertial" and b["where"] == "background" for b in recs[0]["gba"])
    bound_b = ASYNC_ATE_FACTOR * ate.rmse_scaled + ASYNC_ATE_SLACK_M
    report.update(frames_b=k, exported_b=len(ts_e), tracked_b=int(tracked.sum()), stage_b=top["stage"],
                  stage_b_frame=top["frame"], maps_b={m: dict(ate=r.rmse_scaled, scale=r.scale, n=r.n_pairs)
                                                      for m, r in per_map.items()},
                  lost_b=int(trk_b.n_lost_events), loops_b=len(loops_b), background_gbas_b=bg, launches_b=cnt_b,
                  seconds_b=secs_b)
    log(f"inertial long B (mono_inertial_euroc with IMU.T_b_c1 = EuRoC's, default mode, {k} frames): {len(ts_e)} poses "
        f"exported, {int(tracked.sum())} tracked while OK; loss events {trk_b.n_lost_events}, maps "
        f"{len(trk_b.atlas.maps)}; the highest IMU stage {top['stage']} (first at frame {top['frame']}; VIBA2 "
        f"{'reached' if top['stage'] >= 3 else 'not reached'}; the reference driver's lowest in three CPU runs: "
        f"{VIL_JAX_DRIVER_STAGE}); per map with >= 10 tracked poses, scale-aligned ATE and scale: "
        + ", ".join(f"map {m} {r.rmse_scaled:.6f} m, {r.scale:.4f} over {r.n_pairs}" for m, r in per_map.items())
        + f"; bound {ASYNC_ATE_FACTOR} x {ate.rmse_scaled:.6f} + {ASYNC_ATE_SLACK_M} = {bound_b:.6f} m; loops on the "
        f"loop thread {len(loops_b)} (the reference driver's fewest in three CPU runs: {VIL_JAX_DRIVER_LOOPS}); "
        f"background inertial global BAs {bg}; {secs_b:.1f} s; describe launches {cnt_b}")
    if cnt_b != k or host_b != k:
        fail(f"inertial long B: orb_describe ran {cnt_b} times on the card ({host_b} by the wrapper) for {k} frames")
    if gate:
        if top["stage"] < VIL_JAX_DRIVER_STAGE:
            fail(f"inertial long B: the highest IMU stage {top['stage']} (>= {VIL_JAX_DRIVER_STAGE} required)")
        if not per_map:
            fail("inertial long B: no map holds 10 poses tracked while OK")
        for m, r in per_map.items():
            if not abs(r.scale - 1.0) < VIL_DRIVER_SCALE_TOL or not r.rmse_scaled <= bound_b:
                fail(f"inertial long B: map {m}: scale {r.scale:.4f} (|scale - 1| < {VIL_DRIVER_SCALE_TOL} required), "
                     f"scale-aligned ATE of the tracked poses {r.rmse_scaled:.6f} m (<= {bound_b:.6f} m required)")
        if len(loops_b) < VIL_JAX_DRIVER_LOOPS:
            fail(f"inertial long B: {len(loops_b)} loops (>= {VIL_JAX_DRIVER_LOOPS} required)")
    return cnt + cnt_b, worst, report


def phase_inertial_merge(dev, n_frames, gate):
    """The inertial Atlas on the card (module docstring, phase 18). Returns
    (describe launches, the describe kernel's angle error, a report)."""
    import os
    import tempfile

    import numpy as np
    import torch

    from orbslam3_cpp_fork_tpu_torch.ops.orb import OrbParams
    from orbslam3_cpp_fork_tpu_torch.optim import inertial as vi
    from orbslam3_cpp_fork_tpu_torch.optim import pose_graph
    from orbslam3_cpp_fork_tpu_torch.runtime.tracker import Tracker

    t_phase = time.perf_counter()
    scene, stamps, Rs, ts, frames, rows = render_inertial_merge(n_frames=n_frames)
    n = len(frames)
    params = OrbParams(n_features=VIL_FEATURES)
    worst = hold_describe(f"the inertial merge scene's first frame ({VIL_SIZE[0]}x{VIL_SIZE[1]}, {VIL_FEATURES} "
                          "features)", *frame_levels(dev, frames[0], params))
    # A flat frame of the blind stretches has no keypoint; five slots laid on
    # its coarsest level must give angle 0 and no set bit.
    flat = np.full((VIL_SIZE[1], VIL_SIZE[0]), int(VIM_FLAT), np.uint8)
    lv, bl, kp, valid = frame_levels(dev, flat, params)
    if bool(valid.any()):
        fail("inertial merge: the flat frame has keypoints")
    h, w = lv[-1].shape
    tail = torch.tensor([[0, 0], [w - 1, h - 1], [w // 2, h // 2], [-5, -7], [w + 3, h + 9]], dtype=torch.int32)
    kp = kp[:-1] + [torch.cat([kp[-1], tail.to(dev)])]
    worst = max(worst, hold_describe("the inertial merge scene's flat frame (5 slots on its coarsest level)",
                                     lv, bl, kp, None, flat_tail=True))

    # Part A: the synchronous tracker over every frame.
    trk = Tracker(inertial_long_config(scene), dev)
    rec = record_inertial_path(trk, vi, pose_graph, "optimize_pose_graph")
    read = counted(dev)
    captures = [(-1, 0)]

    def on_frame(i):
        c = graph_captures(trk)
        if c != captures[-1][1]:
            captures.append((i, c))

    rep = drive_inertial_merge(trk, frames, stamps, rows, ts, on_frame)
    cnt, host = read()
    end = vim_ate(trk, rep["spawn"], rep["dead"], stamps, ts)
    samples = trk.timers.samples
    merge_ms = [1e3 * x for x in samples.get("merge", [])]
    vi_ba_ms = [1e3 * x for x in samples.get("merge_vi_ba", [])]
    n_eg = len(samples.get("merge_eg", []))
    spawns, welds = rep["spawn"], rep["welds"]
    mid, viba2, f0, viba2_kfs = vim_viba2_keyframes(rep, VIM_JAX_VIBA2_AFTER_T0)
    weld_bound = max(VIM_JAX_WELD_ATE_M, VIM_PORT_WELD_ATE_M) + TOL_LOOP_ATE_M
    end_bound = max(VIM_JAX_ATE_M, VIM_PORT_ATE_M) + TOL_LOOP_ATE_M
    weld = rep["weld"] or {}
    loops = [e for e in trk.loop_closer.events if e["kind"] == "loop"]
    for r in spawns:
        log(f"inertial merge A: {r['kind']} at frame {r['frame']}: map {r['map_id']} with {r['kfs']} keyframes at IMU "
            f"stage {r['stage']} -> active map {r['active_id']} with {r['active_kfs']} keyframes, {r['maps']} map(s); "
            f"database rows left in map {r['map_id']}'s namespace {r['rows_left']}")
    for r in welds:
        log(f"inertial merge A: weld at frame {r['frame']}: map {r['src']} ({r['kfs']} keyframes) into map {r['dst']}, "
            f"sM {r['s']:.7f}, tilt of RM e_z {r['tilt_deg']:.4f} deg (the reference's CPU run: "
            f"{VIM_JAX_TILT_DEG:.4f} deg), tM {np.round(r['t'], 4).tolist()}")
    inertial_path_lines("inertial merge A", rec, Rs, ts, trk.loop_closer.events)
    log(f"inertial merge A (IMU_MONOCULAR on EuRoC's T_b_c1, {n} frames at {VIL_SIZE[0]}x{VIL_SIZE[1]}, "
        f"{VIL_FEATURES} features, blind {VIM_BLIND}, synchronous, loop closing on): at most {rep['maps_seen']} maps, "
        f"{trk.atlas.n_maps()} at the end, state {trk.state.name}, IMU stage {trk.map.imu_stage}; tracked "
        f"{rep['tracked']} of the {rep['n_outside']} frames outside the blind stretches; map {mid}'s IMU stages at "
        f"frames {rep['stages'].get(mid)}, its first keyframe (imu_t0) at frame {f0}, VIBA2 at frame {viba2}, "
        f"{viba2_kfs} keyframes from the reference's CPU offset ({VIM_JAX_VIBA2_AFTER_T0} frames after its imu_t0); "
        f"merges {[(r['frame'], r['src'], r['dst']) for r in welds]}, host ms of each merge "
        f"{[round(x, 1) for x in merge_ms]}, of merge_vi_ba {[round(x, 1) for x in vi_ba_ms]}, merge_eg spans "
        f"{n_eg}; loops {[(e['kf_frame'], e['match_frame']) for e in loops]}; CUDA graph captures by frame "
        f"{captures[1:]}")
    log(f"inertial merge A: scale-aligned ATE of the poses tracked while OK in a live map at the weld (frame "
        f"{weld.get('frame')}, {weld.get('n')} poses) {weld.get('ate', float('nan')):.6f} m (scale "
        f"{weld.get('scale', float('nan')):.4f}), bound max({VIM_JAX_WELD_ATE_M:.6f}, {VIM_PORT_WELD_ATE_M:.6f}) + "
        f"{TOL_LOOP_ATE_M} = {weld_bound:.6f} m; at the end {end['ate']:.6f} m (scale {end['scale']:.4f}) over "
        f"{end['n']} poses, bound max({VIM_JAX_ATE_M:.6f}, {VIM_PORT_ATE_M:.6f}) + {TOL_LOOP_ATE_M} = {end_bound:.6f} "
        f"m; with the {len(end['orphans'])} frames the reset discarded (ROADMAP R24: exported at the reset map's "
        f"keyframes) {weld.get('ate_all', float('nan')):.6f} m at the weld, {end['ate_all']:.6f} m at the end; plane "
        f"normal |n_z| {end['n_z']:.4f}; {np.median(rep['ms']):.1f} ms a frame median, {np.percentile(rep['ms'], 99):.1f} ms "
        f"p99, {rep['seconds']:.1f} s (host clock); describe launches {cnt}")
    report = dict(frames=n, tracked=rep["tracked"], outside=rep["n_outside"], maps_seen=rep["maps_seen"],
                  spawns=spawns, welds=welds, viba2=dict(map=mid, frame=viba2, imu_t0_frame=f0, kfs_apart=viba2_kfs),
                  merge_ms=merge_ms, merge_vi_ba_ms=vi_ba_ms, merge_eg=n_eg, weld=weld, end=end,
                  graphs=rec["graph"], gbas=rec["gba"],
                  loops=[dict(kf=e["kf"], match=e["match"], kf_frame=e["kf_frame"], match_frame=e["match_frame"],
                              deg=revisit(Rs, ts, e)[1]) for e in loops],
                  captures=captures[1:], launches_a=cnt, seconds_a=rep["seconds"],
                  ms_median=float(np.median(rep["ms"])), ms_p99=float(np.percentile(rep["ms"], 99)))
    if cnt != n or host != n:
        fail(f"inertial merge A: orb_describe ran {cnt} times on the card ({host} by the wrapper) for {n} frames")
    for g in rec["graph"]:
        if g["mode"] != "4dof" or not (g["gravity_moved"] < VIL_GRAVITY_TOL and g["scale_moved"] < VIL_GRAVITY_TOL):
            fail(f"inertial merge A: an essential graph in mode {g['mode']} moved a body gravity direction by "
                 f"{g['gravity_moved']:.3g} and a vertex scale by {g['scale_moved']:.3g} (4dof, < {VIL_GRAVITY_TOL})")
    if gate:
        if rep["maps_seen"] < 2:
            fail("inertial merge A: no second Atlas map after the first blind stretch")
        kinds = [r["kind"] for r in spawns]
        if kinds != ["spawn", "reset"]:
            fail(f"inertial merge A: spawns and resets {kinds} (one spawn, then one reset required)")
        s0, r1 = spawns
        if s0["map_id"] != 0 or s0["stage"] != 3 or s0["kfs"] < VIM_KEEP_MIN_KFS or s0["active_id"] == 0:
            fail(f"inertial merge A: the spawn kept map {s0['map_id']} at stage {s0['stage']} with {s0['kfs']} "
                 f"keyframes (map 0, stage 3, >= {VIM_KEEP_MIN_KFS} required)")
        if r1["active_id"] != r1["map_id"] or r1["active_kfs"] != 0 or r1["rows_left"] != 0:
            fail(f"inertial merge A: the reset left map {r1['active_id']} (map {r1['map_id']} required) with "
                 f"{r1['active_kfs']} keyframes and {r1['rows_left']} database rows (0 and 0 required)")
        if viba2_kfs is None or viba2_kfs > 1:
            fail(f"inertial merge A: map {mid}'s VIBA2 at frame {viba2}, {viba2_kfs} keyframes from the reference's "
                 "CPU frame (within one required)")
        if not welds or any(r["dst"] != 0 for r in welds):
            fail(f"inertial merge A: merges {[(r['src'], r['dst']) for r in welds]} (at least one, into map 0)")
        if len(vi_ba_ms) != len(welds) or n_eg:
            fail(f"inertial merge A: {len(vi_ba_ms)} merge_vi_ba and {n_eg} merge_eg spans for {len(welds)} merges "
                 "(one merge_vi_ba each and no merge_eg required)")
        if any(i >= s0["frame"] for i, _ in captures[1:]):
            fail(f"inertial merge A: CUDA graphs captured at frames {captures[1:]}: again at or after the spawn "
                 f"(frame {s0['frame']}), where no input shape changes")
        if any(not abs(r["s"] - 1.0) < VIM_WELD_SCALE_TOL for r in welds):
            fail(f"inertial merge A: weld scales {[r['s'] for r in welds]} (|sM - 1| < {VIM_WELD_SCALE_TOL} required)")
        if trk.atlas.n_maps() != 1 or trk.state.name != "OK" or trk.map.imu_stage != 3:
            fail(f"inertial merge A: {trk.atlas.n_maps()} maps, state {trk.state.name}, IMU stage {trk.map.imu_stage} "
                 "at the end (1, OK, 3 required)")
        if not rep["tracked"] > VIM_MIN_TRACKED * rep["n_outside"]:
            fail(f"inertial merge A: {rep['tracked']} of {rep['n_outside']} frames outside the blind stretches tracked "
                 f"(> {VIM_MIN_TRACKED} required)")
        if not weld.get("ate", float("inf")) <= weld_bound or not end["ate"] <= end_bound:
            fail(f"inertial merge A: scale-aligned ATE {weld.get('ate')} m at the weld (<= {weld_bound:.6f}), "
                 f"{end['ate']:.6f} m at the end (<= {end_bound:.6f})")
        if not abs(end["scale"] - 1.0) < VI_SCALE_TOL or not end["n_z"] > VI_GRAVITY_NZ:
            fail(f"inertial merge A: scale {end['scale']:.4f}, plane normal |n_z| {end['n_z']:.4f}")

    # Part B: the mono_inertial_euroc driver in the default mode on the same
    # frames as an EuRoC tree whose settings carry EuRoC's T_b_c1.
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        root = Path(tmp)
        write_euroc_tree(root, "BOB", stamps, frames, imu_rows=np.concatenate(rows[1:]))
        euroc_settings(root / "vim.yaml", scene, VI_FPS, imu_yaml(EUROC_T_B_C1))
        spied, recs, top = [], [], dict(maps=1, stage=0)

        def spy(system):
            trk_s = system.tracker
            spied.append(spy_dead_reckoned(trk_s))
            recs.append(record_atlas_path(trk_s))
            real = system.track_monocular

            def track(img, t, imu=None):
                out = real(img, t, imu=imu)
                top.update(maps=max(top["maps"], system.atlas.n_maps()), stage=max(top["stage"], trk_s.map.imu_stage))
                return out

            system.track_monocular = track

        read = counted(dev)
        t0 = time.perf_counter()
        system = run_driver("mono_inertial_euroc", [str(root / "vim.yaml"), str(root), "BOB", "--traj",
                                                    str(root / "t.txt"), "--kf-traj", str(root / "kf.txt"),
                                                    "--log-level", "WARNING", "--device", str(dev)], spy=spy)
        secs_b = time.perf_counter() - t0
        cnt_b, host_b = read()
        min_b = VIM_JAX_DRIVER_EXPORTED - LOOP_ASYNC_TRACKED_MARGIN if gate else 0
        ts_e, _, tracked_b = driver_poses("inertial merge B", root / "t.txt", n, 1.0 / VI_FPS, spied[0], min_b)
    trk_b = system.tracker
    ts_x, Twc_x = trk_b.export_trajectory()
    orphans_b = {f for r in recs[0]["spawn"] for f in r.get("orphans", ())}
    keep_b = np.asarray([int(round(t * VI_FPS)) not in spied[0] | orphans_b for t in ts_x], bool)
    per_map = per_map_ates(trk_b, ts_x, Twc_x, keep_b, stamps, ts)
    bound_b = ASYNC_ATE_FACTOR * end["ate"] + ASYNC_ATE_SLACK_M
    welds_b = recs[0]["weld"]
    report.update(exported_b=len(ts_e), tracked_b=int(tracked_b.sum()), maps_seen_b=top["maps"],
                  stage_b=int(top["stage"]), spawns_b=[(r["frame"], r["kind"]) for r in recs[0]["spawn"]],
                  merges_b=len(welds_b), lost_b=int(trk_b.n_lost_events), launches_b=cnt_b, seconds_b=secs_b,
                  maps_b={m: dict(ate=r.rmse_scaled, scale=r.scale, n=r.n_pairs) for m, r in per_map.items()})
    log(f"inertial merge B (mono_inertial_euroc with IMU.T_b_c1 = EuRoC's, default mode, {n} frames): {len(ts_e)} "
        f"poses exported, {int(tracked_b.sum())} tracked while OK; loss events {trk_b.n_lost_events}; at most "
        f"{top['maps']} maps, {trk_b.atlas.n_maps()} at the end; spawns and resets "
        f"{[(r['frame'], r['kind'], r['kfs']) for r in recs[0]['spawn']]}; the highest IMU stage {top['stage']}; "
        f"merges {[(r['frame'], r['src'], r['dst'], round(r['s'], 6)) for r in welds_b]} (the reference driver's "
        f"fewest in three CPU runs: {VIM_JAX_DRIVER_MERGES} merges, {VIM_JAX_DRIVER_EXPORTED} poses exported); per "
        "map with >= 10 tracked poses, scale-aligned ATE and scale: "
        + ", ".join(f"map {m} {r.rmse_scaled:.6f} m, {r.scale:.4f} over {r.n_pairs}" for m, r in per_map.items())
        + f" (the frames resets discarded left out, R24: {len(orphans_b)}); bound {ASYNC_ATE_FACTOR} x "
        f"{end['ate']:.6f} + {ASYNC_ATE_SLACK_M} = {bound_b:.6f} m; {secs_b:.1f} s; describe launches {cnt_b}")
    if cnt_b != n or host_b != n:
        fail(f"inertial merge B: orb_describe ran {cnt_b} times on the card ({host_b} by the wrapper) for {n} frames")
    if gate:
        if top["maps"] < 2:
            fail("inertial merge B: no second Atlas map")
        if len(welds_b) < VIM_JAX_DRIVER_MERGES:
            fail(f"inertial merge B: {len(welds_b)} merges (>= {VIM_JAX_DRIVER_MERGES} required)")
        if not per_map:
            fail("inertial merge B: no map holds 10 poses tracked while OK")
        for m, r in per_map.items():
            if not r.rmse_scaled <= bound_b:
                fail(f"inertial merge B: map {m}: scale-aligned ATE of the tracked poses {r.rmse_scaled:.6f} m "
                     f"(<= {bound_b:.6f} m required)")
    log(f"inertial merge: phase {time.perf_counter() - t_phase:.1f} s (host clock); {card_line()}")
    return cnt + cnt_b, worst, report


def solve_line(r):
    """A whole-chain solve's route, keyframes and stereo-row share."""
    share = r["stereo_rows"] / r["rows"] if r.get("rows") else 0.0
    return (f"{r.get('route')} route, {r.get('kfs')} keyframes, {r.get('stereo_rows')} of {r.get('rows')} rows "
            f"stereo ({share:.1%})")


def phase_stereo_inertial_long(dev, n_frames, gate):
    """Stereo-inertial past its init on the card (module docstring, phase
    19). Returns (describe launches, the describe kernel's angle error, a
    report)."""
    import os
    import tempfile

    import numpy as np

    from orbslam3_cpp_fork_tpu_torch.ops.orb import OrbParams
    from orbslam3_cpp_fork_tpu_torch.optim import inertial as vi
    from orbslam3_cpp_fork_tpu_torch.optim import pose_graph
    from orbslam3_cpp_fork_tpu_torch.runtime.tracker import Tracker
    from orbslam3_cpp_fork_tpu_torch.utils.evaluation import ate_rmse

    scene, stamps, Rs, ts, pairs, rows = render_stereo_inertial_long(n_frames=n_frames)
    orb_params = OrbParams(n_features=SIL_FEATURES)
    worst = max(hold_describe(f"the stereo inertial long scene's first pair, {side} ({SIL_SIZE[0]}x{SIL_SIZE[1]}, "
                              f"{SIL_FEATURES} features)", *frame_levels(dev, img, orb_params))
                for side, img in zip(("left", "right"), pairs[0]))

    # Part A: the synchronous tracker over every pair.
    trk = Tracker(stereo_inertial_long_config(scene), dev)
    rec = record_inertial_path(trk, vi, pose_graph, "optimize_pose_graph")
    read = counted(dev)
    stages, kf_frames, ms, n_tracked = {}, [], [], 0
    t0 = time.perf_counter()
    for i, (left, right) in enumerate(pairs):
        n_kf = trk.n_kf_inserted
        t1 = time.perf_counter()
        n_tracked += trk.track_stereo(left, right, float(stamps[i]), imu=rows[i]) is not None
        ms.append(1e3 * (time.perf_counter() - t1))
        stages.setdefault(int(trk.map.imu_stage), i)
        if trk.n_kf_inserted > n_kf:
            kf_frames.append(i)
    secs = time.perf_counter() - t0
    cnt, host = read()
    ts_est, Twc = trk.export_trajectory()
    ate = ate_rmse(ts_est, Twc[:, :3, 3], stamps, ts)
    pos = Twc[:, :3, 3] - Twc[:, :3, 3].mean(0)
    n_z = abs(float(np.linalg.svd(pos)[2][2][2]))
    loops = inertial_path_lines("stereo inertial long A", rec, Rs, ts, trk.loop_closer.events)
    names = {1: "IMU init", 2: "VIBA1", 3: "VIBA2"}
    f7 = [r for r in rec["fiba"] if r["loop_gba"]]
    log("stereo inertial long A: " + "; ".join(
        f"{names[s]} at frame {f} ({stamps[f]:.1f} s)" for s, f in sorted(stages.items()) if s in names))
    for r in rec["init"]:
        log(f"stereo inertial long A: IMU init at frame {r['frame']} (keyframe {r['kf']}): fix_scale {r['fix_scale']}, "
            f"took {r['ok']}, scale applied {r['s']!r}, largest change of a distance from the origin across it "
            f"{r['rescaled'] if r['rescaled'] is None else format(r['rescaled'], '.2e')} m, {r['ms']:.1f} ms "
            "(host clock, its FullInertialBA included)")
    for r in rec["fiba"]:
        log(f"stereo inertial long A: FullInertialBA at frame {r['frame']} (priors g/a {r['prior_g']:g}/"
            f"{r['prior_a']:g}, {r['iters']} iterations{', after a loop' if r['loop_gba'] else ''}): "
            f"{solve_line(r)}; {r['ms']:.1f} ms (host clock)")
    for j, ev in enumerate(loops):
        g = rec["graph"][j] if j < len(rec["graph"]) else {}
        log(f"stereo inertial long A: loop {j}: keyframes {ev['kf']} -> {ev['match']}, {g.get('mode')}, optical axes "
            f"{revisit(Rs, ts, ev)[1]:.1f} deg apart; host ms: essential graph {g.get('ms', float('nan')):.1f}, "
            f"FullInertialBA(7) {f7[j]['ms'] if j < len(f7) else float('nan'):.1f}")
    viba2 = stages.get(3)
    ref_at = next((j for j, f in enumerate(kf_frames) if f >= SIL_JAX_VIBA2_FRAME), len(kf_frames))
    viba2_kfs = abs(kf_frames.index(viba2) - ref_at) if viba2 in kf_frames else None
    bound = max(SIL_JAX_ATE_M, SIL_PORT_ATE_M) + TOL_LOOP_ATE_M
    n = len(pairs)
    report = dict(pairs=n, tracked=n_tracked, stages={names[s]: f for s, f in stages.items() if s in names},
                  inits=rec["init"], fiba=rec["fiba"], refinements=rec["refine"], graphs=rec["graph"],
                  gbas=rec["gba"], loops=[dict(kf=e["kf"], match=e["match"], kf_frame=e["kf_frame"],
                                               match_frame=e["match_frame"], deg=revisit(Rs, ts, e)[1]) for e in loops],
                  ate=ate.rmse, ate_scaled=ate.rmse_scaled, scale=ate.scale, n_z=n_z, launches_a=cnt, seconds_a=secs,
                  ms_median=float(np.median(ms)), ms_p99=float(np.percentile(ms, 99)))
    log(f"stereo inertial long A (IMU_STEREO on EuRoC's T_b_c1 and baseline, {n} pairs at {SIL_SIZE[0]}x{SIL_SIZE[1]}, "
        f"{SIL_FEATURES} features, synchronous, loop closing on): state {trk.state.name}, IMU stage "
        f"{trk.map.imu_stage}, tracked {n_tracked}/{n}; keyframes {trk.map.n_keyframes()}, landmarks "
        f"{trk.map.n_landmarks()}; VIBA2 at frame {viba2}, the reference's CPU run at {SIL_JAX_VIBA2_FRAME} "
        f"({viba2_kfs} keyframes apart); ScaleRefinement calls {len(rec['refine'])}; loops {len(loops)}, "
        f"FullInertialBA(7) after them {len(f7)}; unscaled ATE {ate.rmse:.6f} m (scale {ate.scale:.4f}, scale-aligned "
        f"{ate.rmse_scaled:.6f} m) over {ate.n_pairs} poses, bound max({SIL_JAX_ATE_M:.6f}, {SIL_PORT_ATE_M:.6f}) + "
        f"{TOL_LOOP_ATE_M} = {bound:.6f} m; plane normal |n_z| {n_z:.4f}; {np.median(ms):.1f} ms a pair median, "
        f"{np.percentile(ms, 99):.1f} ms p99, {secs:.1f} s in all (host clock); describe launches {cnt}; {card_line()}")
    if cnt != 2 * n or host != 2 * n:
        fail(f"stereo inertial long A: orb_describe ran {cnt} times on the card ({host} by the wrapper) for {n} pairs")
    if rec["refine"]:
        fail(f"stereo inertial long A: ScaleRefinement called {len(rec['refine'])} times (IMU_MONOCULAR only)")
    for g in rec["graph"]:
        if g["mode"] != "4dof" or not (g["gravity_moved"] < VIL_GRAVITY_TOL and g["scale_moved"] < VIL_GRAVITY_TOL):
            fail(f"stereo inertial long A: an essential graph in mode {g['mode']} moved a body gravity direction by "
                 f"{g['gravity_moved']:.3g} and a vertex scale by {g['scale_moved']:.3g} (4dof, < {VIL_GRAVITY_TOL})")
    if (len(rec["gba"]) != len(loops) or any(b["kind"] != "inertial" for b in rec["gba"])
            or [(r["iters"], r["prior_g"], r["prior_a"]) for r in f7] != [(7, 0.0, 0.0)] * len(loops)):
        fail(f"stereo inertial long A: global BAs after the {len(loops)} loops: {[b['kind'] for b in rec['gba']]}, "
             f"FullInertialBA(7) {len(f7)} (one each required)")
    took = [r for r in rec["init"] if r["ok"]]
    if len(took) != 1 or not took[0]["fix_scale"] or took[0]["s"] != 1.0:
        fail(f"stereo inertial long A: IMU inits {rec['init']} (one, with fix_scale and scale exactly 1, required)")
    if gate:
        if trk.state.name != "OK" or not n_tracked > VIL_MIN_TRACKED * n:
            fail(f"stereo inertial long A: state {trk.state.name}, {n_tracked} of {n} tracked (> {VIL_MIN_TRACKED} "
                 "required)")
        if trk.map.imu_stage != 3 or viba2_kfs is None or viba2_kfs > 1:
            fail(f"stereo inertial long A: IMU stage {trk.map.imu_stage}, VIBA2 at frame {viba2}, {viba2_kfs} keyframes "
                 f"from the reference's frame {SIL_JAX_VIBA2_FRAME} (within one required)")
        if not loops or any(revisit(Rs, ts, e)[1] > LOOP_REVISIT_DEG for e in loops):
            fail(f"stereo inertial long A: loops {[(e['kf_frame'], e['match_frame']) for e in loops]}: none, or not a "
                 f"true revisit (optical axes within {LOOP_REVISIT_DEG} deg required)")
        if not abs(ate.scale - 1.0) < STEREO_SCALE_TOL or not n_z > VI_GRAVITY_NZ:
            fail(f"stereo inertial long A: scale {ate.scale:.4f} (|s - 1| < {STEREO_SCALE_TOL}), plane normal |n_z| "
                 f"{n_z:.4f} (> {VI_GRAVITY_NZ})")
        if not ate.rmse <= bound:
            fail(f"stereo inertial long A: unscaled ATE {ate.rmse:.6f} m > {bound:.6f} m")

    # Part B: the stereo_inertial_euroc driver in the default mode on an
    # EuRoC tree of the same pairs, settings in the File.version 1.0 form
    # with EuRoC's bf, ThDepth and IMU.T_b_c1. Per map, as in phase 17's B.
    k = min(SIL_DRIVER_PAIRS, n)
    with tempfile.TemporaryDirectory(dir=os.environ.get("TMPDIR")) as tmp:
        root = Path(tmp)
        write_euroc_tree(root, "SIL", stamps[:k], pairs[:k], imu_rows=np.concatenate(rows[1:k]))
        euroc_settings(root / "sil.yaml", scene, VI_FPS,
                       f"Camera.bf: {SIL_BASELINE * float(scene.K[0, 0])!r}\nStereo.ThDepth: {SIL_TH_DEPTH!r}\n"
                       + imu_yaml(EUROC_T_B_C1), n_features=SIL_FEATURES)
        spied, recs, top = [], [], dict(stage=0, frame=None, n=0)

        def spy(system):
            trk_s = system.tracker
            spied.append(spy_dead_reckoned(trk_s))
            recs.append(record_inertial_path(trk_s, vi, pose_graph, "optimize_pose_graph"))
            real = system.track_stereo

            def track(left, right, t, imu=None):
                out = real(left, right, t, imu=imu)
                if trk_s.map.imu_stage > top["stage"]:
                    top.update(stage=int(trk_s.map.imu_stage), frame=top["n"])
                top["n"] += 1
                return out

            system.track_stereo = track

        read = counted(dev)
        t0 = time.perf_counter()
        system = run_driver("stereo_inertial_euroc", [str(root / "sil.yaml"), str(root), "SIL", "--traj",
                                                      str(root / "t.txt"), "--kf-traj", str(root / "kf.txt"),
                                                      "--log-level", "WARNING", "--device", str(dev)], spy=spy)
        secs_b = time.perf_counter() - t0
        cnt_b, host_b = read()
        ts_e, _, tracked = driver_poses("stereo inertial long B", root / "t.txt", k, 1.0 / VI_FPS, spied[0])
    trk_b = system.tracker
    ts_x, Twc_x = trk_b.export_trajectory()
    keep = np.asarray([int(round(t * VI_FPS)) not in spied[0] for t in ts_x], bool)
    per_map = per_map_ates(trk_b, ts_x, Twc_x, keep, stamps[:k], ts[:k])
    loops_b = inertial_path_lines("stereo inertial long B", recs[0], Rs, ts, trk_b.loop_closer.events)
    for r in recs[0]["bg"]:
        log(f"stereo inertial long B: background inertial global BA at keyframe {r['kf']} (frame {r['frame']}): "
            f"{solve_line(r)}")
    bound_b = ASYNC_ATE_FACTOR * ate.rmse + ASYNC_ATE_SLACK_M
    report.update(pairs_b=k, exported_b=len(ts_e), tracked_b=int(tracked.sum()), stage_b=top["stage"],
                  stage_b_frame=top["frame"], maps_b={m: dict(ate=r.rmse, scale=r.scale, n=r.n_pairs)
                                                      for m, r in per_map.items()},
                  lost_b=int(trk_b.n_lost_events), loops_b=len(loops_b), background_gbas_b=recs[0]["bg"],
                  launches_b=cnt_b, seconds_b=secs_b)
    log(f"stereo inertial long B (stereo_inertial_euroc, EuRoC's bf, ThDepth and IMU.T_b_c1, default mode, {k} pairs): "
        f"{len(ts_e)} poses exported, {int(tracked.sum())} tracked while OK; loss events {trk_b.n_lost_events}, maps "
        f"{len(trk_b.atlas.maps)}; the highest IMU stage {top['stage']} (first at pair {top['frame']}; the reference "
        f"driver's lowest in three CPU runs: {SIL_JAX_DRIVER_STAGE}); per map with >= 10 tracked poses, unscaled ATE "
        "and scale: " + ", ".join(f"map {m} {r.rmse:.6f} m, {r.scale:.4f} over {r.n_pairs}" for m, r in per_map.items())
        + f"; bound {ASYNC_ATE_FACTOR} x {ate.rmse:.6f} + {ASYNC_ATE_SLACK_M} = {bound_b:.6f} m; loops on the loop "
        f"thread {len(loops_b)} (the reference driver's fewest in three CPU runs: {SIL_JAX_DRIVER_LOOPS}); background "
        f"inertial global BAs {len(recs[0]['bg'])}; {secs_b:.1f} s; describe launches {cnt_b}")
    if cnt_b != 2 * k or host_b != 2 * k:
        fail(f"stereo inertial long B: orb_describe ran {cnt_b} times on the card ({host_b} by the wrapper) for {k} "
             "pairs")
    if gate:
        if top["stage"] < SIL_JAX_DRIVER_STAGE:
            fail(f"stereo inertial long B: the highest IMU stage {top['stage']} (>= {SIL_JAX_DRIVER_STAGE} required)")
        if not per_map:
            fail("stereo inertial long B: no map holds 10 poses tracked while OK")
        for m, r in per_map.items():
            if not abs(r.scale - 1.0) < STEREO_SCALE_TOL or not r.rmse <= bound_b:
                fail(f"stereo inertial long B: map {m}: scale {r.scale:.4f} (|scale - 1| < {STEREO_SCALE_TOL} "
                     f"required), unscaled ATE of the tracked poses {r.rmse:.6f} m (<= {bound_b:.6f} m required)")
        if len(loops_b) < SIL_JAX_DRIVER_LOOPS:
            fail(f"stereo inertial long B: {len(loops_b)} loops (>= {SIL_JAX_DRIVER_LOOPS} required)")
    return cnt + cnt_b, worst, report


def rot_err(Ra, Rb):
    """Largest angle (rad) between corresponding rotations, in float64 from
    the chord ||Ra - Rb||_F = 2 sqrt(2) sin(angle / 2) (arccos of the trace
    reads 5e-4 rad for equal float32 rotations)."""
    import numpy as np

    chord = np.linalg.norm(np.asarray(Ra, np.float64) - np.asarray(Rb, np.float64), axis=(-2, -1))
    return float((2.0 * np.arcsin(np.clip(chord / (2.0 * np.sqrt(2.0)), 0.0, 1.0))).max(initial=0.0))


def timed_solve(solve, prob, **kw):
    """(host result, host ms) of one local solve on the card."""
    import torch

    from orbslam3_cpp_fork_tpu_torch.parallel.launch import to_host

    if prob.Xw.is_cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = to_host(solve(prob, **kw))
    return res, (time.perf_counter() - t0) * 1e3


def phase_scale(dev, loop_trk, vi_trk):
    """The sharded whole-map BAs (module docstring, phase 14)."""
    import numpy as np
    import torch

    from orbslam3_cpp_fork_tpu_torch.entry import dryrun_multichip
    from orbslam3_cpp_fork_tpu_torch.optim import sparse_ba
    from orbslam3_cpp_fork_tpu_torch.parallel import launch

    n = SCALE_RANKS
    t0 = time.perf_counter()
    out = dryrun_multichip(n, device=dev.type)
    same = all(np.array_equal(out[0][k], o[k]) for o in out for k in ("kf_R", "kf_t", "lm_pos", "vi_twb", "vi_Xw"))
    log(f"scale: dryrun_multichip({n}) (gloo, every rank on {dev}): sharded global BAs {[o['sharded_solves'] for o in out]}, "
        f"{out[0]['gba_all_reduces']} all-reduces, ranks bitwise equal {same}; {time.perf_counter() - t0:.2f} s")
    if [o["sharded_solves"] for o in out] != [1] * n or not same:
        fail("scale: the dry run's global BA did not take the sharded path on every rank, or the ranks differ")

    # Loop A's final map: its whole-map BA as the tracker builds it.
    snap = loop_trk._gba_gather()
    prob = loop_trk._gba_problem(snap)
    iters = loop_trk.cfg.gba_iters
    kw = dict(iters=iters, gate_at=max(2, iters // 2))
    kf, lm = snap["kf_valid"], snap["lm_valid"]
    log(f"scale: loop A's final map: {int(kf.sum())} keyframes, {int(lm.sum())} landmarks, {snap['n_obs']} "
        f"observations (padded to {prob.obs_kf.shape[0]}; capacities {kf.size} keyframes, {lm.size} landmarks); "
        f"schedule {kw}, 60 CG iterations")
    cost0 = float(sparse_ba.sparse_ba(prob, iters=0).cost)
    local, local_ms = timed_solve(sparse_ba.sparse_ba, prob, **kw)
    # The inertial phase's map: its FullInertialBA over the whole chain, in
    # the sparse solver's capacities (the foreground solve's schedule).
    m = vi_trk.map
    ks = np.nonzero(m.kf_valid)[0]
    cap = vi_trk.cfg.vi_full_kf_cap
    vi_trk.cfg.vi_full_kf_cap = 0
    try:
        built, sparse = vi_trk._full_vi_problem(int(ks[np.argmax(m.kf_frame_id[ks])]))
    finally:
        vi_trk.cfg.vi_full_kf_cap = cap
    if not sparse or built is None:
        fail("scale: the inertial map's FullInertialBA problem was not built for the sparse solver")
    vprob, vkfs, vlms = built[0], built[1], built[2]
    kw_vi = dict(iters=15, gate_at=8)
    log(f"scale: the inertial phase's FullInertialBA: {len(vkfs)} keyframes, {len(vlms)} landmarks, "
        f"{int(vprob.obs_valid.sum())} observations (padded to {vprob.obs_kf.shape[0]}); schedule {kw_vi}, 80 CG "
        f"iterations")
    vcost0 = float(sparse_ba.sparse_vi_ba(vprob, iters=0).cost)
    vlocal, vlocal_ms = timed_solve(sparse_ba.sparse_vi_ba, vprob, **kw_vi)

    host_p, host_v = launch.to_host(prob), launch.to_host(vprob)
    jobs = [(host_p, kw), (host_p, kw), (host_v, kw_vi), (host_v, kw_vi)]
    t0 = time.perf_counter()
    ranks = launch.run_ranks(launch.solve_sharded, n, jobs, device=dev.type, backend="gloo")
    spawn_s = time.perf_counter() - t0
    for j in range(len(jobs)):
        for r in range(1, n):
            for k, v in vars(ranks[0][j]["result"]).items():
                if isinstance(v, np.ndarray) and not np.array_equal(v, getattr(ranks[r][j]["result"], k)):
                    fail(f"scale: job {j}: rank {r}'s {k} differs from rank 0's")
    for a, b in ((0, 1), (2, 3)):
        for k, v in vars(ranks[0][a]["result"]).items():
            if isinstance(v, np.ndarray) and not np.array_equal(v, getattr(ranks[0][b]["result"], k)):
                fail(f"scale: the second sharded run's {k} differs from the first's (jobs {a}, {b})")
    sh, vsh = ranks[0][0]["result"], ranks[0][2]["result"]
    d_t = float(np.abs(sh.t[kf] - local.t[kf]).max())
    d_R = rot_err(sh.R[kf], local.R[kf])
    d_X = float(np.abs(sh.Xw[lm] - local.Xw[lm]).max())
    nk, nl = len(vkfs), len(vlms)
    v_t = float(np.abs(vsh.twb[:nk] - vlocal.twb[:nk]).max())
    v_X = float(np.abs(vsh.Xw[:nl] - vlocal.Xw[:nl]).max())
    bits = {name: all(np.array_equal(getattr(a, k), getattr(b, k)) for k in fields)
            for name, a, b, fields in (("visual", sh, local, ("R", "t", "Xw", "cost", "obs_inlier")),
                                       ("inertial", vsh, vlocal, ("Rwb", "twb", "vel", "bg", "ba", "Xw", "cost")))}
    ms = [[round(job["ms"], 1) for job in r] for r in ranks]
    log(f"scale: visual global BA: local on the card {local_ms:.1f} ms, sharded over {n} gloo ranks on {dev} "
        f"{ms[0][0]:.1f} and {ms[0][1]:.1f} ms (rank 0; every rank {ms}), {ranks[0][0]['all_reduces']} all-reduces a "
        f"solve; cost {cost0:.3f} -> local {float(local.cost):.3f}, sharded {float(sh.cost):.3f}; sharded vs local t "
        f"{d_t:.3g} m, R {d_R:.3g} rad, Xw {d_X:.3g} m (bitwise equal to the local solve: {bits['visual']}); ranks "
        f"and runs bitwise equal")
    log(f"scale: FullInertialBA (sparse): local {vlocal_ms:.1f} ms, sharded {ms[0][2]:.1f} and {ms[0][3]:.1f} ms, "
        f"{ranks[0][2]['all_reduces']} all-reduces a solve; cost {vcost0:.3f} -> local {float(vlocal.cost):.3f}, "
        f"sharded {float(vsh.cost):.3f}; sharded vs local twb {v_t:.3g} m, Xw {v_X:.3g} m (bitwise equal to the local "
        f"solve: {bits['inertial']}); ranks and runs bitwise equal; {spawn_s:.2f} s for the ranks' start and the four "
        f"sharded solves")
    if not (d_t <= SCALE_TOL_POSE and d_R <= SCALE_TOL_POSE and d_X <= SCALE_TOL_LM):
        fail(f"scale: sharded vs local visual BA: t {d_t:.3g}, R {d_R:.3g} (<= {SCALE_TOL_POSE}), Xw {d_X:.3g} "
             f"(<= {SCALE_TOL_LM}) required")
    if not (v_t <= SCALE_TOL_LM and v_X <= SCALE_TOL_LM):
        fail(f"scale: sharded vs local FullInertialBA: twb {v_t:.3g}, Xw {v_X:.3g} (<= {SCALE_TOL_LM} required)")
    if not (float(local.cost) < cost0 and float(sh.cost) < cost0 and float(vlocal.cost) < vcost0
            and float(vsh.cost) < vcost0):
        fail("scale: a solve did not lower the cost")

    if torch.cuda.device_count() > 1:
        ranks = launch.run_ranks(launch.solve_sharded, n, jobs[:1], device=dev.type, backend="nccl")
        r0 = ranks[0][0]["result"]
        same = all(np.array_equal(getattr(r0, k), getattr(r[0]["result"], k)) for r in ranks for k in ("R", "t", "Xw"))
        d_t = float(np.abs(r0.t[kf] - local.t[kf]).max())
        log(f"scale: NCCL, one card per rank: {ranks[0][0]['ms']:.1f} ms, ranks bitwise equal {same}, t vs local {d_t:.3g} m")
        if not same or not d_t <= SCALE_TOL_POSE:
            fail("scale: the NCCL run's ranks differ, or it is off the local solve")
    else:
        log("scale: NCCL with one card per rank skipped: this machine has one card")


def phase_profile_slam(dev, scene, frames, orb_params):
    """torch.profiler over the SLAM phase's frames after initialization:
    kernel launches and device time per tracked frame and per mapping step
    (a keyframe frame less an average tracked frame)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    trk = make_slam_tracker(dev, scene, orb_params)
    acc = {False: [0, 0, 0.0], True: [0, 0, 0.0]}  # keyframe frame? -> [frames, kernels, device us]
    by_kernel: dict[str, list] = {}  # keyframe frames only: kernel name -> [launches, device us]
    for i, f in enumerate(frames):
        kfs0 = trk.n_kf_inserted
        if kfs0 == 0:
            trk.track(f, i * 0.05)
            continue
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            trk.track(f, i * 0.05)
            torch.cuda.synchronize()
        ks = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and not e.key.startswith(("Memcpy", "Memset"))]
        is_kf = trk.n_kf_inserted > kfs0
        a = acc[is_kf]
        a[0] += 1
        a[1] += sum(e.count for e in ks)
        a[2] += sum(device_us(e) for e in ks)
        if is_kf:
            for e in ks:
                b = by_kernel.setdefault(e.key, [0, 0.0])
                b[0] += e.count
                b[1] += device_us(e)
    (nt, kt, ut), (nk, kk, uk) = acc[False], acc[True]
    if nt:
        log(f"profile: slam: tracked frame without a keyframe ({nt}): {kt / nt:.1f} kernel launches, "
            f"{ut / nt / 1e3:.3f} ms of device time")
    if nt and nk:
        log(f"profile: slam: keyframe frame ({nk}): {kk / nk:.1f} kernel launches, {uk / nk / 1e3:.3f} ms of device "
            f"time; less a tracked frame, one mapping step: {kk / nk - kt / nt:.1f} launches, "
            f"{(uk / nk - ut / nt) / 1e3:.3f} ms of device time")
        for key, (cnt, us) in sorted(by_kernel.items(), key=lambda kv: -kv[1][1])[:8]:
            log(f"profile: slam: keyframe frames: {us / nk / 1e3:.3f} ms, {cnt / nk:.1f} launches a frame: {key[:90]}")


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
    total = sum(device_us(e) for e in ks)
    log(f"profile: {n} frames: {count / n:.1f} kernel launches per frame, {total / n / 1e3:.3f} ms of device "
        f"time per frame")
    for e in ks:
        if "orb_describe" in e.key or "patch_gather" in e.key:
            log(f"profile: kernel {e.key[:60]}: {e.count} launches, {device_us(e) / e.count:.2f} us of device time each")
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
            f"launches, {sum(device_us(e) for e in ks) / calls:.2f} us of device time ({calls} calls)")


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


def parallel_part(dev, frames, long_state=None, started=None):
    """The drivers, long and merge phases: run in a process of their own,
    beside the other phases (the paths are host-bound and the host has cores
    to spare); the last line of output is their record."""
    from orbslam3_cpp_fork_tpu_torch.ops.orb import OrbParams

    gate = frames == FRAMES
    t0 = time.perf_counter()
    drivers_launches, drivers_err, cd_launches, drivers = phase_drivers(dev, gate_ate=gate)
    log(f"smoke: drivers phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    long_launches, long_report = phase_long(dev, LONG_FRAMES if gate else min(frames, LONG_FRAMES), gate, long_state)
    log(f"smoke: long phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    merge_launches, merge_err = phase_merge(dev, OrbParams(n_features=N_FEATURES), gate_ate=gate)
    log(f"smoke: merge phase {time.perf_counter() - t0:.1f} s")
    if started is not None:
        log(f"smoke: this process (drivers, long and merge) {time.perf_counter() - started:.1f} s from its start")
    log(json.dumps({"parallel": {
        "launches_drivers": drivers_launches, "launches_long": long_launches, "describe_err": drivers_err,
        "launches_compute_descriptors": cd_launches, "drivers": drivers, "long": long_report,
        "launches_merge": merge_launches, "merge_describe_err": merge_err,
    }}))


def inertial_long_part(dev, frames, started=None):
    """The stereo and inertial long phases: run in a second process of their
    own, beside the other phases; the last line of output is their record
    (the stereo phase's part A ATE is the shell phase's bound for its stereo
    driver)."""
    from orbslam3_cpp_fork_tpu_torch.ops.orb import OrbParams

    gate = frames == FRAMES
    t0 = time.perf_counter()
    stereo_launches, rgbd_launches, stereo_err, stereo_ate = phase_stereo(dev, OrbParams(n_features=N_FEATURES),
                                                                          gate_ate=gate)
    log(f"smoke: stereo phase {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches, err, report = phase_inertial_long(dev, VIL_FRAMES if gate else min(frames, VIL_FRAMES), gate)
    log(f"smoke: inertial long phase {time.perf_counter() - t0:.1f} s")
    if started is not None:
        log(f"smoke: this process (stereo and inertial long) {time.perf_counter() - started:.1f} s from its start")
    log(json.dumps({"inertial_long": {"launches": launches, "describe_err": err, "report": report,
                                      "launches_stereo": stereo_launches, "launches_rgbd": rgbd_launches,
                                      "stereo_describe_err": stereo_err, "stereo_ate": stereo_ate}}))


def inertial_merge_part(dev, frames):
    """The inertial merge phase (in the third child process); returns its
    record."""
    gate = frames == FRAMES
    t0 = time.perf_counter()
    launches, err, report = phase_inertial_merge(dev, VIM_FRAMES if gate else min(frames, VIM_FRAMES), gate)
    log(f"smoke: inertial merge phase {time.perf_counter() - t0:.1f} s")
    return {"inertial_merge": {"launches": launches, "describe_err": err, "report": report}}


def stereo_inertial_part(dev, frames):
    """The stereo inertial long phase (in the third child process, after
    the inertial merge phase); returns its record."""
    gate = frames == FRAMES
    t0 = time.perf_counter()
    launches, err, report = phase_stereo_inertial_long(dev, SIL_FRAMES if gate else min(frames, SIL_FRAMES), gate)
    log(f"smoke: stereo inertial long phase {time.perf_counter() - t0:.1f} s")
    return {"stereo_inertial": {"launches": launches, "describe_err": err, "report": report}}


def start_parallel_part(frames, part="--parallel-part", extra=()):
    """Start a part (`parallel_part`, `inertial_long_part`,
    `inertial_merge_part`, `stereo_inertial_part`) in a child
    process (output in temporary files; killed at exit if still running)."""
    import atexit
    import tempfile

    out, err = tempfile.TemporaryFile(mode="w+"), tempfile.TemporaryFile(mode="w+")
    proc = subprocess.Popen([sys.executable, str(Path(__file__).resolve()), part, "--frames", str(frames), *extra],
                            stdout=out, stderr=err, text=True)

    def stop():
        if proc.poll() is None:
            proc.kill()
            proc.wait()

    atexit.register(stop)
    return proc, out, err, time.perf_counter()


def collect_parallel_part(child, deadline, key="parallel", name="the drivers and long phases", whole=False):
    """Wait for the child until `deadline` (perf_counter), print its output
    and its wall time and return its record (`key`'s, or with `whole` every
    key of its last line); its failure fails the smoke."""
    proc, out, err, started = child
    try:
        rc = proc.wait(timeout=max(1.0, deadline - time.perf_counter()))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        rc = None
    out.seek(0)
    err.seek(0)
    lines, errs = out.read().splitlines(), err.read()
    for line in lines[:-1]:
        log(line)
    log(f"smoke: the process of {name} collected {time.perf_counter() - started:.1f} s after its start (host clock)")
    if rc != 0 or not lines or not lines[-1].startswith('{"' + key + '"'):
        sys.stderr.write(errs[-8000:])
        fail(f"the process of {name} ended with {'a timeout' if rc is None else f'exit {rc}'}")
    return json.loads(lines[-1]) if whole else json.loads(lines[-1])[key]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=FRAMES,
                    help="frames to track in the tracked phases; any other count than the default skips the ATE gates")
    ap.add_argument("--profile", type=int, default=0, metavar="N",
                    help="also profile N tracked frames with torch.profiler (default: off)")
    ap.add_argument("--compare-routes", action="store_true",
                    help="also time the tracker with the describe stage by either route, in alternating blocks")
    ap.add_argument("--parallel-part", action="store_true",
                    help="run only the drivers and long phases (the smoke runs them so, in a child process)")
    ap.add_argument("--inertial-long-part", action="store_true",
                    help="run only the inertial long phase (the smoke runs it so, in a second child process)")
    ap.add_argument("--inertial-merge-part", action="store_true",
                    help="run only the inertial merge phase (the smoke runs it so, in a third child process)")
    ap.add_argument("--stereo-inertial-part", action="store_true",
                    help="run only the stereo inertial long phase (the smoke runs it in its third child process, "
                         "after the inertial merge phase)")
    ap.add_argument("--loop-scale-probe", action="store_true",
                    help="run only loop A and loop B plain and at forced loop scales (ROADMAP R25), then exit")
    ap.add_argument("--long-state", metavar="PATH",
                    help="also write what keyframe culling reads of the long run's final map to PATH (.npz; "
                         "tests/data/long_card_cull_state.npz was written so)")
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

    t_smoke = time.perf_counter()
    if args.parallel_part or args.inertial_long_part or args.inertial_merge_part or args.stereo_inertial_part:
        dev = get_device()
        for name in _kernels.build_all():  # built already by the parent, or built here when run alone: loaded
            _kernels.load(name)
        if args.parallel_part:
            parallel_part(dev, args.frames, args.long_state, t_smoke)
        elif args.inertial_long_part:
            inertial_long_part(dev, args.frames, t_smoke)
        else:
            # The third child runs both phases in turn: a fifth process
            # beside the others doubled their host time a frame (PERF.md,
            # Findings).
            record, names = {}, []
            if args.inertial_merge_part:
                record.update(inertial_merge_part(dev, args.frames))
                names.append("inertial merge")
            if args.stereo_inertial_part:
                record.update(stereo_inertial_part(dev, args.frames))
                names.append("stereo inertial long")
            log(f"smoke: this process ({' and '.join(names)}) {time.perf_counter() - t_smoke:.1f} s from its start")
            log(json.dumps(record))
        return 0
    card = card_line()
    log(f"device: {card}")
    dev = get_device()

    t0 = time.perf_counter()
    names = _kernels.build_all()
    for name in names:
        _kernels.load(name)
    log(f"build: {', '.join(n + '.cu' for n in names)} in parallel in {time.perf_counter() - t0:.2f} s")
    if args.loop_scale_probe:
        loop_scale_probe(dev, OrbParams(n_features=N_FEATURES))
        return 0
    for name in names:
        secs, ptxas = _kernels.build_info.get(name, (0.0, ""))
        log(f"build: {name}.cu: nvcc {secs:.2f} s")
        for line in ptxas.strip().splitlines():
            log(f"build: {name}: {line.strip()}")

    child = start_parallel_part(args.frames, extra=["--long-state", args.long_state] if args.long_state else [])
    child_vil = start_parallel_part(args.frames, "--inertial-long-part")
    child_vim = start_parallel_part(args.frames, "--inertial-merge-part", ["--stereo-inertial-part"])
    laps = [time.perf_counter()]

    def lap(name):
        laps.append(time.perf_counter())
        log(f"smoke: {name} {laps[-1] - laps[-2]:.1f} s (host clock)")

    orb_params = OrbParams(n_features=N_FEATURES)
    scene, Rs, ts, frames = render_ring(args.frames)
    inputs = frame_levels(dev, frames[0], orb_params)
    gather = phase_kernel_gather(dev, inputs)
    describe = phase_kernel_describe(dev, inputs)
    phase_kernel_profile(dev, inputs, gather, describe)
    make = make_tracker_factory(dev, scene, Rs, ts, orb_params, CAPACITY, KF_EVERY)
    describe_launches = phase_main(
        dev, make, ts, frames, min(CPU_CHECK, args.frames), gate_ate=args.frames == FRAMES
    )
    gather_launches, per_level_us = phase_per_level_path(dev, frames[: min(PER_LEVEL_FRAMES, args.frames)], orb_params)
    lap("kernel, main and per-level")
    slam_launches, slam = phase_slam(dev, scene, ts, frames, orb_params, gate_ate=args.frames == FRAMES)
    async_launches = phase_async(dev, scene, ts, frames, orb_params, slam, gate_ate=args.frames == FRAMES)
    if args.frames >= LADDER_FRAMES:
        phase_ladder(dev, scene, frames, orb_params)
    lap("slam, async and ladder")
    loop_launches, loop_trk = phase_loop(dev, orb_params, gate_ate=args.frames == FRAMES)
    lap("loop")
    inertial_launches, inertial_describe_err, vi_ate, vi_trk = phase_inertial(
        dev, orb_params, gate_ate=args.frames == FRAMES)
    lap("inertial")
    entry_launches = phase_entry(dev)
    lap("entry")
    vil = collect_parallel_part(child_vil, t_smoke + PARALLEL_DEADLINE_S, "inertial_long",
                                "the stereo and inertial long phases")
    shell_launches = phase_shell(dev, orb_params, vil["stereo_ate"], vi_ate, gate_ate=args.frames == FRAMES)
    lap("shell")
    phase_scale(dev, loop_trk, vi_trk)
    lap("scale")
    log(f"smoke: the phases of this process ended at {time.perf_counter() - t_smoke:.1f} s")
    par = collect_parallel_part(child, t_smoke + PARALLEL_DEADLINE_S, name="the drivers, long and merge phases")
    vim = collect_parallel_part(child_vim, t_smoke + PARALLEL_DEADLINE_S, "inertial_merge",
                                "the inertial merge and stereo inertial long phases", whole=True)
    vim, sil = vim["inertial_merge"], vim["stereo_inertial"]
    if args.compare_routes:
        phase_compare_routes(dev, make, frames)
    if args.profile:
        phase_profile(dev, make, frames, orb_params, min(args.profile, args.frames - 2))
        # The profiler costs seconds a frame: the first frames only.
        phase_profile_slam(dev, scene, frames[:SLAM_PROFILE_FRAMES], orb_params)

    tpu_kernel = "orbslam3_cpp_fork_tpu/ops/patches.py:50"
    record = {"kernels": [
        {
            "name": "orb_describe", "route": "cuda",
            "source": "orbslam3_cpp_fork_tpu_torch/csrc/orb_describe.cu", "replaces": tpu_kernel,
            # One launch a frame on every mono path: localization-only
            # tracking, the synchronous cold-start SLAM run, the
            # asynchronous one, the loop phase's runs (A twice, B, C) and
            # the inertial phase's (A twice, B), two a pair in the inertial
            # phase's C; one a call of entry()'s fn; one a frame and two a
            # pair through the drivers of the shell phase; each counted
            # from 0. In a process of their own: one a frame and two a pair
            # through the drivers phase's ten drivers, one a frame of the
            # long phase and of the merge phase's runs (A twice, B, C); in a
            # second: two a stereo pair and one an RGB-D frame of the stereo
            # phase, one a frame of the inertial long phase's parts A and B;
            # in a third: one a frame of the inertial merge phase's parts A
            # and B, then two a pair of the stereo inertial long phase's
            # parts A and B.
            "launches": describe_launches + slam_launches + async_launches + loop_launches + vil["launches_stereo"]
            + vil["launches_rgbd"] + par["launches_merge"] + inertial_launches + entry_launches + shell_launches
            + par["launches_drivers"] + par["launches_long"] + vil["launches"] + vim["launches"] + sil["launches"],
            "launches_localization": describe_launches, "launches_slam": slam_launches,
            "launches_async": async_launches, "launches_loop": loop_launches,
            "launches_stereo": vil["launches_stereo"], "launches_rgbd": vil["launches_rgbd"],
            "launches_merge": par["launches_merge"], "launches_inertial": inertial_launches,
            "launches_entry": entry_launches, "launches_shell": shell_launches,
            "launches_drivers": par["launches_drivers"], "launches_long": par["launches_long"],
            "launches_inertial_long": vil["launches"], "launches_inertial_merge": vim["launches"],
            "launches_stereo_inertial_long": sil["launches"],
            "max_abs_err": max(describe["max_abs_err"], vil["stereo_describe_err"], par["merge_describe_err"],
                               inertial_describe_err, par["describe_err"], vil["describe_err"], vim["describe_err"],
                               sil["describe_err"]),
            "ms": describe["ms"], "plain_ms": describe["plain_ms"],
            "bound_ms": describe["bound_ms"], "bound_by": describe["bound_by"],
            # No single PyTorch call gathers windows, sums moments and
            # compares rotated pixel pairs.
            "library_ms": None,
            "device_us": describe["device_us"],
            "per_level_route_ms": describe["per_level_ms"],
        },
        {
            "name": "patch_gather_dual", "route": "cuda",
            "source": "orbslam3_cpp_fork_tpu_torch/csrc/patch_gather.cu", "replaces": tpu_kernel,
            # 1 a frame of the per-level route (all 8 levels); 1 a call of
            # orb.compute_descriptors (the drivers phase's process).
            "launches": gather_launches + par["launches_compute_descriptors"],
            "launches_per_level": gather_launches,
            "launches_compute_descriptors": par["launches_compute_descriptors"],
            "max_abs_err": gather["max_abs_err"],
            "ms": gather["ms"], "plain_ms": gather["plain_ms"],
            "bound_ms": gather["bound_ms"], "bound_by": gather["bound_by"],
            # The plain version is ~10 clamps and an advanced-indexing read;
            # no single PyTorch call gathers clamped windows.
            "library_ms": None,
            "device_us": gather["device_us"], "per_level_device_us": per_level_us,
        },
    ]}
    log(f"smoke: {time.perf_counter() - t_smoke:.1f} s in all")
    log(json.dumps(record))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
