"""orbslam3_cpp_fork_tpu_torch — the PyTorch/CUDA port of orbslam3_cpp_fork_tpu.

The JAX package `orbslam3_cpp_fork_tpu` is the reference; this package
mirrors its layout and names module for module, in PyTorch idiom: plain
functions on tensors, small dataclasses in place of pytrees, an explicit
`device` on every entry point and no global default device. It never
imports JAX (nor the reference package, whose `__init__` imports JAX).

Ported so far: the per-frame tracking path (`runtime/device_step.py:
fused_frame_program`), the localization-only tracker that chains it
(`runtime/localization.py`), and monocular SLAM from a cold start in
synchronous mode (`runtime/tracker.py: MonoTracker`): two-view
initialization, the map model, triangulation, duplicate fusion, culling and
window bundle adjustment. The one TPU (Pallas) kernel of the reference, the
patch gather with its angle and descriptor consumers, is a hand-written
CUDA kernel for Hopper (`csrc/orb_describe.cu`, and `csrc/patch_gather.cu`
for the gather alone; both bound in `ops/_kernels.py`).

Subpackages
-----------
utils     SE(3)/SO(3) helpers, ATE evaluation, stage timers.
ops       Pyramid and blur, cameras, ORB (FAST, selection, patches, BRIEF),
          Hamming matching, two-view geometry and reconstruction; the CUDA
          kernels' loader.
optim     Reprojection residuals, motion-only pose optimization, window BA.
models    The map as fixed-capacity numpy structure-of-arrays state.
native    The C++ covisibility graph (ctypes; numpy fallback in the map).
runtime   Landmark projection, the fused per-frame program, localization,
          the synchronous monocular tracker and its mapping programs.
datasets  Synthetic sequences (numpy) and a seeded localization map.
"""

__version__ = "0.1.0"
