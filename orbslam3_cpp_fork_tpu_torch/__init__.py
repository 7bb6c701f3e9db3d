"""orbslam3_cpp_fork_tpu_torch — the PyTorch/CUDA port of orbslam3_cpp_fork_tpu.

The JAX package `orbslam3_cpp_fork_tpu` is the reference; this package
mirrors its layout and names module for module, in PyTorch idiom: plain
functions on tensors, small dataclasses in place of pytrees, an explicit
`device` on every entry point and no global default device. It never
imports JAX (nor the reference package, whose `__init__` imports JAX).

Ported so far: the per-frame tracking path (`runtime/device_step.py:
fused_frame_program`) and the localization-only tracker that chains it
(`runtime/localization.py`). The one TPU (Pallas) kernel on that path, the
patch gather, is a hand-written CUDA kernel for Hopper
(`csrc/patch_gather.cu`, bound in `ops/_kernels.py`).

Subpackages
-----------
utils     SE(3)/SO(3) helpers, ATE evaluation.
ops       Pyramid and blur, cameras, ORB (FAST, selection, patches, BRIEF),
          Hamming matching; the CUDA patch-gather kernel's loader.
optim     Reprojection residuals and motion-only pose optimization.
runtime   Landmark projection, the fused per-frame program, localization.
datasets  Synthetic sequences (numpy) and a seeded localization map.
"""

__version__ = "0.1.0"
