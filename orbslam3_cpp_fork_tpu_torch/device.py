"""Device selection and the package's one precision switch.

Counterpart of the reference's import-time
`jax_default_matmul_precision=highest` (orbslam3_cpp_fork_tpu/__init__.py):
SLAM estimation is chains of small f32 products (rotation chains, 6x6
normal equations), and reduced-precision passes measurably corrupt them
(the reference's sync-control ATE went from 0.047 to 0.168 m with bf16
passes). On Hopper the same trap is TF32, which cuDNN convolutions use by
default. `get_device` turns both TF32 switches off before any work runs.
"""

from __future__ import annotations

import numpy as np
import torch


def get_device(name: str | torch.device = "cuda") -> torch.device:
    """Resolve a device; raise if CUDA is meant and absent.

    The package runs on the card unless the caller asks for the CPU: with
    no argument this is the current CUDA card, and on a machine without
    one that is an error rather than a silent CPU run. Callers that mean
    the CPU (the parity tests) say "cpu". A bare "cuda" resolves to the
    current card's index.
    """
    dev = torch.device(name)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {dev} requested but CUDA is not available")
        if dev.index is None:  # "cuda" -> "cuda:<current>", so devices compare equal
            dev = torch.device("cuda", torch.cuda.current_device())
    # Full-f32 matmuls and convolutions on CUDA (no TF32).
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


# Result blocks fetched from a device since the process started (each is
# one host sync); the smoke run reports it per frame and per mapping step.
n_fetches = 0


def fetch_block(tensors) -> list[np.ndarray]:
    """Copy a group of tensors to the host as numpy arrays in ONE transfer.

    On a CUDA device the tensors are packed into one byte buffer on the
    device, copied once (one host sync) and split again on the host; each
    array keeps its shape and dtype (bool, integer or float). CPU tensors
    are returned as numpy views of copies.
    """
    global n_fetches
    tensors = [t.detach() for t in tensors]
    if not tensors:
        return []
    if tensors[0].device.type == "cpu":
        return [t.clone().numpy() for t in tensors]
    n_fetches += 1
    flat = torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        n = t.numel() * t.element_size()
        dtype = np.bool_ if t.dtype == torch.bool else torch.empty(0, dtype=t.dtype).numpy().dtype
        out.append(flat[at : at + n].view(dtype).reshape(tuple(t.shape)).copy())
        at += n
    return out
