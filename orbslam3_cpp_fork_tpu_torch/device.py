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


def _pack(tensors) -> torch.Tensor:
    """A group of device tensors as one flat byte tensor on the device."""
    return torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in tensors])


def _split(flat: np.ndarray, tensors) -> list[np.ndarray]:
    """The packed bytes back as one array per tensor, each a copy with the
    tensor's shape and dtype (bool, integer or float)."""
    out, at = [], 0
    for t in tensors:
        n = t.numel() * t.element_size()
        dtype = np.bool_ if t.dtype == torch.bool else torch.empty(0, dtype=t.dtype).numpy().dtype
        out.append(flat[at : at + n].view(dtype).reshape(tuple(t.shape)).copy())
        at += n
    return out


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
    return _split(_pack(tensors).cpu().numpy(), tensors)


class AsyncFetch:
    """A result block on its way to the host (see `fetch_block_async`).
    `get()` waits for this block's copy only and returns the arrays."""

    def __init__(self, tensors, host: torch.Tensor | None, event):
        self._tensors = tensors  # shapes and dtypes; CPU tensors are the data
        self._host = host
        self._event = event

    def get(self) -> list[np.ndarray]:
        if self._host is None:
            return [t.numpy() for t in self._tensors]
        self._event.synchronize()
        return _split(self._host.numpy(), self._tensors)


def block_nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def fetch_block_async(tensors, pinned: torch.Tensor | None = None) -> AsyncFetch:
    """The asynchronous form of `fetch_block`: pack the block on the device,
    start ONE copy into a pinned host buffer on the current stream, record
    an event behind it and return at once. `AsyncFetch.get()` waits on that
    event alone, so fetching a block that has landed costs no device-wide
    sync. `pinned` is a pinned uint8 buffer of at least the block's size
    that the caller keeps alive and does not hand out again before `get()`
    (one per slot of a pipeline); without it a buffer is allocated here.
    CPU tensors are copied and returned at once.
    """
    tensors = [t.detach() for t in tensors]
    if not tensors or tensors[0].device.type == "cpu":
        return AsyncFetch([t.clone() for t in tensors], None, None)
    n = block_nbytes(tensors)
    if pinned is None:
        pinned = torch.empty(n, dtype=torch.uint8, pin_memory=True)
    elif not pinned.is_pinned() or pinned.dtype != torch.uint8 or pinned.numel() < n:
        raise ValueError(f"pinned buffer must be pinned uint8 of >= {n} bytes")
    host = pinned[:n]
    host.copy_(_pack(tensors), non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return AsyncFetch(tensors, host, event)


class GraphedCall:
    """`fn(*tensors)` -> a sequence of tensors, captured into one CUDA graph
    per set of input shapes and dtypes at its first call on the card, then
    replayed: the inputs are copied into the graph's own tensors, the graph
    runs on the current stream, and copies of its outputs come back. A
    function of thousands of small launches (an LM loop over small systems)
    costs one launch a call. `fn` must be pure in its tensor arguments and
    free of host syncs and host-to-device copies; other arguments are bound
    into it, so a graph is valid only for one binding. On CPU tensors `fn`
    runs as is. Other threads may use the card while a graph is captured
    (`capture_error_mode="thread_local"`)."""

    def __init__(self, fn):
        self.fn = fn
        self._graphs: dict = {}

    def __call__(self, *args):
        if not args[0].is_cuda:
            return tuple(self.fn(*args))
        key = tuple((a.shape, a.dtype, a.device) for a in args)
        entry = self._graphs.get(key)
        if entry is None:
            static_in = [a.clone() for a in args]
            side = torch.cuda.Stream(args[0].device)
            side.wait_stream(torch.cuda.current_stream(args[0].device))
            with torch.cuda.stream(side):  # warm-up: library handles and workspaces
                self.fn(*static_in)
            torch.cuda.current_stream(args[0].device).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                static_out = tuple(self.fn(*static_in))
            entry = self._graphs[key] = (graph, static_in, static_out)
        graph, static_in, static_out = entry
        for dst, src in zip(static_in, args):
            dst.copy_(src)
        graph.replay()
        return tuple(o.clone() for o in static_out)
