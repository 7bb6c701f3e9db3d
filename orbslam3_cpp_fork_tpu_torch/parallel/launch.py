"""Run one function in a group of spawned ranks.

`run_ranks(target, n, *args)` starts n processes with the `spawn` method,
joins them in one `torch.distributed` process group at
tcp://127.0.0.1:<a free port>, calls `target(rank, device, *args)` in each
and returns the ranks' results in rank order. A child imports torch and this
package only; it runs one intra-op thread. The layout of the ranks
(`rank_layout`): with a card per rank, NCCL with rank r on cuda:r; with
fewer cards than ranks, gloo with every rank on cuda:0 (NCCL refuses two
ranks on one card; gloo reduces CUDA tensors itself, staging them through
host memory); on the CPU, gloo.

`solve_sharded` is a target that solves whole-map BA problems sharded over
the group, the same problems on every rank, and reports each run's host
time and all-reduce count.
"""

from __future__ import annotations

import dataclasses
import pickle
import queue
import socket
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist


def rank_layout(n: int, device: str = "cuda", backend: str | None = None) -> tuple[str, list[torch.device]]:
    """(backend, device of each rank) for n ranks on `device`'s kind; on the
    card the backend follows the card count unless `backend` names one."""
    if torch.device(device).type == "cpu":
        return "gloo", [torch.device("cpu")] * n
    if not torch.cuda.is_available():
        raise RuntimeError("device cuda requested but CUDA is not available")
    if backend is None:
        backend = "nccl" if torch.cuda.device_count() >= n else "gloo"
    if backend == "nccl":
        if torch.cuda.device_count() < n:
            raise ValueError(f"NCCL needs a card per rank: {n} ranks, {torch.cuda.device_count()} cards")
        return "nccl", [torch.device("cuda", r) for r in range(n)]
    return backend, [torch.device("cuda", 0)] * n


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, n, backend, port, device, target, args, results):
    torch.set_num_threads(1)
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=n,
                                timeout=timedelta(seconds=300))
        try:
            out = target(rank, dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException as e:  # noqa: BLE001 - handed to the parent, which raises it
        tb = traceback.format_exc()
        try:
            pickle.dumps(e)
        except Exception:  # noqa: BLE001 - an exception that does not pickle travels as text
            e = RuntimeError(str(e))
        results.put((rank, False, (e, tb)))


def run_ranks(target, n: int, *args, device: str = "cuda", backend: str | None = None,
              timeout: float = 900.0) -> list:
    """target(rank, device, *args) in n spawned ranks of one process group
    (`rank_layout`); the results in rank order. A rank's exception is raised
    here, with the rank's traceback attached as a note; every child is
    stopped before this returns or raises."""
    import multiprocessing as mp

    backend, devices = rank_layout(n, device, backend)
    port = _free_port()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [
        ctx.Process(target=_rank_main, args=(r, n, backend, port, str(devices[r]), target, args, results),
                    name=f"rank{r}", daemon=True)
        for r in range(n)
    ]
    for p in procs:
        p.start()
    out = {}
    deadline = time.monotonic() + timeout
    try:
        while len(out) < n:
            try:
                r, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n} ranks did not finish within {timeout:.0f} s") from None
                dead = [p.name for r, p in enumerate(procs) if r not in out and p.exitcode is not None]
                if dead:
                    try:  # a result may still be in the pipe
                        r, ok, value = results.get(timeout=5.0)
                    except queue.Empty:
                        raise RuntimeError(f"{', '.join(dead)} exited without a result") from None
                else:
                    continue
            if not ok:
                exc, tb = value
                exc.add_note(f"in rank {r} of {n} ({backend}):\n{tb}")
                raise exc
            out[r] = value
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
        results.close()
    return [out[r] for r in range(n)]


def to_host(x):
    """A problem (a dataclass of tensors, nested) with its tensors as numpy
    arrays, to be sent to the ranks."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: to_host(getattr(x, f.name)) for f in dataclasses.fields(x)})
    return x


def to_device(x, device):
    """The inverse of `to_host`, onto `device`."""
    if isinstance(x, np.ndarray):
        return torch.from_numpy(x).to(device)
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return dataclasses.replace(x, **{f.name: to_device(getattr(x, f.name), device) for f in dataclasses.fields(x)})
    return x


def solve_sharded(rank, device, jobs) -> list[dict | None]:
    """Target of `run_ranks`: each job (a host problem, the solver's keyword
    arguments[, a rank count]) on this rank's device, solved in order by
    `sparse_ba_sharded` (a BAProblem) or `sparse_vi_ba_sharded` (a
    VIBAProblem) over the default group, or over its first ranks when the
    job names fewer (the other ranks skip it: None). Per job: the result as
    numpy arrays, the host ms of the solve with its fetch, and its
    all-reduces."""
    from ..optim import sparse_ba
    from ..optim.inertial import VIBAProblem
    from . import dist_ba

    world = dist.get_world_size()
    sizes = sorted({job[2] for job in jobs if len(job) > 2 and job[2] != world})
    groups = {n: dist.new_group(list(range(n))) for n in sizes}  # every rank creates every group
    out = []
    for problem, kw, *size in jobs:
        n = size[0] if size else world
        if rank >= n:
            out.append(None)
            continue
        p = to_device(problem, device)
        solve = dist_ba.sparse_vi_ba_sharded if isinstance(p, VIBAProblem) else dist_ba.sparse_ba_sharded
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        n0, t0 = sparse_ba.n_all_reduces, time.perf_counter()
        host = to_host(solve(groups.get(n), p, **kw))
        out.append(dict(result=host, ms=(time.perf_counter() - t0) * 1e3, all_reduces=sparse_ba.n_all_reduces - n0))
    return out
