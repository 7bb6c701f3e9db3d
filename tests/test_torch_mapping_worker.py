"""The port's MappingWorker (runtime/mapping_worker.py) against the
reference's, both driving the same stub tracker: back-pressure, the
drain-and-batch of a backlog, the frontier release, the bounded wait, and a
failure of the mapping thread reaching the caller. The semantics are
discrete, so every comparison is exact. The one place where the two differ on
purpose is the frontier race of the reference (its producer clears the event
that its consumer sets): the last tests hold the port to the repaired
behaviour and show the reference's.
"""

import sys
import threading
import time

import pytest

from orbslam3_cpp_fork_tpu.runtime import mapping_worker as jmw
from orbslam3_cpp_fork_tpu_torch.runtime import mapping_worker as tmw

WAIT = 10.0  # seconds; every wait in this file is bounded


class StubTracker:
    """Records the worker's calls. A step blocks until `go` is set; with
    `frontier_first` it releases the map frontier before it blocks."""

    def __init__(self, port: bool):
        self.port = port
        self.worker = None
        self.calls = []  # ("step", k, payload) | ("batch", ks, payload)
        self.entered = threading.Semaphore(0)
        self.go = threading.Event()
        self.go.set()
        self.frontier_first = False
        self.fail_on = None
        self.late_set = False

    def release_frontier(self):
        w = self.worker
        if self.port:
            w.release_frontier()
        else:  # what the reference's Tracker._mapping_step does
            w.n_frontier += 1
            if w.q.empty():
                w.frontier.set()

    def _body(self, k):
        self.entered.release()
        if self.frontier_first:
            self.release_frontier()
        assert self.go.wait(WAIT)
        if self.late_set:
            self.late_set = False
            self.worker.frontier.set()
        if k == self.fail_on:
            raise ValueError(f"boom {k}")
        if not self.frontier_first:
            self.release_frontier()

    def _mapping_step(self, k, **payload):
        self.calls.append(("step", k, payload))
        self._body(k)

    def _mapping_step_batch(self, ks, **payload):
        self.calls.append(("batch", list(ks), payload))
        self._body(ks[-1])


@pytest.fixture(params=["ref", "port"])
def rig(request):
    port = request.param == "port"
    trk = StubTracker(port)
    w = (tmw if port else jmw).MappingWorker(trk)
    trk.worker = w
    yield trk, w
    trk.go.set()
    w.error = None
    w.stop()
    assert not w._thread.is_alive()


def test_back_pressure_at_three_and_drain_and_batch(rig):
    trk, w = rig
    assert w.accepting() and not w.busy() and w.max_queue == 3
    trk.go.clear()
    w.submit(0, {"map_ref": "m0"})
    assert trk.entered.acquire(timeout=WAIT)  # step 0 running, queue empty again
    accepted = []
    for k in (1, 2, 3):
        accepted.append(w.accepting())
        w.submit(k, {"map_ref": f"m{k}"})
    assert accepted == [True, True, True] and not w.accepting(), "the fourth queued keyframe is refused"
    assert w.busy()
    trk.go.set()
    w.flush()
    assert not w.busy() and w.accepting()
    # The backlog was drained into ONE batch that carries the newest payload.
    assert trk.calls == [("step", 0, {"map_ref": "m0"}), ("batch", [1, 2, 3], {"map_ref": "m3"})]
    assert w.n_processed == 4 and w.n_frontier == 2


def test_frontier_release_ends_the_bounded_wait(rig):
    trk, w = rig
    trk.frontier_first = True
    trk.go.clear()
    w.submit(5, {})
    assert trk.entered.acquire(timeout=WAIT)
    assert w.wait_idle(WAIT) is True, "the frontier landed although the step is still running"
    assert w.busy() and w.n_frontier == 1 and w.n_processed == 0
    trk.go.set()
    w.flush()
    assert not w.busy() and w.n_processed == 1
    assert w.wait_idle(0.0) is True, "idle qualifies"


def test_wait_idle_times_out_behind_a_long_step(rig):
    trk, w = rig
    trk.go.clear()
    w.submit(1, {})
    assert trk.entered.acquire(timeout=WAIT)
    t0 = time.monotonic()
    assert w.wait_idle(0.05) is False
    assert 0.04 <= time.monotonic() - t0 < 2.0
    trk.go.set()
    w.flush()


@pytest.mark.parametrize("how", ["flush", "wait_idle"])
def test_error_of_the_mapping_thread_reaches_the_caller(rig, how):
    trk, w = rig
    trk.fail_on = 7
    w.submit(7, {})
    with pytest.raises(ValueError, match="boom 7"):
        if how == "flush":
            w.flush()
        else:
            w.q.join()
            w.wait_idle(WAIT)
    w.flush()  # raised once, then cleared
    assert w.n_processed == 0
    trk.fail_on = None
    w.submit(8, {})
    w.flush()
    assert w.n_processed == 1, "the thread survives a failed step"


def test_frontier_is_cleared_by_the_consumer():
    """Step A reaches its frontier, finds the queue empty and is about to set
    the event when the producer submits B; A's late `set` lands after the
    submit. The bounded wait is then asked while B is inside its step and has
    not reached its frontier."""

    class Slow(StubTracker):
        def _body(self, k):
            if k == 1:
                self.entered.release()
                assert self.hold.wait(WAIT)
                self.release_frontier()
                return
            super()._body(k)

    results = {}
    for port in (False, True):
        trk = Slow(port)
        trk.hold = threading.Event()
        w = (tmw if port else jmw).MappingWorker(trk)
        trk.worker = w
        try:
            trk.go.clear()
            trk.late_set = True
            w.submit(0, {})
            assert trk.entered.acquire(timeout=WAIT)
            w.submit(1, {})
            trk.go.set()
            assert trk.entered.acquire(timeout=WAIT)  # B is inside its step, before its frontier
            results[port] = w.wait_idle(0.05)
        finally:
            trk.hold.set()
            trk.go.set()
            w.stop()
    assert results[True] is False, "port: B's frontier has not landed, the wait must time out"
    assert results[False] is True, "reference: the stale event ends the wait early (its known frontier race)"


def test_stress_counts_hold_under_contention():
    """Many submits against a fast consumer with a short switch interval:
    nothing is lost, every keyframe is processed once, and the worker is idle
    after the flush."""
    trk = StubTracker(True)
    w = tmw.MappingWorker(trk, max_queue=10**9)
    trk.worker = w
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        n = 2000
        t0 = time.monotonic()
        for k in range(n):
            w.submit(k, {})
            if k % 97 == 0:
                w.wait_idle(0.001)
        w.flush()
        assert time.monotonic() - t0 < 60
    finally:
        sys.setswitchinterval(old)
    seen = []
    for kind, ks, _ in trk.calls:
        seen.extend(ks if kind == "batch" else [ks])
    assert seen == list(range(n))
    assert w.n_processed == n and not w.busy() and w.wait_idle(0.0)
    assert w.n_batches == sum(kind == "batch" for kind, _, _ in trk.calls)
    w.stop()
    assert not w._thread.is_alive()
