"""Background mapping and loop-closing stages (port of
runtime/mapping_worker.py): the pipeline analogs of the reference's
LocalMapping and LoopClosing threads.

One host thread consumes a bounded keyframe queue and runs the tracker's
mapping step (triangulate -> fuse -> cull -> window BA); tracking keeps the
critical path and reads a bounded-stale map under a shared RLock whose
critical sections are the short numpy gathers and write-backs. Device
programs are dispatched and fetched outside the lock.

Concurrency contract:
- only this worker mutates map structure past insertion (landmark creation,
  fusion, culling, BA write-backs);
- the track thread mutates only per-frame bindings and the visible/found
  counters, and inserts keyframe rows under the lock.

`LoopWorker` consumes every keyframe the mapping stage finishes and runs
the tracker's loop step (detection, validation, correction) on its own
thread; a correction reaches the track thread through `big_change_idx`.

Bookkeeping is by counters, each written by one thread only: `submit` counts
what the producer queued, `_run` what the consumer took and finished. `busy`
and `wait_idle` compare them, so neither can be fooled by an event that one
thread sets while the other clears it. The reference clears `frontier` on the
producer thread, where a step that is just reaching its own frontier can set
it again over a keyframe that is already queued; here `_run` clears it after
the dequeue. The reference's `LoopWorker` has the same race on its `idle`
event (`submit` clears it on the producer thread, `_run` sets it when its
queue looks empty); the port's counts instead.
"""

from __future__ import annotations

import logging
import queue
import threading
import time

log = logging.getLogger("orbslam3_torch.mapping")


class LoopWorker:
    """The place-recognition stage (LoopClosing::Run): consumes every
    keyframe the mapping stage finishes, one by one, and runs the tracker's
    loop step without blocking the mapping worker. A failure of the thread
    is re-raised at the next `flush`."""

    def __init__(self, tracker):
        self.tracker = tracker
        self.q: queue.Queue = queue.Queue()
        self.error: BaseException | None = None
        self.n_processed = 0  # keyframes whose loop step ran to its end
        self.busy_s = 0.0  # wall time spent inside loop steps
        self._n_submitted = 0  # producer side (the mapping thread)
        self._n_finished = 0  # consumer side: step over (or failed)
        self._thread = threading.Thread(target=self._run, name="loop_closing", daemon=True)
        self._thread.start()

    def submit(self, k: int, map_ref):
        self._n_submitted += 1
        self.q.put((k, map_ref))

    def busy(self) -> bool:
        return self._n_finished != self._n_submitted

    def flush(self):
        """Block until every queued keyframe is processed; re-raises a
        failure of the loop thread."""
        self.q.join()
        if self.error is not None:
            err, self.error = self.error, None
            raise err

    def stop(self):
        try:
            self.flush()
        finally:
            self.q.put(None)
            self._thread.join(timeout=30)

    def _run(self):
        while True:
            item = self.q.get()
            if item is None:
                self.q.task_done()
                return
            k, map_ref = item
            t0 = time.perf_counter()
            try:
                self.tracker._loop_step(k, map_ref)
                self.n_processed += 1
            except BaseException as e:  # noqa: BLE001 - surfaced at the next flush
                log.exception("loop step failed for KF %d", k)
                self.error = e
            finally:
                self.busy_s += time.perf_counter() - t0
                self._n_finished += 1
                self.q.task_done()


class MappingWorker:
    """Consumes keyframe slots; runs Tracker._mapping_step on each."""

    def __init__(self, tracker, max_queue: int = 3):
        self.tracker = tracker
        self.max_queue = max_queue
        self.q: queue.Queue = queue.Queue()
        # Set by `release_frontier` once the MAP FRONTIER of the step being
        # processed is fresh (triangulations + fusion + landmark culling
        # landed); the window-BA polish may still be in flight. wait_idle()
        # returns at this point: tracking wants the frontier (its matches
        # live there), while the BA pose polish can land concurrently a few
        # frames late without starving it.
        self.frontier = threading.Event()
        self.frontier.set()
        self.error: BaseException | None = None
        self.n_processed = 0  # keyframes whose step ran to its end
        # Bumped at each step's frontier point: the local-map snapshot
        # version key includes it so that tracking rebuilds its device
        # snapshot as soon as fresh frontier geometry exists.
        self.n_frontier = 0
        self.n_batches = 0  # catch-up batches (more than one keyframe drained)
        self.busy_s = 0.0  # wall time spent inside mapping steps
        self._n_submitted = 0  # producer side
        self._n_taken = 0  # consumer side: dequeued
        self._n_finished = 0  # consumer side: step over (or failed)
        self._thread = threading.Thread(target=self._run, name="mapping", daemon=True)
        self._thread.start()

    # -- producer side (track thread) ----------------------------------

    def accepting(self) -> bool:
        """Back-pressure policy: accept a new keyframe when idle or the
        queue is short."""
        return self.q.qsize() < self.max_queue

    def busy(self) -> bool:
        return self._n_finished != self._n_submitted

    def submit(self, k: int, payload: dict):
        self._n_submitted += 1
        self.q.put((k, payload))

    def flush(self):
        """Block until every queued keyframe is fully processed (used by
        trajectory export and shutdown); re-raises a failure of the mapping
        thread."""
        self.q.join()
        self._raise_pending()

    def _raise_pending(self):
        if self.error is not None:
            err, self.error = self.error, None
            raise err

    def wait_idle(self, timeout: float) -> bool:
        """Bounded-staleness wait: block up to `timeout` seconds for the
        in-flight mapping work's MAP FRONTIER to land (see `frontier`; full
        idle also qualifies), returning whether it did. Unlike flush() it
        never stalls unboundedly behind a long step, and unlike racing ahead
        it keeps the map frontier the tracker reads from at most one bounded
        step stale. Re-raises a failure of the mapping thread."""

        def ready() -> bool:
            n = self._n_submitted
            return self._n_taken == n and (self._n_finished == n or self.frontier.is_set())

        deadline = time.monotonic() + timeout
        while not ready():
            if time.monotonic() >= deadline:
                return False
            self.frontier.wait(min(0.002, max(deadline - time.monotonic(), 0)))
        self._raise_pending()
        return True

    def stop(self):
        try:
            self.flush()
        finally:
            self.q.put(None)
            self._thread.join(timeout=30)

    # -- consumer side --------------------------------------------------

    def release_frontier(self):
        """Called by the mapping step when its frontier has landed."""
        self.n_frontier += 1
        if self.q.empty():
            self.frontier.set()

    def _run(self):
        while True:
            item = self.q.get()
            if item is None:
                self.q.task_done()
                return
            # Drain everything already queued: the frontier of the map must
            # keep pace with the camera, so under backlog the newest
            # keyframe gets the full mapping step (whose triangulation pairs
            # cover the skipped keyframes' features through the covisibility
            # neighbourhood) and the older ones are registered only. This
            # bounds map latency to ~one mapping step regardless of queue
            # depth.
            items = [item]
            stop = False
            while True:
                try:
                    nxt = self.q.get_nowait()
                except queue.Empty:
                    break
                if nxt is None:
                    stop = True
                    break
                items.append(nxt)
            self.frontier.clear()
            self._n_taken += len(items)
            t0 = time.perf_counter()
            try:
                if len(items) == 1:
                    k, payload = items[0]
                    self.tracker._mapping_step(k, **payload)
                else:
                    self.n_batches += 1
                    self.tracker._mapping_step_batch([it[0] for it in items], **items[-1][1])
                self.n_processed += len(items)
            except BaseException as e:  # noqa: BLE001 - surfaced at the next flush / wait_idle
                log.exception("mapping step failed for KFs %s", [it[0] for it in items])
                self.error = e
            finally:
                self.busy_s += time.perf_counter() - t0
                self._n_finished += len(items)
                for _ in items:
                    self.q.task_done()
            if stop:
                self.q.task_done()
                return
