"""Host worker pool implementing the reference's job-queue contract.

Counterpart of ``vectorsimilarity_tpu/utils/thread_pool.py``
(``JobQueueThreadPool``), restated (that package imports jax). The
reference ships this as test infrastructure only
(``tests/utils/mock_thread_pool.h:26-131``) because Redis owns the real
threads; here the pool is part of the library: a job queue, N worker
threads and a quiescence barrier (``thread_pool_wait``). Pass
``pool.submit_cb`` (and ``pool`` as the job queue) in ``TieredIndexParams``
to run background ingestion.

As in the JAX package, a job that raises ends its worker thread, and the
exception reaches ``threading.excepthook``; the job still counts as done for
``wait_for_quiescence``.

``SharedSVSThreadPool`` is the process-wide pool of rentable worker slots
that every SVS index shares (the reference's ``VecSimSVSThreadPoolImpl``,
``svs_utils.h:340-620``), with its rental protocol, deferred sizing and
scheduled-job quiescence. A slot that runs torch work on the card enters the
renter's device (``parallel_for(..., device=)``): a new thread starts on
CUDA device 0.
"""

from __future__ import annotations

import contextlib
import queue
import threading
from typing import Optional


class JobQueueThreadPool:
    """N worker threads draining a FIFO of (job, callback) pairs."""

    def __init__(self, num_threads: int = 4):
        self.num_threads = num_threads
        self._q: queue.Queue = queue.Queue()
        self._in_flight = 0
        self._cv = threading.Condition()
        self._threads = [
            threading.Thread(target=self._worker, daemon=True) for _ in range(num_threads)
        ]
        for t in self._threads:
            t.start()

    # The SubmitCB contract (vec_sim_common.h:135-137).
    def submit_cb(self, job_queue, job_queue_ctx, jobs, callbacks) -> int:
        with self._cv:
            self._in_flight += len(jobs)
        for job, cb in zip(jobs, callbacks):
            self._q.put((job, cb))
        return 0

    def _worker(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            job, cb = item
            try:
                cb(job)
            finally:
                with self._cv:
                    self._in_flight -= 1
                    if self._in_flight == 0:
                        self._cv.notify_all()

    def wait_for_quiescence(self, timeout: float | None = None) -> bool:
        """Block until every submitted job has finished (thread_pool_wait,
        mock_thread_pool.h:35-45); False if ``timeout`` seconds pass first."""
        with self._cv:
            return self._cv.wait_for(lambda: self._in_flight == 0, timeout)

    def resize(self, new_size: int) -> None:
        """Grow or shrink the worker count (``VecSim_UpdateThreadPoolSize``,
        vec_sim.cpp:38-48; a shrink lets workers finish their current job,
        then exit)."""
        new_size = max(new_size, 1)
        delta = new_size - len(self._threads)
        if delta > 0:
            for _ in range(delta):
                t = threading.Thread(target=self._worker, daemon=True)
                self._threads.append(t)
                t.start()
        elif delta < 0:
            for _ in range(-delta):
                self._q.put(None)  # one poison pill per worker to stop
            self._threads = self._threads[:new_size]
        self.num_threads = new_size

    def shutdown(self) -> None:
        """Stop every worker after the jobs queued before this call."""
        for _ in self._threads:
            self._q.put(None)
        for t in self._threads:
            t.join(timeout=5)


# Charged per rentable slot by shared_allocation_size(): the slot object, its
# handoff queue, event, and the interpreter's thread bookkeeping.
_SLOT_BOOKKEEPING_BYTES = 1024


class _ThreadSlot:
    """One rentable worker (svs_utils.h ``ThreadSlot``): a dedicated thread
    waiting on a per-slot handoff, and an occupancy flag claimed under the
    pool mutex so concurrent renters take disjoint slots."""

    def __init__(self) -> None:
        self.occupied = False  # guarded by the pool mutex
        self._work: queue.Queue = queue.Queue(maxsize=1)
        self.error: Optional[BaseException] = None
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def assign(self, fn, part: int) -> None:
        self.error = None
        self._done.clear()
        self._work.put((fn, part))

    def join_work(self) -> None:
        self._done.wait()

    def _run(self) -> None:
        while True:
            item = self._work.get()
            if item is None:
                return
            fn, part = item
            try:
                fn(part)
            except BaseException as e:  # collected by the renter
                self.error = e
            finally:
                self._done.set()

    def stop(self) -> None:
        self._work.put(None)

    def join(self, timeout: Optional[float] = None) -> None:
        self._thread.join(timeout)


def _on_device(device):
    """A context that makes ``device`` current where it is a CUDA device."""
    if device is None:
        return contextlib.nullcontext()
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return contextlib.nullcontext()
    return torch.cuda.device(device)


class SharedSVSThreadPool:
    """Process-wide worker pool with the reference's rental protocol
    (``svs_utils.h:340-620`` ``VecSimSVSThreadPoolImpl``):

    - one instance shared by every SVS index; the calling thread always
      takes part, so ``size() == len(slots) + 1``;
    - ``parallel_for(f, n)`` rents up to ``n - 1`` free slots, runs
      partition 0 on the caller, and releases the slots on return (the
      ``RentedThreads`` guard); partitions no free slot takes run on the
      caller;
    - a resize before any index attaches is recorded and applied at the
      first ``on_index_attached`` (no thread starts in a process that never
      makes an SVS index); a shrink while scheduled jobs are in flight is
      applied when the last one ends;
    - ``begin_scheduled_job`` / ``end_scheduled_job`` bracket one logical
      multi-thread job (the tiered ``SVSMultiThreadJob`` rendezvous,
      svs_tiered.h:35-215).
    """

    _instance: Optional["SharedSVSThreadPool"] = None
    _instance_lock = threading.Lock()

    def __init__(self) -> None:
        self._mutex = threading.Lock()
        self._slots: list[_ThreadSlot] = []
        self._deferred_size: Optional[int] = None
        self._has_attached_index = False
        self._pending_jobs = 0

    @classmethod
    def instance(cls) -> "SharedSVSThreadPool":
        with cls._instance_lock:
            if cls._instance is None:
                cls._instance = cls()
            return cls._instance

    @classmethod
    def is_initialized(cls) -> bool:
        return cls._instance is not None

    # -- sizing ------------------------------------------------------------

    def size(self) -> int:
        with self._mutex:
            return len(self._slots) + 1

    def resize(self, new_size: int) -> None:
        """Set the pool's parallelism (clamped to 1): at once once an index
        has attached, else at the first attach."""
        new_size = max(int(new_size), 1)
        with self._mutex:
            if self._has_attached_index:
                self._resize_locked(new_size)
            else:
                self._deferred_size = new_size

    def _resize_locked(self, new_size: int) -> None:
        if self._pending_jobs > 0 and new_size - 1 < len(self._slots):
            self._deferred_size = new_size  # shrink deferred to quiescence
            return
        want = new_size - 1
        while len(self._slots) < want:
            self._slots.append(_ThreadSlot())
        while len(self._slots) > want:
            slot = self._slots.pop()
            if slot.occupied:  # held by a renter: applied at the next job's end
                self._slots.insert(0, slot)
                self._deferred_size = new_size
                return
            slot.stop()

    def on_index_attached(self) -> None:
        """The first SVS index applies an earlier ``resize``
        (svs_utils.h:510-518 ``onIndexAttached``)."""
        with self._mutex:
            if self._has_attached_index:
                return
            self._has_attached_index = True
            if self._deferred_size is not None:
                self._resize_locked(self._deferred_size)
                self._deferred_size = None

    def shared_allocation_size(self) -> int:
        """Bytes of the pool's slot bookkeeping (svs_utils.h
        ``getSharedAllocationSize``; thread stacks are not charged); 0 until
        an index attaches."""
        with self._mutex:
            if not self._has_attached_index:
                return 0
            return len(self._slots) * _SLOT_BOOKKEEPING_BYTES

    # -- scheduled-job protocol ------------------------------------------------

    def begin_scheduled_job(self) -> int:
        """Open one scheduled job; returns the parallelism it may use."""
        with self._mutex:
            self._pending_jobs += 1
            return len(self._slots) + 1

    def end_scheduled_job(self) -> None:
        with self._mutex:
            if self._pending_jobs <= 0:
                raise RuntimeError("end_scheduled_job without begin_scheduled_job")
            self._pending_jobs -= 1
            if self._pending_jobs == 0 and self._deferred_size is not None:
                self._resize_locked(self._deferred_size)
                self._deferred_size = None

    # -- rental ----------------------------------------------------------------

    def _rent(self, count: int) -> list[_ThreadSlot]:
        rented: list[_ThreadSlot] = []
        with self._mutex:
            for slot in self._slots:
                if len(rented) >= count:
                    break
                if not slot.occupied:
                    slot.occupied = True
                    rented.append(slot)
        return rented

    def _release(self, rented: list[_ThreadSlot]) -> None:
        with self._mutex:
            for slot in rented:
                slot.occupied = False

    def parallel_for(self, fn, n: int, *, device=None) -> None:
        """Run ``fn(0)`` .. ``fn(n - 1)``: partition 0 on the calling thread,
        the others on rented slots (svs_utils.h:556-593), and whatever no
        free slot takes on the caller too (the reference raises there; a
        Python host has no reserved-job guarantee). Slots run inside
        ``device`` where it is a CUDA device. The first error raised by any
        partition is raised here after every partition ended."""
        if n <= 0:
            return
        if n == 1:
            fn(0)
            return

        def on_slot(part: int) -> None:
            with _on_device(device):
                fn(part)

        rented = self._rent(n - 1)
        try:
            for i, slot in enumerate(rented):
                slot.assign(on_slot, i + 1)
            errors: list[BaseException] = []
            for i in [0, *range(len(rented) + 1, n)]:
                try:
                    fn(i)
                except BaseException as e:
                    errors.append(e)
            for slot in rented:
                slot.join_work()
                if slot.error is not None:
                    errors.append(slot.error)
            if errors:
                raise errors[0]
        finally:
            self._release(rented)

    def reset_for_test(self) -> None:
        """Stop and join every slot and forget the sizing (svs_utils.h
        ``resetForTest``), so no thread outlives a test module."""
        with self._mutex:
            if self._pending_jobs:
                raise RuntimeError("reset with scheduled jobs in flight")
            slots, self._slots = self._slots, []
            self._deferred_size = None
            self._has_attached_index = False
        for slot in slots:
            slot.stop()
        for slot in slots:
            slot.join(timeout=5)
