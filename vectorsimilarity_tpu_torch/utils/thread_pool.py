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
``wait_for_quiescence``. The SVS thread-slot pool of that module is not
ported yet (ROADMAP.md queue 1, item 3).
"""

from __future__ import annotations

import queue
import threading


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
