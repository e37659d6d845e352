"""The closed loop: ``clients`` threads, each sending its next request only
after its last reply, every request one ``topk_query_batch`` of a pool batch.

Requests take the pool's batches in turn (request i asks batch i mod
pool_batches). A request is timed on the host's clock from its issue to its
last reply. The window closes ``seconds`` after it opens: no request is
issued after the close, and the requests in flight are waited for.

The replies of the requests that ``keep(i)`` names are kept for the
judgement after the window; the others are counted and dropped, as a
deployment drops them. Kept replies cost the program: at k = 500, 4 KB
arrays kept alive by the thousand cut the rate of 4 clients from 19,865
to 14,568 queries/s on the card (so those cells judge a seeded sample),
and each full collection of the cyclic garbage collector walks every
reply kept so far. So after each request what is alive moves into the
collector's permanent generation (``gc.freeze``), and back once the loop
has ended.
"""

from __future__ import annotations

import gc
import itertools
import threading
import time
import traceback


class ClosedLoop:
    """Drives ``request(pool_index) -> replies`` from ``clients`` threads."""

    def __init__(self, request, clients: int, pool_batches: int):
        self.request = request
        self.clients = int(clients)
        self.pool_batches = int(pool_batches)

    def _client(self, counter, records: list, stop, keep, lock) -> None:
        while True:
            i = next(counter)
            if stop(i):
                return
            pool = i % self.pool_batches
            t0 = time.perf_counter()
            rec = {"pool": pool, "issued": t0}
            try:
                replies = self.request(pool)
                rec["answered"] = len(replies)
                if keep(i):
                    rec["replies"] = replies
                del replies
            except Exception:  # a failed request is counted and reported, and the run goes on
                rec["error"] = traceback.format_exc()
            rec["done"] = time.perf_counter()
            with lock:
                records.append(rec)
            gc.freeze()

    def _drive(self, stop, keep) -> list:
        records: list = []
        counter, lock = itertools.count(), threading.Lock()
        threads = [threading.Thread(target=self._client,
                                    args=(counter, records, stop, keep, lock),
                                    name=f"portbench-client-{c}", daemon=True)
                   for c in range(self.clients)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        gc.unfreeze()
        return records

    def run_count(self, n: int, keep=lambda i: True) -> list:
        """Exactly ``n`` requests (warm-up, calibration)."""
        return self._drive(lambda i: i >= n, keep)

    def run_window(self, seconds: float, keep=lambda i: True):
        """Requests until ``seconds`` after the window opens. Returns
        (records, t_open, t_close, t_end): t_end is when the last request in
        flight at the close returned."""
        t_open = time.perf_counter()
        t_close = t_open + float(seconds)
        records = self._drive(lambda i: time.perf_counter() >= t_close, keep)
        return records, t_open, t_close, time.perf_counter()
