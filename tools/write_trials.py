#!/usr/bin/env python3
"""Where the HNSW write path and the tiered index's reads spend their time
on one CUDA card.

    python3 tools/write_trials.py [N]

Builds ``chip_smoke.py``'s tiered index (its HNSW backend: N embedding-like
768-wide fp32 Cosine rows, seed 0, default N = 100,000; M = 16,
efConstruction = 200, by ``bulk_build_device``) and takes apart, as wall
ms with the card synchronised around each part:

1. eager ``delete_vector`` calls (median of 16): the referrer scans of the
   host link arrays (``_referrers``, twice a delete), the device re-prune
   (``_reprune_rows``), and the rest (link edits, the row move, the sync);
2. one ``delete_tombstoned_bulk`` of 1024 tombstones: the device re-prune,
   the compaction gathers (``_compact_stores``), the label rebuild
   (``rebuild_labels``), and the rest, which is the host repair sweep over
   the rows that point at a tombstone and the host mirrors' permutation;
3. the migration batch of the tiered index: ``add_vector_batch`` of 256
   fresh rows (``config.tiered_migrate_batch``), median of 3, the time a
   migration holds the backend's lock;
4. a tiered ``topk_query_batch`` (B = 1024, k = 10, ef = 200), median of 3,
   with the flat tier empty and with 256 rows in it (a stalled job queue):
   the flat tier's search (K1), the backend's, and the per-query merge.

Every line ends with the card's name and power limit. The trials are
measurements: nothing in the package reads them.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
D, B, K, SEED = 768, 1024, 10, 0


def wall_ms(fn, reps=3):
    """Median wall ms of ``fn`` over ``reps`` runs; the last result."""
    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


class Parts:
    """Wall ms spent in wrapped callables, by name."""

    def __init__(self):
        self.ms: dict[str, float] = {}

    def wrap(self, owner, name):
        fn = getattr(owner, name)

        def timed(*a, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                torch.cuda.synchronize()
                self.ms[name] = self.ms.get(name, 0.0) + (time.perf_counter() - t0) * 1e3

        setattr(owner, name, timed)

    def take(self):
        out, self.ms = self.ms, {}
        return out


def main() -> int:
    if not torch.cuda.is_available():
        print("write_trials: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from vectorsimilarity_tpu_torch import create_index
    from vectorsimilarity_tpu_torch import types as T
    from vectorsimilarity_tpu_torch.indexes import hnsw as hnsw_mod
    from vectorsimilarity_tpu_torch.utils.synthetic import embedding_like
    from vectorsimilarity_tpu_torch.utils.thread_pool import JobQueueThreadPool

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = embedding_like(gen, n + B, D)
    data, queries = rows[:n], rows[n:]
    lat = torch.Generator(device=dev).manual_seed(SEED + 7)
    new = embedding_like(torch.Generator(device=dev).manual_seed(SEED), 4 * 256 + 64, D,
                         latent_generator=lat).cpu().numpy()
    host_q = queries.cpu().numpy()
    pool = JobQueueThreadPool(1)
    gate = threading.Event()
    try:
        primary = T.VecSimParams(algo=T.VecSimAlgo.HNSWLIB, hnswParams=T.HNSWParams(
            type=T.VecSimType.FLOAT32, dim=D, metric=T.VecSimMetric.Cosine, M=16,
            efConstruction=200, efRuntime=200, initialCapacity=n))
        tparams = T.TieredIndexParams(primaryIndexParams=primary, jobQueue=pool,
                                      submitCb=pool.submit_cb)
        tiered = create_index(T.VecSimParams(algo=T.VecSimAlgo.TIERED, tieredParams=tparams))
        idx = tiered.backend
        t0 = time.perf_counter()
        idx.bulk_build_device(data, batch=1024, scan_batches=4)
        torch.cuda.synchronize()
        print(f"# build {n} x {D}: {time.perf_counter() - t0:.1f} s; card {smi}", flush=True)

        parts = Parts()
        parts.wrap(idx, "_referrers")
        parts.wrap(idx, "_reprune_rows")
        parts.wrap(hnsw_mod, "_compact_stores")
        parts.wrap(hnsw_mod, "rebuild_labels")
        order = np.random.default_rng(SEED + 1).permutation(n)

        # 1. eager deletes (the first pulls the device-built links once)
        idx.delete_vector(int(order[0]))
        parts.take()
        per = []
        for lab in order[1:17]:
            ms, _ = wall_ms(lambda lab=lab: idx.delete_vector(int(lab)), reps=1)
            p = parts.take()
            per.append((ms, p.get("_referrers", 0.0), p.get("_reprune_rows", 0.0)))
        tot, scan, prune = (statistics.median(x) for x in zip(*per))
        print(f"# eager delete_vector (median of 16): {tot:.2f} ms = referrer scans {scan:.2f} "
              f"+ re-prune {prune:.2f} + the rest; card {smi}", flush=True)

        # 2. one bulk removal of 1024 tombstones
        ids = []
        for lab in order[17:17 + 1024]:
            ids += idx.mark_delete(int(lab))
        ms, removed = wall_ms(lambda: idx.delete_tombstoned_bulk(ids), reps=1)
        idx.num_marked_deleted -= removed
        p = parts.take()
        rest = ms - sum(p.values())
        print(f"# delete_tombstoned_bulk of {removed} tombstones, {idx.last_bulk_repairs} rows "
              f"repaired: {ms:.1f} ms = re-prune {p.get('_reprune_rows', 0.0):.1f} + compaction "
              f"gathers {p.get('_compact_stores', 0.0):.1f} + label rebuild "
              f"{p.get('rebuild_labels', 0.0):.1f} + host sweep and mirrors {rest:.1f}; "
              f"card {smi}", flush=True)

        # 3. the migration batch: 256 fresh rows
        label = [n + 10]

        def migrate():
            j = label[0] - n - 10
            idx.add_vector_batch(new[j:j + 256], list(range(label[0], label[0] + 256)))
            label[0] += 256

        ms, _ = wall_ms(migrate)
        print(f"# add_vector_batch of 256 fresh rows (a migration batch, which holds the "
              f"backend's lock): {ms:.1f} ms (median of 3); card {smi}", flush=True)

        # 4. a tiered read, the flat tier empty, then holding 256 rows
        qp = T.VecSimQueryParams()
        qp.hnswRuntimeParams.efRuntime = 200
        tiered.topk_query_batch(host_q, K, qp)  # warm-up
        empty, _ = wall_ms(lambda: tiered.topk_query_batch(host_q, K, qp))
        pool.submit_cb(None, None, [None], [lambda _: gate.wait(300)])  # stall
        for j in range(256):
            tiered.add_vector(new[1024 + (j % 64)], label[0] + j)
        full, _ = wall_ms(lambda: tiered.topk_query_batch(host_q, K, qp))
        flat, _ = wall_ms(lambda: tiered.frontend.topk_query_batch(host_q, K, qp))
        back, _ = wall_ms(lambda: tiered.backend.topk_query_batch(host_q, K, qp))
        print(f"# tiered topk_query_batch B={B} k={K} ef=200 (medians of 3): flat tier empty "
              f"{empty:.1f} ms; holding 256 rows {full:.1f} ms = flat tier {flat:.1f} + backend "
              f"{back:.1f} + merge {full - flat - back:.1f}; card {smi}", flush=True)
    finally:
        gate.set()
        pool.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
