#!/usr/bin/env python3
"""Where an HNSW search and an HNSW insert batch spend their time on one
CUDA card.

    python3 tools/hnsw_trials.py [N]

Builds ``chip_smoke.py``'s HNSW index (N embedding-like 768-wide fp32 Cosine
rows, seed 0, default N = 100,000; M = 16, efConstruction = 200) with
``bulk_build_device`` and, on its 1024 held-out queries (k = 10):

1. the poll trial: the graph loops read their "rows done" flags once every
   ``config.timeout_poll_iters`` iterations; the search runs at 8, 32 (the
   default) and 128, in turns, at ef = 10, 100 and 500, printing ms per
   batch, host reads and loop iterations launched per batch;
2. a ``torch.profiler`` window over one search batch at ef = 100 and over
   one insert batch of 1024 fresh rows (``add_vector_batch``): device busy
   ms (the sum of the CUDA-side events alone, kernels, copies and sets; the
   CPU-side op rows that launch them carry the same time and are left out),
   the device ops launched, the idle share against the same work's median
   wall time unprofiled (three searches, or the three insert batches before
   it), the wall time under the profiler, and the device events that take
   most time.

Every line ends with the card's name and power limit. The trials are
measurements: nothing in the package reads them.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
D, B, K, SEED = 768, 1024, 10, 0


def wall_ms(fn, reps=3):
    """Median wall ms of ``fn`` over ``reps`` runs, unprofiled."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile(fn, label, smi, wall, wall_of, top=8):
    """Run ``fn`` once under the profiler; print device busy ms and ops
    beside ``wall``, the same work's unprofiled wall ms (``wall_of`` says
    of which runs)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as prof

    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_prof = (time.perf_counter() - t0) * 1e3
    events = [e for e in p.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    ops = sum(e.count for e in events)
    print(f"# profile {label}: device busy {busy:.3f} ms, {ops} device ops, unprofiled wall "
          f"{wall:.2f} ms ({wall_of}), idle share {1 - busy / wall:.3f}; wall under the "
          f"profiler {wall_prof:.2f} ms; card {smi}", flush=True)
    ranked = sorted(events, key=lambda e: -e.self_device_time_total)[:top]
    for e in ranked:
        print(f"#   {e.key[:60]:60s} {e.self_device_time_total / 1e3:9.3f} ms  x{e.count}",
              flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("hnsw_trials: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from vectorsimilarity_tpu_torch import config, create_index
    from vectorsimilarity_tpu_torch import types as T
    from vectorsimilarity_tpu_torch.ops import graph_search as gs
    from vectorsimilarity_tpu_torch.utils.synthetic import embedding_like

    n = int(sys.argv[1]) if len(sys.argv) > 1 else 100_000
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = embedding_like(gen, n + 5 * B, D)
    data, queries, fresh = rows[:n], rows[n : n + B], rows[n + B :]
    idx = create_index(T.VecSimParams(algo=T.VecSimAlgo.HNSWLIB, hnswParams=T.HNSWParams(
        type=T.VecSimType.FLOAT32, dim=D, metric=T.VecSimMetric.Cosine, M=16,
        efConstruction=200)))
    t0 = time.perf_counter()
    idx.bulk_build_device(data)
    torch.cuda.synchronize()
    print(f"# build {n} x {D}: {time.perf_counter() - t0:.1f} s; card {smi}", flush=True)

    for ef in (10, 100, 500):
        idx.search_knn_device(queries, K, ef)
        res = {}
        for poll in (8, 32, 128, 128, 32, 8):
            config.timeout_poll_iters = poll
            r0, i0 = gs.host_reads, gs.iterations
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            idx.search_knn_device(queries, K, ef)
            torch.cuda.synchronize()
            res.setdefault(poll, []).append(((time.perf_counter() - t0) * 1e3,
                                             gs.host_reads - r0, gs.iterations - i0))
        config.timeout_poll_iters = 32
        for poll, runs in sorted(res.items()):
            ms = statistics.median(r[0] for r in runs)
            print(f"# poll trial ef={ef} poll={poll}: {ms:.2f} ms per batch of {B}, "
                  f"{runs[0][1]} host reads, {runs[0][2]} loop iterations launched; card {smi}",
                  flush=True)

    search = lambda: idx.search_knn_device(queries, K, 100)  # noqa: E731
    profile(search, f"search B={B} ef=100", smi, wall_ms(search), "median of 3")
    host = np.asarray(fresh.cpu())
    batches = iter(range(4))

    def insert():
        j = next(batches)
        idx.add_vector_batch(host[j * B : (j + 1) * B], range(n + j * B, n + (j + 1) * B))

    profile(insert, f"insert batch of {B}", smi, wall_ms(insert), "median of 3 batches")
    return 0


if __name__ == "__main__":
    sys.exit(main())
