#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``vectorsimilarity_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits nonzero) on any failed
check:

1. Build the group-min kernel (``csrc/bf_topk_gm.cu``) from the sources in
   this checkout with nvcc, printing the build time and ptxas' register and
   spill report.
2. Generate the headline store on the card: 1M x 768 fp32 embedding-like
   unit vectors from a seeded ``torch.Generator``, capacity 2^20.
3. Hold the kernel against its plain PyTorch version on the card, at small
   odd shapes (count off the tile grid, B = 1, 7, 1024, every metric, a
   dim that is not a multiple of 4) and at the headline store with B = 1 and
   B = 1024: group minima within 1e-5 absolute, +inf at the same places.
   Times both.
4. The main path at full width: the store is adopted into the port's
   ``BruteForceIndex`` on the card, then ``topk_query_batch`` (host API)
   and ``search_knn_device`` (B = 1024, k = 10) run with the kernel's launch
   count and the fallback count set to 0 just before; 32 queries are held
   against a float64 exact ground truth. The kernel must have launched and
   the fallback must not have run. Then an all-ties store must trip the
   fallback and still return ids 0..k-1.
5. QPS of ``search_knn_device`` at the headline shape (median of 3 rounds
   over staged batches), beside the card's name and power limit.

It prints one JSON line of kernel results and, last, one JSON line
``{"ok": true, "device": {...}}``. Without a CUDA card, or without the
package beside it, it exits nonzero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

N, CAP, DIM, BATCH, K = 1_000_000, 1 << 20, 768, 1024, 10
SEED = 0
TOL = 1e-5  # fp32 vs fp32 in another summation order; see csrc/bf_topk_gm.cu

# (B, tiles, tile_n, group_n, dim, count, metric name) — small odd shapes.
SMALL_SHAPES = [
    (1, 3, 4096, 256, 768, 9000, "Cosine"),
    (7, 2, 4096, 256, 100, 5000, "L2"),
    (1024, 4, 4096, 256, 768, 12345, "IP"),
    (33, 4, 1024, 256, 768, 4000, "L2"),
    (130, 8, 64, 16, 64, 300, "Cosine"),
    (5, 2, 1024, 128, 37, 2000, "IP"),
]


def _unit_rows(gen, n, dim, device):
    x = torch.randn((n, dim), generator=gen, device=device)
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def time_ms(fn, reps):
    """Median device time of ``fn`` over ``reps`` runs, after one warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def gm_error(got, ref):
    """(max |got - ref|, max |got - ref| / max(1, |ref|)) over the finite
    entries; the +inf patterns must agree."""
    inf_got, inf_ref = torch.isinf(got), torch.isinf(ref)
    if not torch.equal(inf_got, inf_ref):
        raise AssertionError("kernel and plain version disagree on masked groups")
    diff = torch.where(inf_ref, 0.0, got - ref).abs()
    return float(diff.max()), float((diff / ref.abs().clamp(min=1.0)).max())


def phase_build():
    from vectorsimilarity_tpu_torch.ops.kernels import bf_topk as bfk

    t0 = time.perf_counter()
    kern = bfk.load_kernel()
    print(f"# build: {time.perf_counter() - t0:.1f} s (nvcc {kern.build_seconds:.1f} s) "
          f"-> {os.path.relpath(kern.path, REPO)}", flush=True)
    for line in kern.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"#   ptxas: {line.strip()}")


def check_kernel(dev, shapes, store=None):
    """Kernel vs plain version on each shape; returns (max abs error over
    all shapes, last shape's kernel ms, last shape's plain ms)."""
    from vectorsimilarity_tpu_torch.ops.kernels import bf_topk as bfk
    from vectorsimilarity_tpu_torch.types import VecSimMetric

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    worst, ms, plain_ms = 0.0, None, None
    for B, tiles, tile_n, group_n, dim, count, mname in shapes:
        metric = VecSimMetric[mname]
        data = store if store is not None else _unit_rows(gen, tiles * tile_n, dim, dev)
        q = _unit_rows(gen, B, dim, dev)
        sqn = torch.sum(data * data, dim=1) if metric == VecSimMetric.L2 else None
        kw = dict(metric=metric, tile_n=tile_n, group_n=group_n)
        got = bfk.group_min_scores(q, data, sqn, count, **kw)
        ref = bfk.group_min_scores_ref(q, data, sqn, count, **kw)
        torch.cuda.synchronize()
        err, rel = gm_error(got, ref)
        reps = 5 if B * data.shape[0] > 1 << 28 else 20
        ms = time_ms(lambda: bfk.group_min_scores(q, data, sqn, count, **kw), reps)
        plain_ms = time_ms(lambda: bfk.group_min_scores_ref(q, data, sqn, count, **kw), reps)
        print(f"# kernel vs plain B={B} N={data.shape[0]} D={dim} count={count} "
              f"tile_n={tile_n} G={group_n} {mname}: max abs err {err:.3e} (rel {rel:.3e}), "
              f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms", flush=True)
        if not err <= TOL:
            raise AssertionError(f"kernel disagrees with its plain version: {err:.3e}")
        worst = max(worst, err)
    return worst, ms, plain_ms


def exact_truth(queries, store, count, k):
    """float64 exact cosine distances and ids (lex order) of the k best."""
    q64 = queries.double()
    parts = []
    for lo in range(0, count, 1 << 17):
        hi = min(lo + (1 << 17), count)
        parts.append(1.0 - q64 @ store[lo:hi].double().T)
    s = torch.cat(parts, dim=1)
    order = torch.sort(s, dim=1, stable=True).indices[:, :k]
    return torch.gather(s, 1, order).cpu().numpy(), order.cpu().numpy(), s


def assert_knn(d, i, rd, ri, s64):
    """Port (d, i) [Q, k] against the float64 truth (rd, ri) [Q, k+1]: ids
    equal except at slots whose true distance lies within TOL of a
    neighbouring one, distances within TOL everywhere, and every returned
    id's exact distance equal to the returned distance within TOL."""
    k = d.shape[1]
    if not np.abs(d - rd[:, :k]).max() <= TOL:
        raise AssertionError(f"distances off by {np.abs(d - rd[:, :k]).max():.3e}")
    own = torch.gather(s64, 1, torch.as_tensor(i, device=s64.device)).cpu().numpy()
    if not np.abs(own - d).max() <= TOL:
        raise AssertionError("a returned id's exact distance differs from its reported one")
    gap = np.abs(np.diff(rd, axis=1)) <= TOL  # [Q, k]: slot s ~ slot s+1
    tied = np.zeros_like(d, dtype=bool)
    tied[:, 1:] |= gap[:, : k - 1]
    tied |= gap[:, :k]
    bad = (i != ri[:, :k]) & ~tied
    if bad.any():
        raise AssertionError(f"{int(bad.sum())} ids differ from the exact top-k")
    if not all(len(set(row)) == k for row in i.tolist()):
        raise AssertionError("duplicate ids in a reply")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from vectorsimilarity_tpu_torch.indexes.brute_force import BruteForceIndex
    from vectorsimilarity_tpu_torch.ops.kernels import bf_topk as bfk
    from vectorsimilarity_tpu_torch.types import BFParams, VecSimMetric, VecSimType
    from vectorsimilarity_tpu_torch.utils.synthetic import embedding_like

    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"# {torch.cuda.get_device_name(0)} ({smi}); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    # 1. Build.
    phase_build()

    # 2. The headline store, generated on the card.
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    store = torch.zeros((CAP, DIM), dtype=torch.float32, device=dev)
    embedding_like(gen, N, DIM, out=store)
    qgen = torch.Generator(device=dev).manual_seed(SEED + 100)
    staged = [embedding_like(gen, BATCH, DIM, latent_generator=qgen) for _ in range(4)]
    torch.cuda.synchronize()
    print(f"# store {N} x {DIM} fp32 cosine generated in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # 3. Kernel vs plain version: small odd shapes, then the headline.
    small_err, _, _ = check_kernel(dev, SMALL_SHAPES)
    err, ms, plain_ms = check_kernel(
        dev, [(B, CAP // 4096, 4096, 256, DIM, N, "Cosine") for B in (1, BATCH)], store=store)
    err = max(err, small_err)

    # 4. The main path at full width.
    idx = BruteForceIndex(BFParams(type=VecSimType.FLOAT32, dim=DIM,
                                   metric=VecSimMetric.Cosine), device=dev)
    idx.store.adopt_device({"data": store}, count=N)
    idx.labels.label_to_id = dict(zip(range(N), range(N)))
    idx.store.host["label"][:N] = np.arange(N, dtype=np.int64)
    host_queries = staged[0][:64].cpu().numpy()

    bfk.group_min_scores.launches = 0
    bfk.topk_gm_exact.fallbacks = 0
    replies = idx.topk_query_batch(host_queries, K)
    dists, ids = idx.search_knn_device(staged[0], K)
    torch.cuda.synchronize()
    launches, fallbacks = bfk.group_min_scores.launches, bfk.topk_gm_exact.fallbacks
    print(f"# main path: kernel launches {launches}, fallbacks {fallbacks}", flush=True)
    if launches < 2:
        raise AssertionError("the main path did not run the group-min kernel")
    if fallbacks:
        raise AssertionError("the exact fallback ran on random data")
    if tuple(dists.shape) != (BATCH, K) or not bool(torch.isfinite(dists).all()):
        raise AssertionError(f"bad result shape or values: {tuple(dists.shape)}")

    rd, ri, s64 = exact_truth(staged[0][:32], store, N, K + 1)
    assert_knn(dists[:32].cpu().numpy(), ids[:32].cpu().numpy(), rd, ri, s64)
    hd = np.stack([r.scores for r in replies[:32]])
    hi = np.stack([r.ids for r in replies[:32]])  # labels == row ids here
    assert_knn(hd, hi, rd, ri, s64)
    del s64
    print("# main path: 32 queries match the float64 exact top-k "
          f"(host API and device path), tolerance {TOL}", flush=True)

    # All-ties store: every group minimum ties, coverage cannot be shown,
    # the exact fallback must answer with ids 0..k-1.
    ties = BruteForceIndex(BFParams(type=VecSimType.FLOAT32, dim=DIM,
                                    metric=VecSimMetric.Cosine), device=dev)
    row = torch.full((1, DIM), DIM ** -0.5, device=dev)
    ties.store.adopt_device({"data": row.repeat(8192, 1)}, count=5000)
    before = bfk.topk_gm_exact.fallbacks
    td, ti = ties.search_knn_device(row.repeat(4, 1), K)
    if bfk.topk_gm_exact.fallbacks != before + 1:
        raise AssertionError("the all-ties case did not fall back")
    if not (ti.cpu() == torch.arange(K)).all() or float(td.abs().max()) > 1e-6:
        raise AssertionError(f"all-ties fallback returned {ti[0].tolist()}")
    print("# all-ties store: fallback ran and returned ids 0..k-1", flush=True)

    # 5. QPS at the headline shape.
    idx.search_knn_device(staged[1], K)
    torch.cuda.synchronize()
    rounds = []
    for _ in range(3):
        t0 = time.perf_counter()
        for qb in staged:
            out = idx.search_knn_device(qb, K)
        torch.cuda.synchronize()
        rounds.append(len(staged) * BATCH / (time.perf_counter() - t0))
    qps = statistics.median(rounds)
    print(f"# search_knn_device {N} x {DIM} fp32 cosine, B={BATCH}, k={K}: "
          f"{qps:.1f} QPS (median of {[round(r, 1) for r in rounds]}), "
          f"{1000 * BATCH / qps:.2f} ms per batch; card {smi}", flush=True)
    del out

    print(smi)
    print(json.dumps({"kernels": [{
        "name": "bf_topk_gm_f32",
        "route": "cuda",
        "source": "vectorsimilarity_tpu_torch/csrc/bf_topk_gm.cu",
        "replaces": "vectorsimilarity_tpu/ops/pallas/bf_topk.py:509",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms,
        "plain_ms": plain_ms,
        "fallbacks": fallbacks,
        "qps": qps,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
