#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``vectorsimilarity_tpu_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises (and the script exits nonzero) on any failed
check:

1. Build every kernel source under ``vectorsimilarity_tpu_torch/csrc/`` from
   this checkout with nvcc (one process per source, started together),
   printing the build time and ptxas' registers and spills per kernel.
2. Generate the headline store on the card: 1M x 768 fp32 embedding-like
   unit vectors from a seeded ``torch.Generator``, capacity 2^20.
3. Hold the group-min kernels' fp32 lane against the plain PyTorch version
   on the card at small odd shapes (count off the tile grid, B = 1, 7, 1024,
   every metric, a dim that is not a multiple of 4): group minima within 1e-5
   absolute, +inf at the same places. K1 has two kernels, the tensor-core
   one (`bf_topk_gm_tc.cu`) for the shapes `config.gm_tc_ok` admits and the
   CUDA-core one (`bf_topk_gm.cu`) for the rest; each shape asserts which
   launch counter moved.
4. Hold every kernel (both K1s, both fused top-k K3s, both per-tile top-c
   K4s) in every lane (fp32, bf16, fp16, int8, uint8) against its plain
   version at small odd shapes: B = 1, 7, 130, count off the grid, k > count,
   dims that are not multiples of 4 or 16 (D = 37 and 40 go to the CUDA-core
   K1, K3 and K4 in int8), all three metrics; the tensor-core K3 also at m =
   1, 40, 100, 128 with and without a lower bound, the tensor-core K4 at
   tile_n = 128, 512, 4096, c = 1, 32, 128, count = 0 and counts that leave
   whole tiles empty. Float lanes within 1e-5 with ids equal except at
   near-ties (judged on the plain version's next pair); integer lanes equal
   (Cosine, which rounds one fp32 divide, within 1e-6). K1, K3 and K4 each
   have a tensor-core kernel (for the rows `config.gm_tc_ok` admits; K4 also
   needs tiles of a multiple of 128 rows) and a CUDA-core one; every call
   asserts which launch counter moved. At the headline store with B = 1
   (fp32, Cosine), the tensor-core K1, the tensor-core K3 (k = 100) and the
   CUDA-core K3 (at ``CC_DIM``) are held against their plain versions and
   timed beside them.
5. The main path at full width, once per store type. The fp32 store is
   adopted into the port's ``BruteForceIndex`` (built with no ``device``, so
   on the card); then a float16, a bfloat16, an int8 and a uint8 store of the
   same rows follow, each made from the fp32 rows and freed after its turn.
   With every launch and fallback count set to 0 just before,
   ``topk_query_batch`` (host API) and ``search_knn_device`` (B = 1024) run
   at k = 10 (group-min), k = 100 (fused) and k = 500 (top-c); each engine's
   tensor-core kernel must have launched (K1, K3, K4; the CUDA-core ones
   never) and no fallback may have run; 32 queries per k are
   held against an exact float64 ground truth. Then each kernel is held
   against its plain version at the full-width shape and both are timed,
   beside the bare product at the same shape (``product_ms``:
   ``torch.matmul`` with TF32 off, or ``torch._int_mm``; none for uint8).
   The CUDA-core K1, K3 and K4 are timed at the same size with rows cut to
   a width the tensor-core gate refuses (``CC_DIM``), the shapes they serve.
   The tensor-core K3 is also timed at IP, for the cost of its Cosine
   epilogue, and the tensor-core K4 against its own kernel writing one list
   per range instead of one per tile (K3's configuration at m = c), for the
   cost of the per-tile list resets. The QPS of ``search_knn_device`` is
   taken per k.
6. An all-ties store must trip the group-min fallback, and a store with all
   near rows in one tile must trip the top-c truncation fallback; both must
   still answer exactly.
7. HNSW at the reference's configuration (M = 16, efConstruction = 200):
   ``create_index`` with no ``device`` (so on the card), then
   ``bulk_build_device`` of 100,000 x 768 embedding-like fp32 Cosine rows;
   ``search_knn_device`` of 1024 held-out rows at ef = 10, 100, 200, 500
   (k = 10), each held against the port's exact flat index on the same rows
   (kernel K1) for recall@10, which must reach 0.90 at ef = 200; the host
   API (``topk_query_batch``, and 32 queries through
   ``api.VecSimIndex_TopKQuery``, which must equal the batch's rows). HNSW
   runs no kernel of ``csrc/``: it has no Pallas kernel to port. Prints
   build seconds and vectors per second, ms, QPS, recall and host reads per
   ef, and the peak device memory.
8. The write path on phase 7's index before it is freed: 64 eager
   ``delete_vector`` calls, one ``add_vector_batch`` overwriting 1024 live
   labels (the bulk branch), ``mark_delete`` of 1024 more and one
   ``delete_tombstoned_bulk``, then ``topk_query_batch`` (B = 1024, k = 10,
   ef = 200): recall@10 by label against the exact flat index over the
   live rows at least 0.90, no deleted label in a reply, each overwritten
   label first for its new vector within 1e-4. Prints ms per delete, the
   seconds of the overwrite and of the bulk pass, and the rows repaired.
9. The tiered HNSW index: ``create_index(VecSimAlgo.TIERED)`` (768-d fp32
   Cosine, M = 16, efC = 200, swapJobThreshold 1024, a
   ``JobQueueThreadPool(2)``), its backend prebuilt by ``bulk_build_device``
   on 100,000 rows; a writer thread ingests 8192 new vectors by
   ``add_vector`` while the main thread loops ``topk_query_batch`` until the
   queue has migrated them all (K1 must answer the flat tier in that
   window); ``wait_for_quiescence(300)``; 1024 deletes, the last of which
   reaches the threshold and runs the GC. recall@10 at least 0.90 after the
   ingest and after the GC, no deleted label in a reply, and no thread may
   raise (``threading.excepthook`` records every exception). Prints vectors
   per second and QPS over the same window, the migration batches, the GC
   seconds and the peak device memory.
10. SVS-Vamana at the reference's defaults (``benchmarks/svs_build_bench.py``):
   ``create_index`` with no ``device``, 100,000 x 768 embedding-like fp32
   Cosine rows (a cut of the bench's 1M for time), graph_max_degree 32,
   construction_window_size 200, ``quantBits`` Q4x8 (a 4-bit primary and an
   8-bit residual re-rank), built by ``bulk_build_device`` from rows on the
   card. Per search window 10, 50, 100, 200: ``search_knn`` (B = 1024, k =
   10) and ``topk_query_batch`` with its re-rank, timed, and recall@10 by
   label against the exact flat index (K1), which must reach 0.85 at 200;
   every re-ranked distance of 16 replies equals ``get_distance_from``
   within 1e-3. Then 64 eager ``delete_vector`` calls (ms each), recall
   after them and no deleted label answering. Last, each other mode (NONE,
   Scalar, Q4, Q8, Q4x4, Q4x8_LeanVec, Q8x8_LeanVec) at 10,000 x 768: one
   build and one search at window 100, recall@10 at least 0.75 for Q4 and
   0.85 for the others (the JAX package's floors, tests/test_svs_quant.py).
11. The tiered SVS index: ``create_index(VecSimAlgo.TIERED)`` over phase
   10's configuration, trainingTriggerThreshold 10,240 and
   updateTriggerThreshold 1,024 (the reference's defaults), a
   ``JobQueueThreadPool(2)``; a writer thread adds 20,480 fresh rows while
   the main thread runs query batches (B = 1024, k = 10, window 200) until
   the queue is idle; K1 must answer the flat tier in that window. Then
   1,024 deletes and the GC. recall@10 at least 0.85 after the ingest and
   after the GC, no deleted label answering, no thread raising. Prints
   vectors/s and QPS over the window, the migrations, K1's launches, the GC
   seconds and the peak device memory.
12. Persistence on the card (``phase_persist``) and 13. the
   host-orchestrated builds (``phase_host_builds``).
14. Sharding over the one-card mesh ``[cuda:0] * 4`` (``phase_sharded``):
   the sharded flat scan of the headline store in fp32 and int8, whose
   K1, K3 and K4 must each launch once a shard (4 a batch) and whose
   answers must equal the unsharded index's, also after 1,024 adds and
   deletes across the shards; one sq8 scan against the plain one;
   query-sharded HNSW at B = 1025; ``ShardedHNSW`` and ``ShardedVamana``
   over 100,000 rows with recall floors 0.90 and 0.85, deletes and a save
   and load. The kernel rows gain ``sharded_launches_per_batch``.

Every timing line ends with the card's name and power limit. The script
prints one JSON line of kernel results (one entry per kernel and lane) and,
last, one JSON line ``{"ok": true, "device": {...}}``. Without a CUDA card,
or without the package beside it, it exits nonzero and prints no result.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))

N, CAP, DIM, BATCH = 1_000_000, 1 << 20, 768, 1024
KS = (10, 100, 500)  # one k per engine band: group-min, fused, top-c
TILE_N, GROUP_N, LOCAL_C = 4096, 256, 32  # the port's config defaults
SEED = 0
TOL = 1e-5  # fp32 vs fp32 in another summation order; see csrc/bf_topk_gm.cu
INT_COS_TOL = 1e-6  # one fp32 divide rounded on each side

LANES = ("f32", "f16", "bf16", "s8", "u8")
DTYPES = {"f32": torch.float32, "f16": torch.float16, "bf16": torch.bfloat16,
          "s8": torch.int8, "u8": torch.uint8}
VTYPES = {"f32": "FLOAT32", "f16": "FLOAT16", "bf16": "BFLOAT16", "s8": "INT8", "u8": "UINT8"}
# Published dense tensor-core peaks of one H100 SXM (operations per second)
# and its memory rate (bytes per second). fp32 scoring on a matrix unit is
# three low-precision passes; the least time is the TPU reference's own
# scheme, bf16_3x, 3 x 2BND operations at the bf16 peak. The tensor-core K1
# runs 3xTF32 (at half that rate); its figure is printed on a line beside.
PEAK_OPS = {"f32": 989e12, "f16": 989e12, "bf16": 989e12, "s8": 1979e12, "u8": 1979e12}
PASSES = {"f32": 3, "f16": 1, "bf16": 1, "s8": 1, "u8": 1}
TF32_PEAK = 495e12
PEAK_BYTES = 3.35e12
# Row width at which the CUDA-core K1, K3 and K4 are timed at full width: the widest
# below the headline's 768 that the tensor-core gate refuses (a row not a
# multiple of 16 bytes), and for int8 one torch._int_mm takes (a multiple of 8).
CC_DIM = {"f32": 767, "f16": 767, "bf16": 767, "s8": 760, "u8": 760}
KERNELS = {  # kernel -> (C entry point, source, TPU kernel it replaces)
    "gm_tc": ("bf_topk_gm_tc", "vectorsimilarity_tpu_torch/csrc/bf_topk_gm_tc.cu",
              "vectorsimilarity_tpu/ops/pallas/bf_topk.py:509"),
    "gm": ("bf_topk_gm", "vectorsimilarity_tpu_torch/csrc/bf_topk_gm.cu",
           "vectorsimilarity_tpu/ops/pallas/bf_topk.py:509"),
    "fused_tc": ("bf_topk_fused_tc", "vectorsimilarity_tpu_torch/csrc/bf_topk_fused_tc.cu",
                 "vectorsimilarity_tpu/ops/pallas/bf_topk.py:196"),
    "fused": ("bf_topk_fused", "vectorsimilarity_tpu_torch/csrc/bf_topk_fused.cu",
              "vectorsimilarity_tpu/ops/pallas/bf_topk.py:196"),
    "topc_tc": ("bf_topk_topc_tc", "vectorsimilarity_tpu_torch/csrc/bf_topk_fused_tc.cu",
                "vectorsimilarity_tpu/ops/pallas/bf_topk.py:742"),
    "topc": ("bf_topk_topc", "vectorsimilarity_tpu_torch/csrc/bf_topk_topc.cu",
             "vectorsimilarity_tpu/ops/pallas/bf_topk.py:742"),
}

# (B, tiles, tile_n, group_n, dim, count, metric name) — small odd shapes of
# the group-min kernel's fp32 lane.
SMALL_SHAPES = [
    (1, 3, 4096, 256, 768, 9000, "Cosine"),
    (7, 2, 4096, 256, 100, 5000, "L2"),
    (1024, 4, 4096, 256, 768, 12345, "IP"),
    (33, 4, 1024, 256, 768, 4000, "L2"),
    (130, 8, 64, 16, 64, 300, "Cosine"),
    (5, 2, 1024, 128, 37, 2000, "IP"),
]
# (B, N, dim, count, tile_n, group_n, c, k) — small odd shapes of every
# kernel and lane: B = 1, 7, 130; counts off the tile grid; dims whose rows
# are not a multiple of 16 bytes in some lane (37; 40 in the byte lanes); k
# above count; a tile below 128 rows.
LANE_SHAPES = [
    (1, 4096, 37, 3001, 1024, 256, 32, 100),
    (7, 2048, 40, 50, 512, 128, 16, 64),
    (130, 3072, 64, 3000, 64, 16, 64, 128),
]
# (B, N, dim, count, tile_n, group_n) — group-min shapes every lane's
# tensor-core K1 takes: B = 1, 7, 130, counts off the grid, G below and
# above the kernel's 128 columns, the headline dim.
GM_TC_SHAPES = [
    (1, 8192, 768, 7001, 4096, 256),
    (7, 4096, 96, 3999, 1024, 256),
    (130, 2048, 48, 2000, 512, 128),
    (130, 1024, 768, 1000, 128, 16),
]
# (B, N, dim, count, k, bound) — fused top-k shapes every lane's tensor-core
# K3 takes: B = 1, 7, 130, counts off the 128-row grid, m = 1, 40, 100, 128,
# ``bound`` = the slot of the plain version's list that serves as the lower
# bound (None: no bound).
FUSED_TC_SHAPES = [
    (1, 5000, 768, 4999, 128, None),
    (7, 3000, 64, 2900, 40, 17),
    (130, 20000, 96, 19999, 100, None),
    (130, 9000, 48, 8800, 1, None),
    (7, 70000, 128, 69001, 128, 60),
]
# (B, N, dim, count, tile_n, c) — per-tile top-c shapes every lane's
# tensor-core K4 takes: B = 1, 7, 130, tile_n = 128, 512, 4096, c = 1, 32,
# 128, a count inside a tile, counts that leave whole tiles empty (some past
# every range: the wrapper fills those), count = 0, ranges of several tiles.
TOPC_TC_SHAPES = [
    (1, 8192, 768, 7001, 4096, 32),
    (7, 4096, 96, 1500, 512, 128),
    (130, 16384, 48, 16000, 128, 1),
    (130, 4096, 64, 0, 128, 32),
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


def lists_error(got, ref, tol):
    """Max |distance difference| of two sets of sorted (distance, id) lists
    [R, m]. Unfilled slots (+inf, -1) must coincide; with ``tol`` = 0
    everything must be equal, else distances within ``tol`` and ids equal
    except at slots whose reference distance lies within ``tol`` of a
    neighbouring slot's. ``ref`` may hold one slot more than ``got``, the
    plain version's next pair: it decides whether got's last slot is such a
    near-tie (the kernel may then hold that next pair there)."""
    (d, i), (rd, ri) = got, ref
    m = d.shape[1]
    nxt = rd[:, m:m + 1]
    rd, ri = rd[:, :m], ri[:, :m]
    i, ri = i.to(torch.int64), ri.to(torch.int64)
    fin = torch.isfinite(rd)
    if not torch.equal(torch.isfinite(d), fin) or not bool((i[~fin] == -1).all()):
        raise AssertionError("kernel and plain version disagree on unfilled slots")
    err = float(torch.where(fin, d - rd, 0.0).abs().max()) if d.numel() else 0.0
    if tol == 0:
        if not (torch.equal(d, rd) and torch.equal(i, ri)):
            raise AssertionError(f"an exact lane differs from its plain version (err {err:.3e})")
        return err
    if not err <= tol:
        raise AssertionError(f"kernel disagrees with its plain version: {err:.3e}")
    ext = torch.cat([rd, nxt], dim=1)
    gap = torch.diff(torch.where(torch.isfinite(ext), ext, 0.0).double(), dim=1).abs() <= tol
    tied = torch.zeros_like(fin)
    tied[:, 1:] |= gap[:, :m - 1]
    tied[:, :gap.shape[1]] |= gap
    bad = (i != ri) & ~tied
    if bool(bad.any()):
        raise AssertionError(f"{int(bad.sum())} ids differ from the plain version's")
    return err


def lane_tol(lane, metric_name):
    if lane in ("s8", "u8"):
        return INT_COS_TOL if metric_name == "Cosine" else 0.0
    return TOL


def phase_build():
    from vectorsimilarity_tpu_torch.ops.kernels import bf_topk as bfk

    t0 = time.perf_counter()
    kern = bfk.load_kernel()
    print(f"# build: {time.perf_counter() - t0:.1f} s (nvcc, {len(kern.paths)} sources in "
          f"parallel: {kern.build_seconds:.1f} s) -> "
          f"{os.path.relpath(os.path.dirname(next(iter(kern.paths.values()))), REPO)}", flush=True)
    for src, log in kern.build_logs.items():
        if not log:
            print(f"#   ptxas {src}: built earlier in this checkout")
        entry = None
        for line in log.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                name = m.group(1)
                lane = re.search(r"Lane(\w+?)E(?:Li(\d))?", name)
                entry = ("row_sumsq" if "row_sumsq" in name else
                         name if lane is None else
                         lane.group(1) if lane.group(2) is None else
                         f"{lane.group(1)} metric={lane.group(2)}")
                spills = ""
            elif "spill" in line:
                spills = line.strip()
            elif "Used" in line and entry is not None:
                used = re.search(r"Used (\d+) registers", line)
                print(f"#   ptxas {src} {entry}: {used.group(1)} registers, {spills}")
                entry = None


def gm_checked(q, x, aux, count, want=None, **kw):
    """group_min_scores through the wrapper, asserting that the kernel the
    gate names (and ``want``, if given) launched once and the other not at
    all. Returns (gm, which kernel: "gm_tc" or "gm")."""
    from vectorsimilarity_tpu_torch.ops.kernels import bf_topk as bfk

    w = bfk.group_min_scores
    before = (w.tc_launches, w.launches)
    out = w(q, x, aux, count, **kw)
    which = "gm_tc" if bfk.gm_tc_admits(q, x) else "gm"
    moved = (w.tc_launches - before[0], w.launches - before[1])
    if moved != ((1, 0) if which == "gm_tc" else (0, 1)) or want not in (None, which):
        raise AssertionError(f"{tuple(x.shape)} {x.dtype}: launches moved {moved}, want "
                             f"{want or which}")
    return out, which


def fused_checked(q, x, aux, count, k, want=None, **kw):
    """fused_topk through the wrapper, asserting that the kernel the gate
    names (and ``want``, if given) launched once and the other not at all.
    Returns (lists, which kernel: "fused_tc" or "fused")."""
    from vectorsimilarity_tpu_torch.ops.kernels import bf_topk as bfk

    w = bfk.fused_topk
    before = (w.tc_launches, w.launches)
    out = w(q, x, aux, count, k, **kw)
    which = "fused_tc" if bfk.fused_tc_admits(q, x) else "fused"
    moved = (w.tc_launches - before[0], w.launches - before[1])
    if moved != ((1, 0) if which == "fused_tc" else (0, 1)) or want not in (None, which):
        raise AssertionError(f"{tuple(x.shape)} {x.dtype}: launches moved {moved}, want "
                             f"{want or which}")
    return out, which


def topc_checked(q, x, aux, count, want=None, **kw):
    """tile_topc through the wrapper, asserting that the kernel the gate
    names (and ``want``, if given) launched once and the other not at all.
    Returns (lists, which kernel: "topc_tc" or "topc")."""
    from vectorsimilarity_tpu_torch.ops.kernels import bf_topk as bfk

    w = bfk.tile_topc
    before = (w.tc_launches, w.launches)
    out = w(q, x, aux, count, **kw)
    which = "topc_tc" if bfk.topc_tc_admits(q, x, kw["tile_n"]) else "topc"
    moved = (w.tc_launches - before[0], w.launches - before[1])
    if moved != ((1, 0) if which == "topc_tc" else (0, 1)) or want not in (None, which):
        raise AssertionError(f"{tuple(x.shape)} {x.dtype}: launches moved {moved}, want "
                             f"{want or which}")
    return out, which


def flat_lists(pair):
    """[B, n_tiles, c] lists as [B * n_tiles, c]."""
    return tuple(t.reshape(-1, t.shape[-1]) for t in pair)


def topc_plain(q, x, aux, count, *, c, tile_n, **kw):
    """The plain K4 with the next pair of each tile where it has one, for
    the near-tie at a tile's c-th slot (the tensor-core fp32 lane rounds
    apart from the plain IEEE fp32)."""
    from vectorsimilarity_tpu_torch.ops.kernels import bf_topk as bfk

    return bfk.tile_topc_ref(q, x, aux, count, c=min(c + 1, tile_n), tile_n=tile_n, **kw)


def check_kernel(dev, shapes):
    """The group-min kernels' fp32 lane vs the plain version on each shape;
    returns {kernel: max abs error} over all shapes."""
    from vectorsimilarity_tpu_torch.ops.kernels import bf_topk as bfk
    from vectorsimilarity_tpu_torch.types import VecSimMetric

    gen = torch.Generator(device=dev).manual_seed(SEED + 1)
    worst = {"gm": 0.0, "gm_tc": 0.0}
    for B, tiles, tile_n, group_n, dim, count, mname in shapes:
        metric = VecSimMetric[mname]
        data = _unit_rows(gen, tiles * tile_n, dim, dev)
        q = _unit_rows(gen, B, dim, dev)
        sqn = torch.sum(data * data, dim=1) if metric == VecSimMetric.L2 else None
        kw = dict(metric=metric, tile_n=tile_n, group_n=group_n)
        got, which = gm_checked(q, data, sqn, count, **kw)
        ref = bfk.group_min_scores_ref(q, data, sqn, count, **kw)
        torch.cuda.synchronize()
        err, rel = gm_error(got, ref)
        print(f"# {KERNELS[which][0]} f32 vs plain B={B} N={data.shape[0]} D={dim} count={count} "
              f"tile_n={tile_n} G={group_n} {mname}: max abs err {err:.3e} (rel {rel:.3e})",
              flush=True)
        if not err <= TOL:
            raise AssertionError(f"kernel disagrees with its plain version: {err:.3e}")
        worst[which] = max(worst[which], err)
    return worst


def one_query(store, queries, smi):
    """The fp32 lane at the headline store with B = 1 (a block holds 128
    queries in K1, 64 in K3, so one query fills a block's first row): the
    tensor-core K1, the tensor-core K3 at k = 100 and the CUDA-core K3 at
    ``CC_DIM``, each held against its plain version and timed beside it.
    Returns {kernel: max abs error}."""
    from vectorsimilarity_tpu_torch.ops.kernels import bf_topk as bfk
    from vectorsimilarity_tpu_torch.types import VecSimMetric

    q = queries[:1].contiguous()
    metric = VecSimMetric.Cosine
    kw = dict(metric=metric, tile_n=TILE_N, group_n=GROUP_N)
    err, _ = gm_error(gm_checked(q, store, None, N, **kw)[0],
                      bfk.group_min_scores_ref(q, store, None, N, **kw))
    ms = time_ms(lambda: bfk.group_min_scores(q, store, None, N, **kw), 5)
    plain_ms = time_ms(lambda: bfk.group_min_scores_ref(q, store, None, N, **kw), 5)
    print(f"# bf_topk_gm_tc_f32 vs plain at {N} x {DIM}, B=1: max abs err {err:.3e}, kernel "
          f"{ms:.3f} ms, plain {plain_ms:.3f} ms; card {smi}", flush=True)
    if not err <= TOL:
        raise AssertionError(f"kernel disagrees with its plain version: {err:.3e}")
    errs = {"gm_tc": err}
    k = KS[1]
    cx = store[:, :CC_DIM["f32"]].contiguous()
    for which, qq, xx in (("fused_tc", q, store), ("fused", q[:, :CC_DIM["f32"]].contiguous(), cx)):
        err = lists_error(fused_checked(qq, xx, None, N, k, which, metric=metric)[0],
                          bfk.fused_topk_ref(qq, xx, None, N, k + 1, metric=metric), TOL)
        ms = time_ms(lambda: bfk.fused_topk(qq, xx, None, N, k, metric=metric), 5)
        plain_ms = time_ms(lambda: bfk.fused_topk_ref(qq, xx, None, N, k, metric=metric), 5)
        print(f"# {KERNELS[which][0]}_f32 vs plain at {N} x {xx.shape[1]}, B=1, k={k}: max abs "
              f"err {err:.3e}, kernel {ms:.3f} ms, plain {plain_ms:.3f} ms; card {smi}",
              flush=True)
        errs[which] = err
    del cx
    return errs


def lane_case(dev, gen, lane, mname, B, n, dim):
    """(q, x, aux, query_norms) of one lane and metric, made on the card."""
    if lane in ("s8", "u8"):
        lo, hi = (-128, 128) if lane == "s8" else (0, 256)
        x = torch.randint(lo, hi, (n, dim), generator=gen, device=dev).to(DTYPES[lane])
        q = torch.randint(lo, hi, (B, dim), generator=gen, device=dev).to(DTYPES[lane])
        if mname != "Cosine":
            return q, x, None, None
        norm = lambda t: t.double().square().sum(1).float().sqrt().clamp(min=1.0)
        return q, x, norm(x), norm(q)
    x = _unit_rows(gen, n, dim, dev).to(DTYPES[lane])
    q = _unit_rows(gen, B, dim, dev).to(DTYPES[lane])
    return q, x, (x.float().square().sum(1) if mname == "L2" else None), None


def lower_bound(tol, rd, ri, slot):
    """A per-query lower bound (lo_d, lo_i) from the plain version's sorted
    lists of at least slot + 9 pairs: the pair at ``slot`` itself where the
    lane is exact (``tol`` = 0, so the id rule decides), else, with id 0, the
    middle of the widest gap between slots slot .. slot + 8, so that the
    kernel's and the plain version's roundings cannot put a row on
    different sides of it."""
    if tol == 0:
        return rd[:, slot].contiguous(), ri[:, slot].contiguous()
    seg = rd[:, slot:slot + 9].double()
    j = torch.diff(seg, dim=1).argmax(dim=1, keepdim=True)
    mid = (seg.gather(1, j) + seg.gather(1, j + 1)) / 2
    return mid[:, 0].float().contiguous(), torch.zeros_like(ri[:, slot])


def check_lanes(dev):
    """Every kernel and lane vs its plain version at LANE_SHAPES (the K1s
    also at GM_TC_SHAPES, the tensor-core K3 at FUSED_TC_SHAPES, the
    tensor-core K4 at TOPC_TC_SHAPES), all three metrics. Returns {(kernel,
    lane): max abs error}."""
    from vectorsimilarity_tpu_torch.ops.kernels import bf_topk as bfk
    from vectorsimilarity_tpu_torch.types import VecSimMetric

    gen = torch.Generator(device=dev).manual_seed(SEED + 2)
    worst = {(k, lane): 0.0 for k in KERNELS for lane in LANES}
    gm_shapes = [(B, n, dim, count, tile_n, group_n) for B, n, dim, count, tile_n, group_n, _, _
                 in LANE_SHAPES] + GM_TC_SHAPES
    for lane in LANES:
        for mname in ("L2", "IP", "Cosine"):
            tol = lane_tol(lane, mname)
            for B, n, dim, count, tile_n, group_n in gm_shapes:
                q, x, aux, qn = lane_case(dev, gen, lane, mname, B, n, dim)
                kw = dict(metric=VecSimMetric[mname], query_norms=qn)
                got, which = gm_checked(q, x, aux, count, tile_n=tile_n, group_n=group_n, **kw)
                ref = bfk.group_min_scores_ref(q, x, aux, count, tile_n=tile_n, group_n=group_n,
                                               **kw)
                err, _ = gm_error(got, ref)
                if not err <= tol:
                    raise AssertionError(f"{which} {lane} {mname} B={B} D={dim}: err {err:.3e} > "
                                         f"{tol}")
                worst[which, lane] = max(worst[which, lane], err)
            for B, n, dim, count, tile_n, group_n, c, k in LANE_SHAPES:
                q, x, aux, qn = lane_case(dev, gen, lane, mname, B, n, dim)
                kw = dict(metric=VecSimMetric[mname], query_norms=qn)
                got, which = fused_checked(q, x, aux, count, k, **kw)
                ref = bfk.fused_topk_ref(q, x, aux, count, k + 1, **kw)
                worst[which, lane] = max(worst[which, lane], lists_error(got, ref, tol))
                got, which = topc_checked(q, x, aux, count, tile_n=tile_n, c=c, **kw)
                ref = topc_plain(q, x, aux, count, tile_n=tile_n, c=c, **kw)
                worst[which, lane] = max(worst[which, lane],
                                         lists_error(flat_lists(got), flat_lists(ref), tol))
            for B, n, dim, count, k, bound in FUSED_TC_SHAPES:
                q, x, aux, qn = lane_case(dev, gen, lane, mname, B, n, dim)
                kw = dict(metric=VecSimMetric[mname], query_norms=qn)
                if bound is not None:
                    rd, ri = bfk.fused_topk_ref(q, x, aux, count, bound + 9, **kw)
                    kw["lo"] = lower_bound(tol, rd, ri, bound)
                got, _ = fused_checked(q, x, aux, count, k, "fused_tc", **kw)
                ref = bfk.fused_topk_ref(q, x, aux, count, k + 1, **kw)
                worst["fused_tc", lane] = max(worst["fused_tc", lane], lists_error(got, ref, tol))
            for B, n, dim, count, tile_n, c in TOPC_TC_SHAPES:
                q, x, aux, qn = lane_case(dev, gen, lane, mname, B, n, dim)
                kw = dict(metric=VecSimMetric[mname], query_norms=qn, tile_n=tile_n, c=c)
                got, _ = topc_checked(q, x, aux, count, "topc_tc", **kw)
                ref = topc_plain(q, x, aux, count, **kw)
                worst["topc_tc", lane] = max(worst["topc_tc", lane],
                                             lists_error(flat_lists(got), flat_lists(ref), tol))
        torch.cuda.synchronize()
        print(f"# {lane}: {', '.join(KERNELS)} vs plain at {len(gm_shapes)} (K1), "
              f"{len(LANE_SHAPES) + len(FUSED_TC_SHAPES)} (K3) and "
              f"{len(LANE_SHAPES) + len(TOPC_TC_SHAPES)} (K4) odd shapes x 3 metrics: max abs "
              f"err {', '.join(f'{worst[k, lane]:.3e}' for k in KERNELS)}", flush=True)
    return worst


def exact_truth(queries, store, count, k, norms=None, qnorms=None):
    """float64 exact cosine distances and ids (lex order) of the k best, and
    the whole [Q, count] distance matrix. Integer stores: the dot is exact in
    float64 and is divided by the float64 product of the two norms."""
    q64 = queries.double()
    parts = []
    for lo in range(0, count, 1 << 17):
        hi = min(lo + (1 << 17), count)
        ip = q64 @ store[lo:hi].double().T
        if norms is not None:
            ip = ip / (qnorms.double()[:, None] * norms[lo:hi].double()[None, :])
        parts.append(1.0 - ip)
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


def bound_ms(lane, out_bytes, aux_bytes=0, dim=DIM):
    """(least ms the card could take, what bounds it) for scoring BATCH
    queries against the N live rows of ``dim`` in ``lane``: the larger of
    the bytes moved once (queries, live rows, auxiliaries in; the result out)
    over the memory rate and the lane's passes of 2 B N D operations over its
    tensor-core peak."""
    esize = torch.empty((), dtype=DTYPES[lane]).element_size()
    byte_ms = 1e3 * ((BATCH + N) * dim * esize + aux_bytes + out_bytes) / PEAK_BYTES
    op_ms = 1e3 * PASSES[lane] * 2.0 * BATCH * N * dim / PEAK_OPS[lane]
    return (op_ms, "operations") if op_ms >= byte_ms else (byte_ms, "bytes")


def int_norms(t):
    """The stored norms of integer rows, as the index keeps them (fp32,
    at least 1), computed in float64 a chunk at a time."""
    return torch.cat([c.double().square().sum(1).float().sqrt().clamp(min=1.0)
                      for c in t.split(1 << 17)])


def product_ms(lane, queries, store):
    """Time of the bare product queries [B, D] x store[:N]^T at the lane's
    type, one PyTorch call (fp32 with TF32 off, as config.py pins it): the
    yardstick for K1's tensor-core core. None for uint8 (no u8 product)."""
    if lane == "u8":
        return None
    x = store[:N].t()
    if lane == "s8":
        return time_ms(lambda: torch._int_mm(queries, x), 3)
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the fp32 product would not be fp32")
    return time_ms(lambda: torch.matmul(queries, x), 3)


def full_width(lane, store, norms, raw_queries, smi, small_err):
    """Phase 5 for one store type; ``raw_queries`` [BATCH, DIM] go through the
    index's own preprocessing for the host API and the device path alike.
    Returns every kernel's result row."""
    from vectorsimilarity_tpu_torch.indexes.brute_force import BruteForceIndex
    from vectorsimilarity_tpu_torch.ops.kernels import bf_topk as bfk
    from vectorsimilarity_tpu_torch.types import BFParams, VecSimMetric, VecSimType

    metric = VecSimMetric.Cosine
    idx = BruteForceIndex(BFParams(type=VecSimType[VTYPES[lane]], dim=DIM, metric=metric))
    if idx.store.device.type != "cuda":
        raise AssertionError("an index built with no device is not on the card")
    arrays = {"data": store} if norms is None else {"data": store, "norm": norms}
    idx.store.adopt_device(arrays, count=N)
    idx.labels.label_to_id = dict(zip(range(N), range(N)))
    idx.store.host["label"][:N] = np.arange(N, dtype=np.int64)
    raw = raw_queries.float().cpu().numpy().astype(idx.np_dtype)
    host_queries = raw[:64]
    queries, qnorms = (idx.to_device(a) for a in idx.preprocess_queries(raw))
    counters = {"gm_tc": (bfk.group_min_scores, "tc_launches"),
                "gm": (bfk.group_min_scores, "launches"),
                "fused_tc": (bfk.fused_topk, "tc_launches"),
                "fused": (bfk.fused_topk, "launches"),
                "topc_tc": (bfk.tile_topc, "tc_launches"), "topc": (bfk.tile_topc, "launches")}
    engine_of = dict(zip(KS, ("gm_tc", "fused_tc", "topc_tc")))

    # The main path, counts at 0 just before and read just after.
    for w, attr in counters.values():
        setattr(w, attr, 0)
    bfk.topk_gm_exact.fallbacks = bfk.topk_bigk_exact.fallbacks = 0
    out = {}
    for k in KS:
        out[k] = (idx.topk_query_batch(host_queries, k), idx.search_knn_device(queries, k,
                                                                               qn=qnorms))
    torch.cuda.synchronize()
    launches = {name: getattr(w, attr) for name, (w, attr) in counters.items()}
    fallbacks = {"gm_tc": bfk.topk_gm_exact.fallbacks, "gm": 0, "fused_tc": 0, "fused": 0,
                 "topc_tc": bfk.topk_bigk_exact.fallbacks, "topc": 0}
    print(f"# main path {lane}: launches {launches}, fallbacks {fallbacks}", flush=True)
    if any(launches[e] < 2 for e in engine_of.values()):
        raise AssertionError("an engine of the main path did not launch its kernel")
    if launches["gm"]:
        raise AssertionError("the main path ran the CUDA-core K1, not the tensor-core one")
    if launches["fused"]:
        raise AssertionError("the main path ran the CUDA-core K3, not the tensor-core one")
    if launches["topc"]:
        raise AssertionError("the main path ran the CUDA-core K4, not the tensor-core one")
    if any(fallbacks.values()):
        raise AssertionError("an exact fallback ran on random data")

    rd, ri, s64 = exact_truth(queries[:32], store, N, max(KS) + 1, norms,
                              None if qnorms is None else qnorms[:32])
    for k in KS:
        replies, (dists, ids) = out[k]
        if tuple(dists.shape) != (BATCH, k) or not bool(torch.isfinite(dists).all()):
            raise AssertionError(f"bad result shape or values: {tuple(dists.shape)}")
        assert_knn(dists[:32].cpu().numpy(), ids[:32].cpu().numpy(), rd[:, :k + 1], ri, s64)
        hd = np.stack([r.scores for r in replies[:32]])
        hi = np.stack([r.ids for r in replies[:32]])  # labels == row ids here
        assert_knn(hd, hi, rd[:, :k + 1], ri, s64)
    del s64, out
    print(f"# main path {lane}: 32 queries match the float64 exact top-k at k = {KS} "
          f"(host API and device path), tolerance {TOL}", flush=True)

    # Each kernel against its plain version at the main path's shape, timed.
    tol = lane_tol(lane, "Cosine")
    kw = dict(metric=metric, query_norms=qnorms)
    gm_kw = dict(tile_n=TILE_N, group_n=GROUP_N, **kw)
    topc_kw = dict(tile_n=TILE_N, c=LOCAL_C, **kw)
    gm_cmp = lambda got, ref: gm_error(got, ref)[0]
    # The CUDA-core kernels' shape: the same rows and queries cut to CC_DIM.
    cut = lambda t: t[:, :CC_DIM[lane]].contiguous()
    cq, cx = cut(queries), cut(store)
    cn, cqn = (None, None) if norms is None else (int_norms(cx), int_norms(cq))
    cc_kw = dict(gm_kw, query_norms=cqn)
    cc_fused_kw = dict(kw, query_norms=cqn)
    cc_topc_kw = dict(topc_kw, query_norms=cqn)
    lists_cmp = lambda got, ref: lists_error(got, ref, tol)
    topc_cmp = lambda got, ref: lists_error(flat_lists(got), flat_lists(ref), tol)
    calls = {
        "gm_tc": (lambda: gm_checked(queries, store, norms, N, "gm_tc", **gm_kw)[0],
                  lambda: bfk.group_min_scores_ref(queries, store, norms, N, **gm_kw), gm_cmp),
        "gm": (lambda: gm_checked(cq, cx, cn, N, "gm", **cc_kw)[0],
               lambda: bfk.group_min_scores_ref(cq, cx, cn, N, **cc_kw), gm_cmp),
        "fused_tc": (lambda: fused_checked(queries, store, norms, N, KS[1], "fused_tc", **kw)[0],
                     lambda: bfk.fused_topk_ref(queries, store, norms, N, KS[1], **kw),
                     lists_cmp,
                     lambda: bfk.fused_topk_ref(queries, store, norms, N, KS[1] + 1, **kw)),
        "fused": (lambda: fused_checked(cq, cx, cn, N, KS[1], "fused", **cc_fused_kw)[0],
                  lambda: bfk.fused_topk_ref(cq, cx, cn, N, KS[1], **cc_fused_kw), lists_cmp,
                  lambda: bfk.fused_topk_ref(cq, cx, cn, N, KS[1] + 1, **cc_fused_kw)),
        "topc_tc": (lambda: topc_checked(queries, store, norms, N, "topc_tc", **topc_kw)[0],
                    lambda: bfk.tile_topc_ref(queries, store, norms, N, **topc_kw), topc_cmp,
                    lambda: topc_plain(queries, store, norms, N, **topc_kw)),
        "topc": (lambda: topc_checked(cq, cx, cn, N, "topc", **cc_topc_kw)[0],
                 lambda: bfk.tile_topc_ref(cq, cx, cn, N, **cc_topc_kw), topc_cmp),
    }
    gm_out = BATCH * (CAP // TILE_N) * GROUP_N * 4
    topc_out = BATCH * (CAP // TILE_N) * LOCAL_C * 8
    out_bytes = {"gm_tc": gm_out, "gm": gm_out, "fused_tc": BATCH * KS[1] * 8,
                 "fused": BATCH * KS[1] * 8, "topc_tc": topc_out, "topc": topc_out}
    aux_bytes = 0 if norms is None else (N + BATCH) * 4
    dims = {name: CC_DIM[lane] if name in ("gm", "fused", "topc") else DIM for name in calls}
    prods = {DIM: product_ms(lane, queries, store), CC_DIM[lane]: product_ms(lane, cq, cx)}
    if lane == "f32":
        tf32_ms = 1e3 * PASSES[lane] * 2.0 * BATCH * N * DIM / TF32_PEAK
        print(f"# f32 bound as the tensor-core K1's 3xTF32 (three passes at the TF32 peak): "
              f"{tf32_ms:.3f} ms at {N} x {DIM}, B={BATCH}", flush=True)
    rows = {}
    # (kernel, plain version, comparison[, the plain call it compares with:
    # the tensor-core K3's and K4's carry one slot more, for the near-tie at
    # the last slot])
    for name, (kernel, plain, compare, *check) in calls.items():
        err = compare(kernel(), (check[0] if check else plain)())
        if not err <= tol:
            raise AssertionError(f"{name} {lane}: kernel disagrees with plain: {err:.3e}")
        ms, plain_ms = time_ms(kernel, 3), time_ms(plain, 2)
        least, by = bound_ms(lane, out_bytes[name], aux_bytes, dims[name])
        prod = prods[dims[name]]
        row = {
            "name": f"{KERNELS[name][0]}_{lane}", "route": "cuda", "source": KERNELS[name][1],
            "replaces": KERNELS[name][2], "launches": launches[name],
            "max_abs_err": max(err, small_err[name, lane]), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": least, "bound_by": by, "library_ms": None, "product_ms": prod,
            "fallbacks": fallbacks[name],
        }
        print(f"# {row['name']} vs plain at {N} x {dims[name]}, B={BATCH}: max abs err "
              f"{err:.3e}, kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {least:.3f} ms "
              f"({by}), product {'none' if prod is None else f'{prod:.3f} ms'}; card {smi}",
              flush=True)
        rows[name] = row
    del cq, cx, cn, cqn

    # The cost of K3's Cosine epilogue: the tensor-core K3 at IP on the same
    # rows and queries (no norms), beside its Cosine time above.
    ip_kw = dict(metric=VecSimMetric.IP)
    ip_ms = time_ms(lambda: fused_checked(queries, store, None, N, KS[1], "fused_tc",
                                          **ip_kw), 3)
    print(f"# {rows['fused_tc']['name']} at {N} x {DIM}, B={BATCH}, k={KS[1]}: IP "
          f"{ip_ms:.3f} ms, Cosine {rows['fused_tc']['ms']:.3f} ms; card {smi}", flush=True)
    reset_trial(lane, queries, store, norms, qnorms, smi)

    # QPS of the device path, one engine per k.
    staged = [queries, queries.flip(0).contiguous()]
    staged_qn = [qnorms, None if qnorms is None else qnorms.flip(0).contiguous()]
    for k in KS:
        row = rows[engine_of[k]]
        rounds = []
        for _ in range(3):
            t0 = time.perf_counter()
            for qb, qn in zip(staged, staged_qn):
                idx.search_knn_device(qb, k, qn=qn)
            torch.cuda.synchronize()
            rounds.append(len(staged) * BATCH / (time.perf_counter() - t0))
        row["qps"] = statistics.median(rounds)
        batch_ms = 1000 * BATCH / row["qps"]
        print(f"# search_knn_device {N} x {DIM} {lane} cosine, B={BATCH}, k={k} "
              f"({engine_of[k]}): {row['qps']:.1f} QPS (median of "
              f"{[round(r, 1) for r in rounds]}), {batch_ms:.2f} ms per batch, of which "
              f"{batch_ms - row['ms']:.2f} outside the kernel; card {smi}", flush=True)
    return list(rows.values())


def reset_trial(lane, queries, store, norms, qnorms, smi):
    """The cost of the tensor-core K4's per-tile list resets: its kernel at
    the headline's split (the same ranges of whole tiles, c = LOCAL_C) once
    with one list per tile (K4) and once with one list per range (K3's
    configuration, ``bf_topk_fused_tc`` at m = c), both called bare through
    the C entry points, so no wrapper counts them."""
    from vectorsimilarity_tpu_torch.ops.kernels import bf_topk as bfk
    from vectorsimilarity_tpu_torch.types import VecSimMetric

    kern = bfk.load_kernel()
    metric = VecSimMetric.Cosine
    n_tiles = CAP // TILE_N
    tiles, n_ranges = bfk._topc_tc_ranges(BATCH, -(-N // TILE_N), bfk._sms(store.device))
    qf, qi, rf = (bfk._ptr(t) for t in bfk._lane_aux(queries, norms, metric, qnorms))
    out_d = torch.empty((BATCH, n_tiles, LOCAL_C), dtype=torch.float32, device=store.device)
    out_i = torch.empty((BATCH, n_tiles, LOCAL_C), dtype=torch.int32, device=store.device)
    code, stream = bfk._LANES[store.dtype], torch.cuda.current_stream().cuda_stream
    head = (queries.data_ptr(), store.data_ptr(), qf, qi, rf, None)

    def ok(err):
        if err != 0:
            raise AssertionError(f"reset trial launch failed: cudaError_t {err}")

    per_tile = lambda: ok(kern.topc_tc(*head, out_d.data_ptr(), out_i.data_ptr(), code, BATCH,
                                       DIM, n_tiles, TILE_N, LOCAL_C, N, tiles, n_ranges,
                                       int(metric), stream))
    per_range = lambda: ok(kern.fused_tc(*head, None, None, out_d.data_ptr(), out_i.data_ptr(),
                                         code, BATCH, DIM, CAP, tiles * TILE_N, n_ranges,
                                         LOCAL_C, N, int(metric), stream))
    # In turns: a list per range, per tile, per tile, per range.
    r0, t0, t1, r1 = (time_ms(f, 3) for f in (per_range, per_tile, per_tile, per_range))
    range_ms, tile_ms = (r0 + r1) / 2, (t0 + t1) / 2
    print(f"# reset trial {lane} at {N} x {DIM}, B={BATCH}, {n_ranges} ranges of {tiles} tiles, "
          f"m = {LOCAL_C}: a list per tile {tile_ms:.3f} ms ({t0:.3f}, {t1:.3f}), a list per "
          f"range {range_ms:.3f} ms ({r0:.3f}, {r1:.3f}); "
          f"the resets cost {tile_ms - range_ms:.3f} ms ({(tile_ms - range_ms) / tile_ms:.1%} of "
          f"K4); card {smi}", flush=True)


def phase_fallbacks(dev):
    """Both exact fallbacks, tripped on purpose."""
    from vectorsimilarity_tpu_torch import config
    from vectorsimilarity_tpu_torch.indexes.brute_force import BruteForceIndex
    from vectorsimilarity_tpu_torch.ops.kernels import bf_topk as bfk
    from vectorsimilarity_tpu_torch.types import BFParams, VecSimMetric, VecSimType

    # All-ties store: every group minimum ties, coverage cannot be shown,
    # the exact fallback must answer with ids 0..k-1.
    params = BFParams(type=VecSimType.FLOAT32, dim=DIM, metric=VecSimMetric.Cosine)
    ties = BruteForceIndex(params, device=dev)
    row = torch.full((1, DIM), DIM ** -0.5, device=dev)
    ties.store.adopt_device({"data": row.repeat(8192, 1)}, count=5000)
    before = bfk.topk_gm_exact.fallbacks
    td, ti = ties.search_knn_device(row.repeat(4, 1), KS[0])
    if bfk.topk_gm_exact.fallbacks != before + 1:
        raise AssertionError("the all-ties case did not fall back")
    if not (ti.cpu() == torch.arange(KS[0])).all() or float(td.abs().max()) > 1e-6:
        raise AssertionError(f"all-ties fallback returned {ti[0].tolist()}")
    print("# all-ties store: group-min fallback ran and returned ids 0..k-1", flush=True)

    # The 200 rows nearest to the query all sit in tile 0 of 64: that tile's
    # 32nd best lies inside the global top-160, the truncation flag fires, and
    # the streaming scan must answer with exactly those rows.
    gen = torch.Generator(device=dev).manual_seed(SEED + 3)
    x = _unit_rows(gen, 64 * TILE_N, DIM, dev)
    q = _unit_rows(gen, 4, DIM, dev)
    x[:200] = torch.nn.functional.normalize(
        q[0] + 0.02 * torch.randn((200, DIM), generator=gen, device=dev), dim=1)
    near = BruteForceIndex(params, device=dev)
    near.store.adopt_device({"data": x}, count=64 * TILE_N - 77)
    k = 160
    if not config.bigk_enabled("float", 256, 64 * TILE_N, torch.float32):
        raise AssertionError("the truncation case is gated off the top-c engine")
    before = bfk.topk_bigk_exact.fallbacks
    launched = (bfk.tile_topc.tc_launches, bfk.tile_topc.launches)
    d, i = near.search_knn_device(q, k)
    moved = (bfk.tile_topc.tc_launches - launched[0], bfk.tile_topc.launches - launched[1])
    if moved != (1, 0) or bfk.topk_bigk_exact.fallbacks != before + 1:
        raise AssertionError(f"the one-tile case did not trip the truncation fallback through "
                             f"the tensor-core K4 (launches moved {moved})")
    rd, ri, s64 = exact_truth(q, x, 64 * TILE_N - 77, k + 1)
    assert_knn(d.cpu().numpy(), i.cpu().numpy(), rd, ri, s64)
    if set(i[0].tolist()) - set(range(200)):
        raise AssertionError("the truncation fallback missed planted rows")
    print(f"# one-tile store: the tensor-core K4's truncation flag fired at k={k}, the "
          "fallback matches the float64 exact top-k", flush=True)


# The HNSW phase: the reference's HNSW configuration (M = 16, efConstruction
# = 200; benchmarks/run_all.py) on N embedding-like fp32 Cosine rows, N a cut
# of the reference's 1M for the smoke's time (PERF.md), with 1024 held-out
# rows of the same generation as queries.
HNSW_N, HNSW_M, HNSW_EFC = 100_000, 16, 200
HNSW_EFS = (10, 100, 200, 500)
HNSW_MIN_RECALL = 0.90  # recall@10 at ef = 200; the JAX package: 0.928 at 200k


def exact_labels(data, labels, queries, k):
    """Labels [B, k] of the exact top-k of ``queries`` over the fp32 Cosine
    rows ``data`` [n, DIM] on the card (``labels`` [n] numpy, the label of
    each row): the port's flat index (``search_knn_device``, kernel K1)."""
    from vectorsimilarity_tpu_torch import create_index
    from vectorsimilarity_tpu_torch import types as T
    from vectorsimilarity_tpu_torch.core.store import _bucket_capacity

    n = data.shape[0]
    bf = create_index(T.VecSimParams(algo=T.VecSimAlgo.BF, bfParams=T.BFParams(
        type=T.VecSimType.FLOAT32, dim=DIM, metric=T.VecSimMetric.Cosine)))
    padded = torch.zeros((_bucket_capacity(n, bf.store.block_size), DIM), dtype=torch.float32,
                         device=data.device)
    padded[:n] = data
    bf.store.adopt_device({"data": padded}, count=n)
    _, ids = bf.search_knn_device(queries, k)
    return np.asarray(labels)[ids.cpu().numpy()]


def label_recall(got, truth):
    """Mean share of each row of ``truth`` [B, k] found in the same row of
    ``got`` [B, >= k] (labels; the first k columns count)."""
    k = truth.shape[1]
    return float(np.mean([len(set(a[:k].tolist()) & set(b.tolist())) / k
                          for a, b in zip(got, truth)]))


def reply_labels(replies, k):
    """The labels of a list of replies as [B, k], -1 where a reply is short."""
    out = np.full((len(replies), k), -1, dtype=np.int64)
    for j, r in enumerate(replies):
        out[j, : len(r)] = r.ids[:k]
    return out


def phase_hnsw(dev, smi, n=HNSW_N, writes=True, keep=None):
    """Build the HNSW index on the card through the entry points a user
    calls, search it at each ef, and hold recall@10 against the port's exact
    flat index on the same rows (``search_knn_device``, kernel K1). Prints
    build seconds and vectors per second, QPS, recall and host reads per ef,
    and the peak device memory, each beside the card's name and power
    limit. With ``writes``, phase 8 (``phase_hnsw_writes``) runs on the same
    index before it is freed. With a dict ``keep``, the index and its
    queries stay alive in ``keep["hnsw"]`` for phase 12. Returns {"build_s",
    "qps", "recall", ...}."""
    from vectorsimilarity_tpu_torch import api, config, create_index
    from vectorsimilarity_tpu_torch import types as T
    from vectorsimilarity_tpu_torch.ops import graph_search as gs
    from vectorsimilarity_tpu_torch.utils.synthetic import embedding_like

    k = 10
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = embedding_like(gen, n + BATCH, DIM)
    data, queries = rows[:n], rows[n:]
    idx = create_index(T.VecSimParams(algo=T.VecSimAlgo.HNSWLIB, hnswParams=T.HNSWParams(
        type=T.VecSimType.FLOAT32, dim=DIM, metric=T.VecSimMetric.Cosine,
        M=HNSW_M, efConstruction=HNSW_EFC, initialCapacity=n)))
    if idx.device.type != "cuda":
        raise AssertionError(f"create_index put the HNSW index on {idx.device}")
    reads0, it0 = gs.host_reads, gs.iterations
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx.bulk_build_device(data, batch=config.build_batch, scan_batches=config.build_scan_batches)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_batches = -(-n // config.build_batch)
    out = {"n": n, "build_s": build_s, "build_vps": n / build_s,
           "build_reads": (gs.host_reads - reads0) / n_batches,
           "build_iters": (gs.iterations - it0) / n_batches, "dropped": idx.build_dropped()}
    print(f"# hnsw build {n} x {DIM} fp32 Cosine M={HNSW_M} efC={HNSW_EFC}: {build_s:.1f} s, "
          f"{n / build_s:.1f} vectors/s, {out['build_reads']:.1f} host reads and "
          f"{out['build_iters']:.1f} loop iterations per batch of {config.build_batch}, "
          f"max level {idx.max_level}, dropped back-edges {out['dropped']}; card {smi}",
          flush=True)
    if out["dropped"]:
        print(f"# hnsw build dropped {out['dropped']} reverse edges (row cap)", flush=True)

    # Ground truth: the port's exact flat index on the same rows (K1).
    truth = exact_labels(data, np.arange(n), queries, k)

    def recall(ids):
        return label_recall(ids, truth)

    out["qps"], out["recall"], out["reads"], out["ms"] = {}, {}, {}, {}
    for ef in HNSW_EFS:
        idx.search_knn_device(queries, k, ef)  # warm-up
        torch.cuda.synchronize()
        times, reads = [], 0
        for _ in range(3):
            r0 = gs.host_reads
            t0 = time.perf_counter()
            d, i = idx.search_knn_device(queries, k, ef)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            reads = gs.host_reads - r0
        ms = statistics.median(times) * 1e3
        rec = recall(i.cpu().numpy())
        out["qps"][ef], out["recall"][ef], out["reads"][ef], out["ms"][ef] = (
            BATCH * 1e3 / ms, rec, reads, ms)
        print(f"# hnsw search B={BATCH} k={k} ef={ef}: {ms:.2f} ms per batch (median of "
              f"{[round(t * 1e3, 2) for t in times]}), {BATCH * 1e3 / ms:.1f} QPS, recall@10 "
              f"{rec:.4f}, {reads} host reads per batch; card {smi}", flush=True)
        if not torch.isfinite(d[:, :k]).all():
            raise AssertionError(f"non-finite distances at ef={ef}")
    # The host API: the batch at ef = 200, and 32 queries one by one through
    # the C API's VecSimIndex_TopKQuery; labels are row ids here.
    qp = T.VecSimQueryParams()
    qp.hnswRuntimeParams.efRuntime = 200
    host = np.asarray(queries.cpu())
    t0 = time.perf_counter()
    replies = idx.topk_query_batch(host, k, qp)
    host_ms = (time.perf_counter() - t0) * 1e3
    rec = recall(np.stack([r.ids for r in replies]))
    one = [api.VecSimIndex_TopKQuery(idx, host[j], k, qp) for j in range(32)]
    for j, r in enumerate(one):
        if len(r) != k or not np.array_equal(r.ids, replies[j].ids):
            raise AssertionError(f"VecSimIndex_TopKQuery of query {j} differs from the batch")
    out["host_ms"], out["host_recall"] = host_ms, rec
    print(f"# hnsw host API topk_query_batch B={BATCH} ef=200: {host_ms:.2f} ms, recall@10 "
          f"{rec:.4f}; 32 VecSimIndex_TopKQuery calls equal the batch's rows; card {smi}",
          flush=True)
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"# hnsw peak device memory {out['peak_gib']:.2f} GiB; card {smi}", flush=True)
    if out["recall"][200] < HNSW_MIN_RECALL or rec < HNSW_MIN_RECALL:
        raise AssertionError(f"HNSW recall@10 at ef=200 below {HNSW_MIN_RECALL}: "
                             f"{out['recall'][200]:.4f} (host API {rec:.4f})")
    if writes:
        out["writes"] = phase_hnsw_writes(idx, queries, smi)
    if keep is not None:
        keep["hnsw"] = (idx, queries)
    del idx, rows, data, queries
    torch.cuda.empty_cache()
    return out


# Phase 8: the write path on phase 7's index (the reference's updated-index
# workload, benchmarks/run_all.py BM_VecSimUpdatedIndex): eager deletes, an
# insert batch that overwrites live labels (more than 8: the bulk branch),
# tombstones removed by one bulk pass.
WRITE_EAGER, WRITE_BATCH = 64, 1024


def _new_rows(dev, n, seed):
    """``n`` embedding-like rows on the smoke corpus's manifold (its
    projection, another latent seed), on the card."""
    from vectorsimilarity_tpu_torch.utils.synthetic import embedding_like

    gen = torch.Generator(device=dev).manual_seed(SEED)
    lat = torch.Generator(device=dev).manual_seed(seed)
    return embedding_like(gen, n, DIM, latent_generator=lat)


def _check_replies(replies, truth, gone, what, smi, floor=HNSW_MIN_RECALL):
    """recall@10 of the replies against ``truth`` (labels) at least
    ``floor``, and no label of ``gone`` in any reply."""
    got = reply_labels(replies, truth.shape[1])
    rec = label_recall(got, truth)
    back = set(np.unique(got).tolist()) & gone
    print(f"# {what}: recall@10 {rec:.4f} by label against the exact flat index over the "
          f"live rows, {len(back)} deleted labels in the replies; card {smi}", flush=True)
    if back:
        raise AssertionError(f"{what}: deleted labels answered: {sorted(back)[:8]}")
    if rec < floor:
        raise AssertionError(f"{what}: recall@10 {rec:.4f} below {floor}")
    return rec


def phase_hnsw_writes(idx, queries, smi):
    """Phase 8 on phase 7's HNSW index (its vectors only on the card): 64
    eager ``delete_vector`` calls, one ``add_vector_batch`` overwriting 1024
    live labels, ``mark_delete`` of 1024 more and one
    ``delete_tombstoned_bulk``, then ``topk_query_batch`` at B = 1024, k =
    10, ef = 200. Checks recall@10 by label against the exact flat index
    over the live rows, that no deleted label answers, and that each
    overwritten label's new vector finds its label first at distance <=
    1e-4. Prints ms per delete, the seconds of the overwrite and the bulk
    pass, the rows it repaired, and the peak device memory."""
    from vectorsimilarity_tpu_torch import types as T

    k, dev, n = 10, idx.device, idx.store.count
    labels = np.random.default_rng(SEED + 8).permutation(n)
    eager = labels[:WRITE_EAGER]
    over = labels[WRITE_EAGER : WRITE_EAGER + WRITE_BATCH]
    tomb = labels[WRITE_EAGER + WRITE_BATCH : WRITE_EAGER + 2 * WRITE_BATCH]
    torch.cuda.reset_peak_memory_stats()
    out = {}
    times = []
    for lab in eager:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if idx.delete_vector(int(lab)) != 1:
            raise AssertionError(f"delete_vector({lab}) removed nothing")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["delete_ms"] = statistics.median(times)
    out["delete_ms_mean"] = statistics.fmean(times)
    print(f"# hnsw writes: {WRITE_EAGER} eager delete_vector calls, {out['delete_ms']:.2f} ms per "
          f"delete (median; mean {out['delete_ms_mean']:.2f}, first {times[0]:.2f}, which pulls "
          f"the device-built links to the host once); card {smi}", flush=True)

    new = _new_rows(dev, WRITE_BATCH, SEED + 8).cpu().numpy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fresh = idx.add_vector_batch(new, over.tolist())
    torch.cuda.synchronize()
    out["overwrite_s"] = time.perf_counter() - t0
    if fresh != 0 or len(idx.labels) != n - WRITE_EAGER:
        raise AssertionError(f"the overwrite batch added {fresh} labels")
    print(f"# hnsw writes: add_vector_batch overwriting {WRITE_BATCH} live labels (tombstones, "
          f"one bulk pass, then the insert): {out['overwrite_s']:.3f} s, "
          f"{idx.last_bulk_repairs} rows repaired; card {smi}", flush=True)

    ids = []
    for lab in tomb:
        ids += idx.mark_delete(int(lab))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    removed = idx.delete_tombstoned_bulk(ids)
    torch.cuda.synchronize()
    out["bulk_s"] = time.perf_counter() - t0
    idx.num_marked_deleted -= removed  # the caller's, as the tiered GC does
    out["bulk_repaired"] = idx.last_bulk_repairs
    if removed != WRITE_BATCH or idx.store.count != n - WRITE_EAGER - WRITE_BATCH:
        raise AssertionError(f"delete_tombstoned_bulk removed {removed}")
    print(f"# hnsw writes: mark_delete of {WRITE_BATCH} labels, then delete_tombstoned_bulk: "
          f"{out['bulk_s']:.3f} s, {out['bulk_repaired']} rows repaired of "
          f"{idx.store.count} live; card {smi}", flush=True)

    qp = T.VecSimQueryParams()
    qp.hnswRuntimeParams.efRuntime = 200
    host = np.asarray(queries.cpu())
    t0 = time.perf_counter()
    replies = idx.topk_query_batch(host, k, qp)
    out["query_ms"] = (time.perf_counter() - t0) * 1e3
    count = idx.store.count
    truth = exact_labels(idx.store.device_arrays()["data"][:count],
                         idx.store.host["label"][:count], queries, k)
    gone = set(eager.tolist()) | set(tomb.tolist())
    out["recall"] = _check_replies(replies, truth, gone, "hnsw writes: topk_query_batch "
                                   f"B={BATCH} ef=200 ({out['query_ms']:.2f} ms)", smi)
    mine = idx.topk_query_batch(new, 1, qp)
    if any(len(r) != 1 or int(r.ids[0]) != int(lab) or not r.scores[0] <= 1e-4
           for r, lab in zip(mine, over)):
        raise AssertionError("an overwritten label's new vector does not find its label first")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"# hnsw writes: each of the {WRITE_BATCH} overwritten labels' new vectors finds its "
          f"label at k=1 within 1e-4; peak device memory {out['peak_gib']:.2f} GiB; card {smi}",
          flush=True)
    return out


# Phase 9: the tiered HNSW index (the deployment RediSearch runs) with the
# job queue of benchmarks/concurrent_bench.py: a backend prebuilt by
# bulk_build_device, a writer thread ingesting while the main thread
# queries, then deletes up to the reference's swap-job threshold.
TIERED_INGEST, TIERED_DELETES, TIERED_THREADS = 8192, 1024, 2


def phase_tiered(dev, smi, n=HNSW_N):
    """Phase 9: ``create_index(VecSimAlgo.TIERED)`` (primary 768-d fp32
    Cosine, M = 16, efC = 200, swapJobThreshold 1024, a
    ``JobQueueThreadPool(2)``), its backend prebuilt by ``bulk_build_device``
    on ``n`` rows. A writer thread ingests 8192 new vectors by
    ``add_vector`` while the main thread loops ``topk_query_batch`` (B =
    1024, k = 10, ef = 200) until the job queue has migrated them all into
    the backend; the group-min kernel K1 (the flat tier's engine) must
    launch in that window. Then ``wait_for_quiescence(300)`` and 1024
    deletes through the tiered index, the last of which reaches the
    threshold and runs the GC. recall@10 by label against the exact flat
    index over the live rows after the ingest and after the GC, and no
    deleted label answers. Prints vectors/s and QPS over the window, the
    migration batches, the GC seconds and the peak device memory."""
    from vectorsimilarity_tpu_torch import create_index
    from vectorsimilarity_tpu_torch import types as T
    from vectorsimilarity_tpu_torch.ops.kernels.bf_topk import group_min_scores
    from vectorsimilarity_tpu_torch.utils.synthetic import embedding_like
    from vectorsimilarity_tpu_torch.utils.thread_pool import JobQueueThreadPool

    k = 10
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = embedding_like(gen, n + BATCH, DIM)
    data, queries = rows[:n], rows[n:]
    new = _new_rows(dev, TIERED_INGEST, SEED + 9)
    new_host = new.cpu().numpy()
    host_q = queries.cpu().numpy()
    out = {"n": n}
    pool = JobQueueThreadPool(TIERED_THREADS)
    try:
        primary = T.VecSimParams(algo=T.VecSimAlgo.HNSWLIB, hnswParams=T.HNSWParams(
            type=T.VecSimType.FLOAT32, dim=DIM, metric=T.VecSimMetric.Cosine, M=HNSW_M,
            efConstruction=HNSW_EFC, efRuntime=200, initialCapacity=n))
        tparams = T.TieredIndexParams(
            primaryIndexParams=primary, jobQueue=pool, submitCb=pool.submit_cb,
            tieredHnswParams=T.TieredHNSWParams(swapJobThreshold=1024))
        idx = create_index(T.VecSimParams(algo=T.VecSimAlgo.TIERED, tieredParams=tparams))
        if idx.device.type != "cuda" or idx.frontend.device != idx.device:
            raise AssertionError(f"create_index put the tiered index on {idx.device}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx.backend.bulk_build_device(data, batch=1024, scan_batches=4)
        torch.cuda.synchronize()
        out["prebuild_s"] = time.perf_counter() - t0
        print(f"# tiered: backend prebuilt by bulk_build_device, {n} x {DIM} fp32 Cosine "
              f"M={HNSW_M} efC={HNSW_EFC}: {out['prebuild_s']:.1f} s; card {smi}", flush=True)
        qp = T.VecSimQueryParams()
        qp.hnswRuntimeParams.efRuntime = 200
        idx.topk_query_batch(host_q, k, qp)  # warm-up

        def writer():
            for j in range(TIERED_INGEST):
                idx.add_vector(new_host[j], n + j)

        # The window runs from the writer's start until the job queue has
        # migrated every ingested vector into the backend: add_vector only
        # writes the flat tier and queues a job, so the migration sets the
        # ingest rate.
        group_min_scores.launches = group_min_scores.tc_launches = 0
        w = threading.Thread(target=writer, name="tiered-writer")
        batches = 0
        t0 = time.perf_counter()
        w.start()
        while w.is_alive() or not pool.wait_for_quiescence(0):
            idx.topk_query_batch(host_q, k, qp)
            batches += 1
            if time.perf_counter() - t0 > 600:
                raise AssertionError("the tiered ingest did not finish within 600 s")
        window = time.perf_counter() - t0
        w.join()
        launches = (group_min_scores.tc_launches, group_min_scores.launches)
        out.update(ingest_vps=TIERED_INGEST / window, qps=batches * BATCH / window,
                   window_s=window, query_batches=batches, k1_launches=launches[0],
                   migrations=idx.migrations)
        print(f"# tiered: a writer thread ingested {TIERED_INGEST} vectors by add_vector (into "
              f"the backend in {idx.migrations} migration batches of at most 256 rows, by "
              f"{TIERED_THREADS} pool threads) while the main thread ran {batches} "
              f"topk_query_batch calls (B={BATCH}, k={k}, ef=200), over the same "
              f"{window:.2f} s: {out['ingest_vps']:.1f} vectors/s, {out['qps']:.1f} QPS; the "
              f"flat tier's K1 launched {launches[0]} times on the tensor cores, {launches[1]} on "
              f"the CUDA cores; card {smi}", flush=True)
        if launches[0] == 0 or launches[1] != 0:
            raise AssertionError("the tiered queries did not run the tensor-core K1 on the "
                                 "flat tier")
        if not pool.wait_for_quiescence(300):
            raise AssertionError("the job queue did not drain within 300 s")
        if idx.frontend.index_size or idx.backend.index_size != n + TIERED_INGEST:
            raise AssertionError(f"after the drain: flat {idx.frontend.index_size}, "
                                 f"backend {idx.backend.index_size}")

        every = torch.cat([data, new])
        labels = np.arange(n + TIERED_INGEST)
        truth = exact_labels(every, labels, queries, k)
        out["recall_ingest"] = _check_replies(idx.topk_query_batch(host_q, k, qp), truth, set(),
                                              "tiered after the ingest", smi)

        gone = np.random.default_rng(SEED + 9).choice(n + TIERED_INGEST, TIERED_DELETES,
                                                      replace=False)
        gc_s = None
        for lab in gone:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if idx.delete_vector(int(lab)) != 1:
                raise AssertionError(f"tiered delete_vector({lab}) removed nothing")
            torch.cuda.synchronize()
            if idx.backend.num_marked_deleted == 0:
                gc_s = time.perf_counter() - t0
        if gc_s is None or idx.backend.index_size != n + TIERED_INGEST - TIERED_DELETES:
            raise AssertionError("the swap-job threshold did not run the GC")
        out["gc_s"], out["gc_repaired"] = gc_s, idx.backend.last_bulk_repairs
        print(f"# tiered: {TIERED_DELETES} delete_vector calls reached swapJobThreshold 1024; "
              f"the GC (delete_tombstoned_bulk) took {gc_s:.3f} s, {out['gc_repaired']} rows "
              f"repaired; card {smi}", flush=True)
        live = np.setdiff1d(labels, gone)
        truth = exact_labels(every[torch.from_numpy(live).to(dev)], live, queries, k)
        out["recall_gc"] = _check_replies(idx.topk_query_batch(host_q, k, qp), truth,
                                          set(gone.tolist()), "tiered after the GC", smi)
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        print(f"# tiered peak device memory {out['peak_gib']:.2f} GiB; card {smi}", flush=True)
    finally:
        pool.shutdown()
    del idx, rows, data, queries, new, every
    torch.cuda.empty_cache()
    return out


# Phase 10: SVS-Vamana at the reference's defaults (SVS_VAMANA_DEFAULT_*,
# benchmarks/svs_build_bench.py): graph_max_degree 32, construction window
# 200, two-level LVQ (quantBits Q4x8), on N embedding-like fp32 Cosine rows,
# N a cut of the bench's 1M for the smoke's time (PERF.md).
SVS_N, SVS_R, SVS_L, SVS_QUANT = 100_000, 32, 200, "Q4x8"
SVS_WS = (10, 50, 100, 200)
SVS_SMALL_N = 10_000
SVS_SMALL_MODES = ("NONE", "Scalar", "Q4", "Q8", "Q4x4", "Q4x8_LeanVec", "Q8x8_LeanVec")
SVS_SMALL_WS = 100
# recall@10 floors: the JAX package's own (tests/test_svs_quant.py:143).
SVS_MIN_RECALL, SVS_Q4_MIN_RECALL = 0.85, 0.75
SVS_RERANK_TOL = 1e-3  # re-ranked distance vs get_distance_from (test_svs_quant.py:170)


def _svs_params(mode, **kw):
    from vectorsimilarity_tpu_torch import types as T

    return T.VecSimParams(algo=T.VecSimAlgo.SVS, svsParams=T.SVSParams(
        type=T.VecSimType.FLOAT32, dim=DIM, metric=T.VecSimMetric.Cosine,
        quantBits=T.VecSimSvsQuantBits[mode], graph_max_degree=SVS_R,
        construction_window_size=SVS_L, **kw))


def _ws_params(ws):
    from vectorsimilarity_tpu_torch import types as T

    qp = T.VecSimQueryParams()
    qp.svsRuntimeParams.windowSize = ws
    return qp


def _timed(fn, reps=3):
    """(median ms, last result) of ``reps`` calls, each synchronized."""
    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), out


def phase_svs(dev, smi, n=SVS_N, small_n=SVS_SMALL_N, keep=None):
    """Phase 10: build the Q4x8 SVS index on the card through the entry
    points a user calls (``create_index`` with no device,
    ``bulk_build_device``), search it per window with ``search_knn`` and
    ``topk_query_batch`` (its re-rank), hold recall@10 against the port's
    exact flat index (K1) and the re-ranked distances against
    ``get_distance_from``; 64 eager deletes; then one build and one search
    per other mode at ``small_n`` rows. Prints build v/s and dropped
    back-edges, ms / QPS / recall per window, the re-rank's share, ms per
    delete and the peak device memory. With a dict ``keep``, the Q4x8 index
    (after its deletes), its queries and its rows stay alive in
    ``keep["svs"]`` for phase 12. Returns {"build_s", ...}."""
    from vectorsimilarity_tpu_torch import create_index
    from vectorsimilarity_tpu_torch.utils.synthetic import embedding_like

    k = 10
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = embedding_like(gen, n + BATCH, DIM)
    data, queries = rows[:n], rows[n:]
    host = queries.cpu().numpy()
    idx = create_index(_svs_params(SVS_QUANT))
    if idx.device.type != "cuda":
        raise AssertionError(f"create_index put the SVS index on {idx.device}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    idx.bulk_build_device(data)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    out = {"n": n, "build_s": build_s, "build_vps": n / build_s, "dropped": idx.build_dropped()}
    print(f"# svs build {n} x {DIM} fp32 Cosine {SVS_QUANT} R={SVS_R} L={SVS_L}: {build_s:.1f} s, "
          f"{n / build_s:.1f} vectors/s, dropped back-edges {out['dropped']}, medoid "
          f"{idx.entry_id}; card {smi}", flush=True)
    truth = exact_labels(data, np.arange(n), queries, k)
    out.update(search_ms={}, search_recall={}, topk_ms={}, topk_recall={})
    for ws in SVS_WS:
        idx.search_knn(host, k, ws)  # warm-up
        ms, (_, ids) = _timed(lambda: idx.search_knn(host, k, ws))
        out["search_ms"][ws], out["search_recall"][ws] = ms, label_recall(ids, truth)
        qp = _ws_params(ws)
        ms_t, replies = _timed(lambda: idx.topk_query_batch(host, k, qp))
        out["topk_ms"][ws] = ms_t
        out["topk_recall"][ws] = label_recall(reply_labels(replies, k), truth)
        print(f"# svs search B={BATCH} k={k} ws={ws}: search_knn {ms:.2f} ms ({BATCH * 1e3 / ms:.1f} "
              f"QPS, recall@10 {out['search_recall'][ws]:.4f} in 4-bit order), "
              f"topk_query_batch with the re-rank {ms_t:.2f} ms ({BATCH * 1e3 / ms_t:.1f} QPS, "
              f"recall@10 {out['topk_recall'][ws]:.4f}); card {smi}", flush=True)
    # The window-200 read taken apart: the beam, the re-rank, the host rest.
    with idx._lock:
        beam_ms, (bd, bi) = _timed(lambda: idx._search_knn_locked(host, k, 200))
        rerank_ms, _ = _timed(lambda: idx._refine(host, bd, bi))
    out["beam_ms"], out["rerank_ms"] = beam_ms, rerank_ms
    out["host_ms"] = out["topk_ms"][200] - beam_ms - rerank_ms
    print(f"# svs topk_query_batch ws=200 taken apart: beam {beam_ms:.2f} ms, re-rank "
          f"(gathered_recon_dists + sort) {rerank_ms:.2f} ms, host rest {out['host_ms']:.2f} ms; "
          f"card {smi}", flush=True)
    replies = idx.topk_query_batch(host[:16], k, _ws_params(200))
    worst = max(abs(float(d) - idx.get_distance_from(int(lab), host[j]))
                for j, r in enumerate(replies) for lab, d in zip(r.ids, r.scores))
    out["rerank_err"] = worst
    print(f"# svs re-ranked distances vs get_distance_from: max |diff| {worst:.3e} over 16 "
          f"replies; card {smi}", flush=True)
    if worst > SVS_RERANK_TOL:
        raise AssertionError(f"re-ranked distance off get_distance_from by {worst}")
    if out["topk_recall"][200] < SVS_MIN_RECALL:
        raise AssertionError(f"SVS {SVS_QUANT} recall@10 at ws=200 "
                             f"{out['topk_recall'][200]:.4f} below {SVS_MIN_RECALL}")
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    print(f"# svs peak device memory {out['peak_gib']:.2f} GiB; card {smi}", flush=True)

    # 64 eager deletes, then the window-200 read over the live rows.
    gone = np.random.default_rng(SEED + 10).permutation(n)[:WRITE_EAGER]
    times = []
    for lab in gone:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if idx.delete_vector(int(lab)) != 1:
            raise AssertionError(f"svs delete_vector({lab}) removed nothing")
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    out["delete_ms"], out["delete_ms_first"] = statistics.median(times), times[0]
    print(f"# svs writes: {WRITE_EAGER} eager delete_vector calls, {out['delete_ms']:.2f} ms per "
          f"delete (median; mean {statistics.fmean(times):.2f}, first {times[0]:.2f}, which "
          f"pulls the device-built links to the host once); card {smi}", flush=True)
    live = np.setdiff1d(np.arange(n), gone)
    truth = exact_labels(data[torch.from_numpy(live).to(dev)], live, queries, k)
    out["recall_deletes"] = _check_replies(
        idx.topk_query_batch(host, k, _ws_params(200)), truth, set(gone.tolist()),
        f"svs after the deletes: topk_query_batch B={BATCH} ws=200", smi, SVS_MIN_RECALL)
    if keep is not None:
        keep["svs"] = (idx, queries, data)
    del idx
    torch.cuda.empty_cache()

    # Every other mode at small_n rows: one build, one search.
    sub, truth = data[:small_n], None
    truth = exact_labels(sub, np.arange(small_n), queries, k)
    out["modes"] = {}
    for mode in SVS_SMALL_MODES:
        midx = create_index(_svs_params(mode))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        midx.bulk_build_device(sub)
        torch.cuda.synchronize()
        b_s = time.perf_counter() - t0
        ms, replies = _timed(lambda: midx.topk_query_batch(host, k, _ws_params(SVS_SMALL_WS)), 1)
        rec = label_recall(reply_labels(replies, k), truth)
        floor = SVS_Q4_MIN_RECALL if mode == "Q4" else SVS_MIN_RECALL
        out["modes"][mode] = {"build_s": b_s, "ms": ms, "recall": rec}
        print(f"# svs {mode} {small_n} x {DIM}: build {b_s:.1f} s ({small_n / b_s:.1f} v/s), "
              f"topk_query_batch B={BATCH} ws={SVS_SMALL_WS} {ms:.2f} ms, recall@10 {rec:.4f} "
              f"(floor {floor}); card {smi}", flush=True)
        if rec < floor:
            raise AssertionError(f"SVS {mode} recall@10 {rec:.4f} below {floor}")
        del midx
    del rows, data, queries, sub
    torch.cuda.empty_cache()
    return out


# Phase 11: tiered SVS over phase 10's configuration with the reference's
# thresholds (vec_sim_common.h:53: training 10 x 1024, update 1024) and the
# job queue of benchmarks/concurrent_bench.py.
TSVS_INGEST, TSVS_TRAIN, TSVS_UPDATE, TSVS_DELETES = 20_480, 10_240, 1_024, 1_024


def phase_tiered_svs(dev, smi, n=TSVS_INGEST):
    """Phase 11: ``create_index(VecSimAlgo.TIERED)`` over phase 10's SVS
    configuration (trainingTriggerThreshold 10,240, updateTriggerThreshold
    1,024, a ``JobQueueThreadPool(2)``). A writer thread adds ``n`` fresh
    rows by ``add_vector`` while the main thread loops
    ``topk_query_batch`` (B = 1024, k = 10, window 200) until the queue is
    idle; the group-min kernel K1 must answer the flat tier in that window.
    Then 1,024 ``delete_vector`` calls and ``run_gc``. recall@10 by label
    against the exact flat index over the live rows after the ingest and
    after the GC, and no deleted label answers. Prints vectors/s and QPS
    over the window, the migrations, K1's launches, the GC seconds and the
    peak device memory."""
    from vectorsimilarity_tpu_torch import create_index
    from vectorsimilarity_tpu_torch import types as T
    from vectorsimilarity_tpu_torch.ops.kernels.bf_topk import group_min_scores
    from vectorsimilarity_tpu_torch.utils.synthetic import embedding_like
    from vectorsimilarity_tpu_torch.utils.thread_pool import JobQueueThreadPool

    k = 10
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(SEED)
    queries = embedding_like(gen, BATCH, DIM)
    new = _new_rows(dev, n, SEED + 11)
    new_host, host_q = new.cpu().numpy(), queries.cpu().numpy()
    qp = _ws_params(200)
    out = {"n": n}
    pool = JobQueueThreadPool(TIERED_THREADS)
    try:
        tparams = T.TieredIndexParams(
            primaryIndexParams=_svs_params(SVS_QUANT), jobQueue=pool, submitCb=pool.submit_cb,
            tieredHnswParams=T.TieredHNSWParams(swapJobThreshold=100_000),  # the GC runs below
            tieredSVSParams=T.TieredSVSParams(trainingTriggerThreshold=TSVS_TRAIN,
                                              updateTriggerThreshold=TSVS_UPDATE))
        idx = create_index(T.VecSimParams(algo=T.VecSimAlgo.TIERED, tieredParams=tparams))
        if idx.device.type != "cuda" or idx.frontend.device != idx.device:
            raise AssertionError(f"create_index put the tiered SVS index on {idx.device}")

        def writer():
            for j in range(n):
                idx.add_vector(new_host[j], j)

        group_min_scores.launches = group_min_scores.tc_launches = 0
        w = threading.Thread(target=writer, name="tiered-svs-writer")
        batches = 0
        t0 = time.perf_counter()
        w.start()
        while w.is_alive() or not pool.wait_for_quiescence(0):
            idx.topk_query_batch(host_q, k, qp)
            batches += 1
            if time.perf_counter() - t0 > 600:
                raise AssertionError("the tiered SVS ingest did not finish within 600 s")
        window = time.perf_counter() - t0
        w.join()
        launches = (group_min_scores.tc_launches, group_min_scores.launches)
        out.update(ingest_vps=n / window, qps=batches * BATCH / window, window_s=window,
                   query_batches=batches, k1_launches=launches[0], migrations=idx.migrations,
                   flat_left=idx.frontend.index_size)
        print(f"# tiered svs: a writer thread added {n} vectors by add_vector (into the "
              f"backend in {idx.migrations} migrations: training at {TSVS_TRAIN}, then every "
              f"{TSVS_UPDATE}; {idx.frontend.index_size} left in the flat tier) while the main "
              f"thread ran {batches} topk_query_batch calls (B={BATCH}, k={k}, ws=200), over the "
              f"same {window:.2f} s: {out['ingest_vps']:.1f} vectors/s, {out['qps']:.1f} QPS; "
              f"the flat tier's K1 launched {launches[0]} times on the tensor cores, "
              f"{launches[1]} on the CUDA cores; card {smi}", flush=True)
        if launches[0] == 0 or launches[1] != 0:
            raise AssertionError("the tiered SVS queries did not run the tensor-core K1 on the "
                                 "flat tier")
        if idx.migrations < 1 or idx.index_size != n:
            raise AssertionError(f"{idx.migrations} migrations, {idx.index_size} rows")
        labels = np.arange(n)
        truth = exact_labels(new, labels, queries, k)
        out["recall_ingest"] = _check_replies(idx.topk_query_batch(host_q, k, qp), truth, set(),
                                              "tiered svs after the ingest", smi, SVS_MIN_RECALL)

        gone = np.random.default_rng(SEED + 11).choice(n, TSVS_DELETES, replace=False)
        for lab in gone:
            if idx.delete_vector(int(lab)) != 1:
                raise AssertionError(f"tiered svs delete_vector({lab}) removed nothing")
        marked = idx.backend.num_marked_deleted
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx.run_gc()
        torch.cuda.synchronize()
        out["gc_s"], out["gc_removed"] = time.perf_counter() - t0, marked
        if idx.backend.num_marked_deleted or idx.index_size != n - TSVS_DELETES:
            raise AssertionError("the GC left tombstones")
        print(f"# tiered svs: {TSVS_DELETES} delete_vector calls ({marked} tombstones in the "
              f"backend, the rest removed from the flat tier), then run_gc: {out['gc_s']:.3f} s; "
              f"card {smi}", flush=True)
        live = np.setdiff1d(labels, gone)
        truth = exact_labels(new[torch.from_numpy(live).to(dev)], live, queries, k)
        out["recall_gc"] = _check_replies(idx.topk_query_batch(host_q, k, qp), truth,
                                          set(gone.tolist()), "tiered svs after the GC", smi,
                                          SVS_MIN_RECALL)
        out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        print(f"# tiered svs peak device memory {out['peak_gib']:.2f} GiB; card {smi}",
              flush=True)
    finally:
        pool.shutdown()
    del idx, queries, new
    torch.cuda.empty_cache()
    return out


# Phase 12: persistence on the card. The flat index is cut from the headline
# 1M rows to 2^18 because "vstpu-v1" compresses on one host core.
PERSIST_N = 262_144


def _file_bytes(path):
    if os.path.isdir(path):
        return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))
    return os.path.getsize(path)


def _timed_s(fn):
    """(seconds, result) of one call, synchronized."""
    ms, out = _timed(fn, 1)
    return ms / 1e3, out


def _same_replies(a, b, what):
    """Two lists of replies hold the same labels and bit-equal distances."""
    if len(a) != len(b) or any(not np.array_equal(x.ids, y.ids)
                               or not np.array_equal(x.scores, y.scores) for x, y in zip(a, b)):
        raise AssertionError(f"{what}: the reloaded index answers otherwise than the saved one")


def phase_persist(dev, smi, flat_rows, queries, kept):
    """Phase 12: save and load on the card. The flat index (``flat_rows``,
    2^18 x 768 fp32 Cosine from the headline rows): ``save_index``, then
    ``load_index`` with no device; at k = 10, 100 and 500 (B = 1024) the
    reloaded index's ``search_knn_device`` gives exactly the saved index's
    ids and distances, with every launch count set to 0 just before and read
    just after: K1, K3 and K4 each on the tensor cores, no fallback. Phase
    7's HNSW index (``kept["hnsw"]``): ``save_index`` / ``load_index``, and
    a V4 file loaded with the store tensor already on the card as
    ``device_data`` and without; each reload answers ``topk_query_batch``
    at ef 200 with the saved index's labels and distances and the same
    recall@10, and passes ``check_integrity``. Phase 10's Q4x8 index
    (``kept["svs"]``): ``save_svs_folder``, then ``load_svs_folder`` into a
    fresh index of the same params, held the same way at window 200 (and
    through ``save_index`` / ``load_index``). Files go to a temporary
    directory removed at the end; prints each file's bytes and each save's
    and load's seconds."""
    import shutil
    import tempfile

    from vectorsimilarity_tpu_torch import create_index
    from vectorsimilarity_tpu_torch import types as T
    from vectorsimilarity_tpu_torch.ops.kernels import bf_topk as bfk
    from vectorsimilarity_tpu_torch.utils import hnsw_file_format as hff
    from vectorsimilarity_tpu_torch.utils import svs_file_format as sff
    from vectorsimilarity_tpu_torch.utils.serializer import check_integrity, load_index, save_index

    k = 10
    tmp = tempfile.mkdtemp(prefix="chip_smoke_persist_")
    out = {"flat": {}, "hnsw": {}, "svs": {}}

    def record(what, kind, path, save_s, load_s):
        out[what][kind] = {"bytes": _file_bytes(path), "save_s": save_s, "load_s": load_s}
        print(f"# persist {what} {kind}: {_file_bytes(path)} bytes, save {save_s:.3f} s, load "
              f"{load_s:.3f} s; card {smi}", flush=True)

    def on_card(idx, what):
        if idx.store.device.type != "cuda" or idx.store.device_arrays()["data"].device.type != "cuda":
            raise AssertionError(f"{what}: the reloaded store is on {idx.store.device}")
        if not check_integrity(idx):
            raise AssertionError(f"{what}: check_integrity is false on the reload")

    try:
        # --- the flat index: kernels K1, K3, K4 on the reload ---
        n = flat_rows.shape[0]
        flat = create_index(T.VecSimParams(algo=T.VecSimAlgo.BF, bfParams=T.BFParams(
            type=T.VecSimType.FLOAT32, dim=DIM, metric=T.VecSimMetric.Cosine)))
        flat.add_vector_batch(flat_rows.cpu().numpy(), np.arange(n))
        before = {kk: flat.search_knn_device(queries, kk) for kk in KS}
        path = os.path.join(tmp, "flat.npz")
        save_s, _ = _timed_s(lambda: save_index(flat, path))
        load_s, back = _timed_s(lambda: load_index(path))
        record("flat", "vstpu-v1", path, save_s, load_s)
        on_card(back, "flat")
        counters = ((bfk.group_min_scores, "tc_launches"), (bfk.group_min_scores, "launches"),
                    (bfk.fused_topk, "tc_launches"), (bfk.fused_topk, "launches"),
                    (bfk.tile_topc, "tc_launches"), (bfk.tile_topc, "launches"))
        for w, attr in counters:
            setattr(w, attr, 0)
        bfk.topk_gm_exact.fallbacks = bfk.topk_bigk_exact.fallbacks = 0
        after = {kk: back.search_knn_device(queries, kk) for kk in KS}
        torch.cuda.synchronize()
        names = ("gm_tc", "gm", "fused_tc", "fused", "topc_tc", "topc")
        launches = {nm: getattr(w, attr) for nm, (w, attr) in zip(names, counters)}
        fallbacks = bfk.topk_gm_exact.fallbacks + bfk.topk_bigk_exact.fallbacks
        out["flat"].update(n=n, launches=launches, fallbacks=fallbacks)
        print(f"# persist flat {n} x {DIM}: the reload's search_knn_device at k = {KS}, "
              f"B={BATCH}: launches {launches}, fallbacks {fallbacks}; card {smi}", flush=True)
        if not all(launches[e] for e in ("gm_tc", "fused_tc", "topc_tc")) or \
                launches["gm"] or launches["fused"] or launches["topc"] or fallbacks:
            raise AssertionError("the reloaded flat index did not answer through the "
                                 "tensor-core K1, K3 and K4 alone")
        for kk in KS:
            (d0, i0), (d1, i1) = before[kk], after[kk]
            if not (torch.equal(i0, i1) and torch.equal(d0, d1)):
                raise AssertionError(f"flat reload at k={kk}: ids or distances differ")
        print(f"# persist flat: ids and distances of the reload equal the saved index's, bit "
              f"for bit, at k = {KS}; card {smi}", flush=True)
        del flat, back, before, after

        # --- HNSW: vstpu-v1 and the reference's V4 file ---
        hidx, hq = kept["hnsw"]  # kept on for phase 14
        host_q = hq.cpu().numpy()
        qp = T.VecSimQueryParams()
        qp.hnswRuntimeParams.efRuntime = 200
        count = hidx.store.count
        live = (hidx.store.host["flags"][:count] & 1) == 0
        dev_data = hidx.store.device_arrays()["data"]
        truth = exact_labels(dev_data[:count][torch.from_numpy(live).to(dev)],
                             hidx.store.host["label"][:count][live], hq, k)
        ref = hidx.topk_query_batch(host_q, k, qp)
        rec = label_recall(reply_labels(ref, k), truth)
        out["hnsw"].update(count=count, recall=rec)
        path = os.path.join(tmp, "hnsw.npz")
        save_s, _ = _timed_s(lambda: save_index(hidx, path))
        load_s, back = _timed_s(lambda: load_index(path))
        record("hnsw", "vstpu-v1", path, save_s, load_s)
        reloads = [("vstpu-v1", back)]
        path = os.path.join(tmp, "hnsw.v4")
        save_s, _ = _timed_s(lambda: hff.save_hnsw_file(hidx, path))
        load_s, back = _timed_s(lambda: hff.load_hnsw_file(path))
        record("hnsw", "V4", path, save_s, load_s)
        reloads.append(("V4", back))

        def device_data(cap, n_rows, dim):
            if dev_data.shape[0] >= cap:
                return dev_data[:cap]
            pad = torch.zeros((cap, dim), dtype=dev_data.dtype, device=dev)
            pad[:n_rows] = dev_data[:n_rows]
            return pad

        load_s, back = _timed_s(lambda: hff.load_hnsw_file(path, device_data))
        out["hnsw"]["V4 device_data"] = {"load_s": load_s}
        print(f"# persist hnsw V4 with device_data (the store tensor on the card): load "
              f"{load_s:.3f} s; card {smi}", flush=True)
        reloads.append(("V4 device_data", back))
        for kind, back in reloads:
            on_card(back, f"hnsw {kind}")
            got = back.topk_query_batch(host_q, k, qp)
            _same_replies(got, ref, f"hnsw {kind}")
            r = label_recall(reply_labels(got, k), truth)
            if r != rec:
                raise AssertionError(f"hnsw {kind}: recall {r} against {rec}")
        print(f"# persist hnsw {count} x {DIM}: every reload answers topk_query_batch B={BATCH} "
              f"ef=200 with the saved index's labels and distances, recall@10 {rec:.4f}; card "
              f"{smi}", flush=True)
        del hidx, reloads, back, dev_data

        # --- SVS: the reference's folder, and vstpu-v1 ---
        sidx, sq, rows = kept.pop("svs")
        host_q = sq.cpu().numpy()
        qp = _ws_params(200)
        count = sidx.store.count
        labels = np.sort(sidx.store.host["label"][:count])  # label i is row i of ``rows``
        truth = exact_labels(rows[torch.from_numpy(labels).to(dev)], labels, sq, k)
        ref = sidx.topk_query_batch(host_q, k, qp)
        rec = label_recall(reply_labels(ref, k), truth)
        out["svs"].update(count=count, recall=rec)
        path = os.path.join(tmp, "svs")
        save_s, _ = _timed_s(lambda: sff.save_svs_folder(sidx, path))
        fresh = create_index(_svs_params(SVS_QUANT))
        load_s, _ = _timed_s(lambda: sff.load_svs_folder(fresh, path))
        record("svs", "folder", path, save_s, load_s)
        reloads = [("folder", fresh)]
        path = os.path.join(tmp, "svs.npz")
        save_s, _ = _timed_s(lambda: save_index(sidx, path))
        load_s, back = _timed_s(lambda: load_index(path))
        record("svs", "vstpu-v1", path, save_s, load_s)
        reloads.append(("vstpu-v1", back))
        for kind, back in reloads:
            on_card(back, f"svs {kind}")
            got = back.topk_query_batch(host_q, k, qp)
            _same_replies(got, ref, f"svs {kind}")
            r = label_recall(reply_labels(got, k), truth)
            if r != rec:
                raise AssertionError(f"svs {kind}: recall {r} against {rec}")
        print(f"# persist svs {SVS_QUANT} {count} x {DIM}: every reload answers topk_query_batch "
              f"B={BATCH} ws=200 with the saved index's labels and distances, recall@10 "
              f"{rec:.4f}; card {smi}", flush=True)
        del sidx, reloads, back, fresh, rows
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    return out


# Phase 13: the host-orchestrated builds (config.graph_build_device = False)
# beside the device builds of the same rows.
HOST_N, HOST_BATCH = 20_000, 1_024


def phase_host_builds(dev, smi, n=HOST_N):
    """Phase 13: HNSW (M = 16, efC = 200) and SVS (Q4x8, R = 32, L = 200),
    each built from the same ``n`` x 768 fp32 Cosine rows by
    ``add_vector_batch`` in batches of 1,024 with
    ``config.graph_build_device`` off, then on (restored in a ``finally``).
    Prints the vectors per second of every build and recall@10 against the
    exact flat index (K1) at ef / window 200; the host builds must reach the
    phase 7 / 10 floors and come within 0.08 of their device builds."""
    from vectorsimilarity_tpu_torch import config, create_index
    from vectorsimilarity_tpu_torch import types as T
    from vectorsimilarity_tpu_torch.utils.synthetic import embedding_like

    k = 10
    torch.cuda.empty_cache()
    gen = torch.Generator(device=dev).manual_seed(SEED + 13)
    rows = embedding_like(gen, n + BATCH, DIM)
    data, queries = rows[:n], rows[n:]
    host, host_q = data.cpu().numpy(), queries.cpu().numpy()
    truth = exact_labels(data, np.arange(n), queries, k)
    hnsw = T.VecSimParams(algo=T.VecSimAlgo.HNSWLIB, hnswParams=T.HNSWParams(
        type=T.VecSimType.FLOAT32, dim=DIM, metric=T.VecSimMetric.Cosine, M=HNSW_M,
        efConstruction=HNSW_EFC))
    hq = T.VecSimQueryParams()
    hq.hnswRuntimeParams.efRuntime = 200
    cases = {"hnsw": (hnsw, hq, HNSW_MIN_RECALL), "svs": (_svs_params(SVS_QUANT),
                                                           _ws_params(200), SVS_MIN_RECALL)}
    out = {}
    saved = config.graph_build_device
    try:
        for name, (params, qp, floor) in cases.items():
            for on_device in (False, True):
                config.graph_build_device = on_device
                idx = create_index(params)
                if idx.device.type != "cuda":
                    raise AssertionError(f"create_index put the {name} index on {idx.device}")

                def build():
                    for off in range(0, n, HOST_BATCH):
                        idx.add_vector_batch(host[off:off + HOST_BATCH],
                                             list(range(off, min(off + HOST_BATCH, n))))

                build_s, _ = _timed_s(build)
                if idx._host_links_stale == (not on_device):
                    raise AssertionError(f"{name}: the links are not where the build keeps them")
                rec = label_recall(reply_labels(idx.topk_query_batch(host_q, k, qp), k), truth)
                how = "device" if on_device else "host"
                out[f"{name}_{how}"] = {"build_s": build_s, "vps": n / build_s, "recall": rec}
                print(f"# {how} build {name} {n} x {DIM} fp32 Cosine, batches of {HOST_BATCH} "
                      f"(config.graph_build_device={on_device}): {build_s:.1f} s, "
                      f"{n / build_s:.1f} vectors/s, recall@10 {rec:.4f} at ef/ws 200; card "
                      f"{smi}", flush=True)
                del idx
                torch.cuda.empty_cache()
            host_rec, dev_rec = out[f"{name}_host"]["recall"], out[f"{name}_device"]["recall"]
            if host_rec < floor or host_rec < dev_rec - 0.08:
                raise AssertionError(f"{name} host build recall@10 {host_rec:.4f} (floor {floor}, "
                                     f"device build {dev_rec:.4f})")
    finally:
        config.graph_build_device = saved
    del rows, data, queries
    torch.cuda.empty_cache()
    return out


# Phase 14: multi-device sharding on the one card, the mesh [cuda:0] * 4
# (one process, four shards that share the card's one copy of the rows).
SHARDS = 4
SHARD_WRITES = 1_024
SHARDED_N = 100_000  # phase 7's rows, partitioned into one subgraph per shard
SHARDED_WS = 200


def _same_topk(d, i, rd, ri, what):
    """(d, i) [Q, k] against (rd, ri), host numpy: distances within TOL, ids
    equal except at slots whose reference distance lies within TOL of a
    neighbouring slot's. Returns the max |distance difference|."""
    d, i, rd, ri = (np.asarray(x) for x in (d, i, rd, ri))
    if d.shape != rd.shape:
        raise AssertionError(f"{what}: shapes {d.shape} and {rd.shape}")
    err = float(np.abs(d.astype(np.float64) - rd).max()) if d.size else 0.0
    if not err <= TOL:
        raise AssertionError(f"{what}: distances off by {err:.3e}")
    gap = np.abs(np.diff(rd.astype(np.float64), axis=1)) <= TOL
    tied = np.zeros(d.shape, dtype=bool)
    tied[:, 1:] |= gap
    tied[:, :-1] |= gap
    bad = (i != ri) & ~tied
    if bad.any():
        raise AssertionError(f"{what}: {int(bad.sum())} ids differ")
    return err


def _same_reply_lists(got, ref, what):
    """Two lists of replies, reply by reply: the same length, labels and
    distances as ``_same_topk``. Returns the max |distance difference|."""
    if [len(r) for r in got] != [len(r) for r in ref]:
        raise AssertionError(f"{what}: reply lengths differ")
    return max(_same_topk(a.scores[None], a.ids[None], b.scores[None], b.ids[None], what)
               for a, b in zip(got, ref))


def _qps(fn, smi):
    """(median QPS over 3 rounds of 2 batches, peak GiB allocated) of
    ``fn(round_batch)``, synchronized."""
    torch.cuda.reset_peak_memory_stats()
    rounds = []
    fn(0)
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(0)
        fn(1)
        torch.cuda.synchronize()
        rounds.append(2 * BATCH / (time.perf_counter() - t0))
    return statistics.median(rounds), torch.cuda.max_memory_allocated() / 2**30


def phase_sharded(dev, smi, kept, kernel_rows):
    """Phase 14: sharding on the card over ``make_mesh([dev] * 4)``.

    - The sharded flat scan: the headline store (made again from the seed)
      in fp32 and in its int8 form (integer Cosine with query norms), each
      adopted by a ``BruteForceIndex`` turned ``to_sharded`` (262,144 rows a
      shard) and by an unsharded one. Per k in 10, 100, 500 with every count
      at 0 just before: ``topk_query_batch`` and ``search_knn_device`` at B
      = 1024, after which the k's tensor-core kernel (K1, K3, K4) must have
      launched 4 times a batch (once a shard), no other kernel and no
      fallback; the answers equal the unsharded index's and 32 queries the
      float64 truth. fp32 then takes 1,024 adds and 1,024 deletes whose
      swaps cross the shards, on both indexes: no deleted label answers,
      and the answers equal again. QPS and peak memory of both beside each
      other. One ``sharded_topk(kind="sq8")`` of the headline's SQ8 codes
      against the plain unsharded ``streaming_topk`` over ``scores_sq8``.
    - Query-sharded HNSW: phase 7's index (after phases 8 and 12)
      ``to_query_sharded``, B = 1025 (padded to the mesh) at ef 200, equal to
      the unsharded answers.
    - ``ShardedHNSW`` (M = 16, efC = 200) and ``ShardedVamana`` (Scalar, R =
      32, L = 200) over phase 7's 100,000 rows, each built by the deferred
      round-robin ``bulk_build_device``: recall@10 at ef / window 200 (floors
      0.90 and 0.85) against the exact flat index; ``ShardedHNSW`` takes 64
      deletes (no deleted label answers) and a ``save`` / ``load`` with
      equal replies.

    Adds each kernel's sharded launches per batch to its row. Returns a
    dict of the readings."""
    import shutil
    import tempfile

    from vectorsimilarity_tpu_torch import ShardedHNSW, ShardedVamana, make_mesh
    from vectorsimilarity_tpu_torch import types as T
    from vectorsimilarity_tpu_torch.indexes.brute_force import BruteForceIndex
    from vectorsimilarity_tpu_torch.ops.distances import streaming_topk
    from vectorsimilarity_tpu_torch.ops.kernels import bf_topk as bfk
    from vectorsimilarity_tpu_torch.ops.quantize import sq8_quantize
    from vectorsimilarity_tpu_torch.parallel.sharding import sharded_topk
    from vectorsimilarity_tpu_torch.utils.synthetic import embedding_like

    t_phase = time.perf_counter()
    default = make_mesh()
    print(f"# sharding: make_mesh() takes {[str(d) for d in default.devices]}", flush=True)
    mesh = make_mesh([dev] * SHARDS)
    out = {"default_mesh": [str(d) for d in default.devices], "flat": {}}
    torch.cuda.empty_cache()
    store, queries = headline_store(dev)
    counters = {"gm_tc": (bfk.group_min_scores, "tc_launches"),
                "gm": (bfk.group_min_scores, "launches"),
                "fused_tc": (bfk.fused_topk, "tc_launches"),
                "fused": (bfk.fused_topk, "launches"),
                "topc_tc": (bfk.tile_topc, "tc_launches"), "topc": (bfk.tile_topc, "launches")}
    engine_of = dict(zip(KS, ("gm_tc", "fused_tc", "topc_tc")))

    def flat(lane, data, norms):
        idx = BruteForceIndex(T.BFParams(type=T.VecSimType[VTYPES[lane]], dim=DIM,
                                         metric=T.VecSimMetric.Cosine))
        idx.store.adopt_device({"data": data} if norms is None else {"data": data, "norm": norms},
                               count=N)
        idx.labels.label_to_id = dict(zip(range(N), range(N)))
        idx.store.host["label"][:N] = np.arange(N, dtype=np.int64)
        return idx

    def compare(sh, ref, raw, q, qn, what):
        err = 0.0
        for k in KS:
            (d, i), (rd, ri) = sh.search_knn_device(q, k, qn=qn), ref.search_knn_device(q, k, qn=qn)
            err = max(err, _same_topk(d.cpu().numpy(), i.cpu().numpy(), rd.cpu().numpy(),
                                      ri.cpu().numpy(), f"{what} search_knn_device k={k}"))
            err = max(err, _same_reply_lists(sh.topk_query_batch(raw, k),
                                             ref.topk_query_batch(raw, k),
                                             f"{what} topk_query_batch k={k}"))
        return err

    scale = 127.0 / float(store.abs().max())
    for lane in ("f32", "s8"):
        t_lane = time.perf_counter()
        if lane == "s8":
            data = torch.cat([(c * scale).round().clamp(-127, 127).to(torch.int8)
                              for c in store.split(1 << 17)])
            raw_q = (queries * scale).round().clamp(-127, 127)
            norms = int_norms(data)
            ref = flat(lane, data, norms)  # read only: it shares the sharded index's rows
        else:
            data, raw_q, norms = store, queries, None
            ref = flat(lane, store.clone(), None)  # the writes below go to both
        sh = flat(lane, data, norms).to_sharded(mesh)
        raw = raw_q.float().cpu().numpy().astype(sh.np_dtype)
        q, qn = (sh.to_device(a) for a in sh.preprocess_queries(raw))
        res = out["flat"][lane] = {"launches": {}}
        for k in KS:
            for w, attr in counters.values():
                setattr(w, attr, 0)
            bfk.topk_gm_exact.fallbacks = bfk.topk_bigk_exact.fallbacks = 0
            sh.topk_query_batch(raw, k)
            d, i = sh.search_knn_device(q, k, qn=qn)
            torch.cuda.synchronize()
            launches = {nm: getattr(w, attr) for nm, (w, attr) in counters.items()}
            falls = bfk.topk_gm_exact.fallbacks + bfk.topk_bigk_exact.fallbacks
            res["launches"][k] = launches
            print(f"# sharded flat {lane} k={k}, 2 batches of {BATCH} over {SHARDS} shards: "
                  f"launches {launches}, fallbacks {falls}", flush=True)
            want = {nm: (2 * SHARDS if nm == engine_of[k] else 0) for nm in counters}
            if launches != want or falls:
                raise AssertionError(f"sharded flat {lane} k={k}: launches {launches}, fallbacks "
                                     f"{falls}; want {want} and none")
            for row in kernel_rows:
                if row["name"] == f"{KERNELS[engine_of[k]][0]}_{lane}":
                    row["sharded_launches_per_batch"] = launches[engine_of[k]] // 2
            if k == KS[-1]:
                rd, ri, s64 = exact_truth(q[:32], data, N, k + 1, norms,
                                          None if qn is None else qn[:32])
                for kk in KS:
                    dd, ii = sh.search_knn_device(q[:32], kk, qn=None if qn is None else qn[:32])
                    assert_knn(dd.cpu().numpy(), ii.cpu().numpy(), rd[:, :kk + 1], ri, s64)
                del s64
        res["max_abs_err_vs_unsharded"] = compare(sh, ref, raw, q, qn, f"sharded flat {lane}")
        print(f"# sharded flat {lane}: answers equal the unsharded index's at k = {KS} "
              f"(host API and device path; max |diff| {res['max_abs_err_vs_unsharded']:.3e}), "
              f"32 queries the float64 exact top-k", flush=True)
        qs, qns = [q, q.flip(0).contiguous()], [qn, None if qn is None else qn.flip(0).contiguous()]
        res["qps"], res["unsharded_qps"] = {}, {}
        for k in KS:
            res["qps"][k], res["peak_gib"] = _qps(
                lambda j: sh.search_knn_device(qs[j], k, qn=qns[j]), smi)
            res["unsharded_qps"][k], res["unsharded_peak_gib"] = _qps(
                lambda j: ref.search_knn_device(qs[j], k, qn=qns[j]), smi)
            print(f"# sharded flat {lane} search_knn_device {N} x {DIM}, B={BATCH}, k={k}: "
                  f"{res['qps'][k]:.1f} QPS over {SHARDS} shards, {res['unsharded_qps'][k]:.1f} "
                  f"QPS unsharded; peak device memory {res['peak_gib']:.2f} / "
                  f"{res['unsharded_peak_gib']:.2f} GiB; card {smi}", flush=True)
        if lane == "f32":
            gen = torch.Generator(device=dev).manual_seed(SEED + 14)
            new = embedding_like(gen, SHARD_WRITES, DIM).cpu().numpy()
            gone = np.random.default_rng(SEED + 14).choice(N, SHARD_WRITES, replace=False)
            t0 = time.perf_counter()
            for idx in (sh, ref):
                idx.add_vector_batch(new, list(range(N, N + SHARD_WRITES)))
                for lab in gone:
                    if idx.delete_vector(int(lab)) != 1:
                        raise AssertionError(f"delete_vector({lab}) removed nothing")
            res["writes_s"] = time.perf_counter() - t0
            for r in sh.topk_query_batch(raw, KS[-1]):
                if np.isin(r.ids, gone).any():
                    raise AssertionError("a deleted label answered the sharded index")
            compare(sh, ref, raw, q, qn, "sharded flat f32 after the writes")
            print(f"# sharded flat f32: {SHARD_WRITES} adds and {SHARD_WRITES} deletes (swaps "
                  f"across the shards) on both indexes in {res['writes_s']:.1f} s; no deleted "
                  f"label answers, the answers equal the unsharded index's at k = {KS}; card "
                  f"{smi}", flush=True)
        del sh, ref, data, norms, q, qn, qs, qns
        torch.cuda.empty_cache()
        print(f"# sharded flat {lane} done in {time.perf_counter() - t_lane:.1f} s; card {smi}",
              flush=True)

    # sq8: the headline's codes, the sharded scan against the plain one.
    metric = T.VecSimMetric.IP
    codes = torch.zeros((CAP, DIM), dtype=torch.uint8, device=dev)
    vmin = torch.zeros(CAP, device=dev)
    delta = torch.ones(CAP, device=dev)
    for lo in range(0, N, 1 << 17):
        hi = min(lo + (1 << 17), N)
        codes[lo:hi], vmin[lo:hi], delta[lo:hi] = sq8_quantize(store[lo:hi], with_sumsq=False)[:3]
    del store
    cols = (codes, vmin, delta, None)
    k = KS[0]
    sq_ms, (d, i) = _timed(lambda: sharded_topk(queries, cols, N, k, metric=metric, kind="sq8",
                                                 mesh=mesh))
    plain_ms, (rd, ri) = _timed(lambda: streaming_topk(queries, cols, N, k, metric=metric,
                                                        kind="sq8", chunk=1 << 18))
    err = _same_topk(d.cpu().numpy(), i.cpu().numpy(), rd.cpu().numpy(), ri.cpu().numpy(),
                     "sharded sq8")
    out["sq8"] = {"ms": sq_ms, "plain_ms": plain_ms, "max_abs_err": err}
    print(f"# sharded_topk sq8 {N} x {DIM} IP, B={BATCH}, k={k}: {sq_ms:.2f} ms over {SHARDS} "
          f"shards, the plain unsharded scan {plain_ms:.2f} ms, max |diff| {err:.3e}; card {smi}",
          flush=True)
    del codes, vmin, delta, cols, queries
    torch.cuda.empty_cache()

    # Query-sharded HNSW: phase 7's index, an odd batch cut over the mesh.
    hidx, hq = kept.pop("hnsw")
    host_q = np.concatenate([hq.cpu().numpy(), hq[:1].cpu().numpy()])  # 1025 queries
    qp = T.VecSimQueryParams()
    qp.hnswRuntimeParams.efRuntime = 200
    one_ms, ref = _timed(lambda: hidx.topk_query_batch(host_q, 10, qp), 1)
    hidx.to_query_sharded(mesh)
    q_ms, got = _timed(lambda: hidx.topk_query_batch(host_q, 10, qp), 1)
    hidx.to_query_sharded(None)
    err = _same_reply_lists(got, ref, "query-sharded hnsw")
    out["query_sharded_hnsw"] = {"ms": q_ms, "unsharded_ms": one_ms, "replicas": len(hidx._replicas)}
    print(f"# query-sharded hnsw {hidx.store.count} x {DIM}, B={len(host_q)} (padded to "
          f"{-(-len(host_q) // SHARDS) * SHARDS}) ef=200: {q_ms:.2f} ms in {SHARDS} slices, "
          f"{one_ms:.2f} ms unsharded; the answers equal (max |diff| {err:.3e}), "
          f"{len(hidx._replicas)} replicas made; card {smi}", flush=True)
    if hidx._replicas:
        raise AssertionError("a replica was made on the index's own device")
    del hidx, hq, ref, got
    torch.cuda.empty_cache()

    # ShardedHNSW and ShardedVamana over phase 7's rows.
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rows = embedding_like(gen, SHARDED_N + BATCH, DIM)
    data, queries = rows[:SHARDED_N], rows[SHARDED_N:]
    host = queries.cpu().numpy()
    truth = exact_labels(data, np.arange(SHARDED_N), queries, 10)
    graphs = (
        ("ShardedHNSW", ShardedHNSW, T.HNSWParams(
            type=T.VecSimType.FLOAT32, dim=DIM, metric=T.VecSimMetric.Cosine, M=HNSW_M,
            efConstruction=HNSW_EFC), HNSW_MIN_RECALL),
        ("ShardedVamana", ShardedVamana, _svs_params("Scalar").svsParams, SVS_MIN_RECALL),
    )
    for name, cls, params, floor in graphs:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        idx = cls(params, mesh)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx.bulk_build_device(data)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        qpar = qp if name == "ShardedHNSW" else _ws_params(SHARDED_WS)
        ms, replies = _timed(lambda: idx.topk_query_batch(host, 10, qpar))
        rec = label_recall(reply_labels(replies, 10), truth)
        res = out[name] = {"build_s": build_s, "build_vps": SHARDED_N / build_s, "ms": ms,
                           "qps": BATCH * 1e3 / ms, "recall": rec,
                           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                           "shard_rows": [s.store.count for s in idx.shards]}
        print(f"# {name} {SHARDED_N} x {DIM} fp32 Cosine over {SHARDS} shards "
              f"{res['shard_rows']}: deferred round-robin build {build_s:.1f} s "
              f"({res['build_vps']:.1f} vectors/s); topk_query_batch B={BATCH} k=10 at "
              f"{'ef' if name == 'ShardedHNSW' else 'window'} 200: {ms:.2f} ms "
              f"({res['qps']:.1f} QPS), recall@10 {rec:.4f} (floor {floor}); peak device memory "
              f"{res['peak_gib']:.2f} GiB; card {smi}", flush=True)
        if rec < floor:
            raise AssertionError(f"{name} recall@10 {rec:.4f} below {floor}")
        if name == "ShardedHNSW":
            gone = np.random.default_rng(SEED + 15).permutation(SHARDED_N)[:WRITE_EAGER]
            for lab in gone:
                if idx.delete_vector(int(lab)) != 1:
                    raise AssertionError(f"ShardedHNSW delete_vector({lab}) removed nothing")
            after = idx.topk_query_batch(host, 10, qp)
            if any(np.isin(r.ids, gone).any() for r in after):
                raise AssertionError("a deleted label answered ShardedHNSW")
            tmp = tempfile.mkdtemp(prefix="chip_smoke_sharded_")
            try:
                save_s, _ = _timed_s(lambda: idx.save(tmp))
                load_s, back = _timed_s(lambda: ShardedHNSW.load(tmp, mesh))
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            if [s.store.device for s in back.shards] != list(mesh.devices):
                raise AssertionError("a loaded shard is not on its mesh device")
            _same_replies(back.topk_query_batch(host, 10, qp), after, "ShardedHNSW reload")
            res.update(save_s=save_s, load_s=load_s)
            print(f"# ShardedHNSW: {WRITE_EAGER} deletes, no deleted label answers; save "
                  f"{save_s:.3f} s, load {load_s:.3f} s, the reload's replies equal; card {smi}",
                  flush=True)
            del back, after
        del idx, replies
    del rows, data, queries
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"# phase 14 done in {out['seconds']:.1f} s; card {smi}", flush=True)
    return out


def headline_store(dev):
    """The headline store (CAP x DIM fp32, the first N rows embedding-like
    unit vectors, the rest zero) and its BATCH queries, from the seed: the
    same tensors every time they are made."""
    from vectorsimilarity_tpu_torch.utils.synthetic import embedding_like

    gen = torch.Generator(device=dev).manual_seed(SEED)
    store = torch.zeros((CAP, DIM), dtype=torch.float32, device=dev)
    embedding_like(gen, N, DIM, out=store)
    qgen = torch.Generator(device=dev).manual_seed(SEED + 100)
    queries = embedding_like(gen, BATCH, DIM, latent_generator=qgen)
    torch.cuda.synchronize()
    return store, queries


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)

    dev = torch.device("cuda:0")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"# {torch.cuda.get_device_name(0)} ({smi}); torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)
    t_start = time.perf_counter()

    # 1. Build.
    phase_build()

    # 2. The headline store, generated on the card.
    t0 = time.perf_counter()
    store, queries = headline_store(dev)
    print(f"# store {N} x {DIM} fp32 cosine generated in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    # 3, 4. Kernels vs plain versions at small odd shapes.
    gm_small = check_kernel(dev, SMALL_SHAPES)
    small_err = check_lanes(dev)
    for name, err in gm_small.items():
        small_err[name, "f32"] = max(small_err[name, "f32"], err)
    for name, err in one_query(store, queries, smi).items():
        small_err[name, "f32"] = max(small_err[name, "f32"], err)

    # 5. The main path at full width, one store type after another. The
    # integer stores hold the fp32 rows scaled to the int8 range (uint8:
    # shifted by 128), their queries likewise, with the stored fp32 norms the
    # index keeps for Cosine.
    flat_rows = store[:PERSIST_N].clone()  # phase 12's flat index
    scale = 127.0 / float(store.abs().max())
    quantize = lambda t, shift: (t * scale).round().clamp(-127, 127).add(shift)
    rows = []
    for lane in LANES:
        t0 = time.perf_counter()
        if lane in ("s8", "u8"):
            shift = 0 if lane == "s8" else 128
            data = torch.cat([quantize(c, shift).to(DTYPES[lane]) for c in store.split(1 << 17)])
            q = quantize(queries, shift)
            norms = int_norms(data)
        else:
            data, q, norms = store.to(DTYPES[lane]), queries, None
        if lane == LANES[-1]:
            del store  # every later store is made; free the fp32 one
        rows += full_width(lane, data, norms, q, smi, small_err)
        del data, q, norms
        torch.cuda.empty_cache()
        print(f"# {lane} store done in {time.perf_counter() - t0:.1f} s", flush=True)

    # 6. The exact fallbacks.
    phase_fallbacks(dev)

    # 7. HNSW, built and searched on the card; 8. its write path. A job of
    # the tiered index runs on a pool thread: every exception a thread
    # raises is recorded, and one fails the run.
    thread_errors = []
    threading.excepthook = lambda a: (thread_errors.append(a),
                                      sys.__excepthook__(a.exc_type, a.exc_value,
                                                         a.exc_traceback))
    kept = {}  # phase 7's HNSW and phase 10's SVS index, for phase 12
    hnsw = phase_hnsw(dev, smi, keep=kept)
    print("# hnsw json " + json.dumps(hnsw), flush=True)

    # 9. The tiered HNSW index with its job queue.
    tiered = phase_tiered(dev, smi)
    print("# tiered json " + json.dumps(tiered), flush=True)

    # 10. SVS-Vamana on the card; 11. the tiered SVS index.
    svs = phase_svs(dev, smi, keep=kept)
    print("# svs json " + json.dumps(svs), flush=True)
    tiered_svs = phase_tiered_svs(dev, smi)
    print("# tiered svs json " + json.dumps(tiered_svs), flush=True)

    # 12. Persistence on the card; 13. the host-orchestrated builds.
    persist = phase_persist(dev, smi, flat_rows, queries, kept)
    print("# persist json " + json.dumps(persist), flush=True)
    del flat_rows
    host_builds = phase_host_builds(dev, smi)
    print("# host builds json " + json.dumps(host_builds), flush=True)

    # 14. Sharding over the mesh [cuda:0] * 4.
    sharded = phase_sharded(dev, smi, kept, rows)
    print("# sharded json " + json.dumps(sharded), flush=True)
    if thread_errors:
        raise AssertionError(f"{len(thread_errors)} thread(s) raised: "
                             f"{[repr(a.exc_value) for a in thread_errors]}")

    print(f"# all phases passed in {time.perf_counter() - t_start:.1f} s; card {smi}")
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
