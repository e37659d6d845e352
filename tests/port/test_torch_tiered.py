"""The port's tiered HNSW index against the JAX package's, on the CPU.

The cases of ``tests/test_tiered.py`` run as op sequences (``SCENARIOS``) on
both packages' tiered indexes, most with no job queue, where every job runs
inline, and three with a one-worker queue stalled until the sequence lets it
go (every wait with a timeout, the pool shut down at the end), so both take
the same migration batches and build the same graph: the
sequences' replies agree (labels equal, distances within 1e-5), their
counters are equal, and the backends' graph rows, labels and entry points
are equal row for row after inserts, overwrites, deletes and bulk GC. The
JAX answers are computed once, in the module fixture (every JAX shape
compiles, and the suite's conftest drops compiled code every few tests).

With a job queue (``JobQueueThreadPool``), a stalled queue coalesces 128
inserts into one migration batch, whose graph equals the JAX backend's
``add_vector_batch`` of the same rows; reads see the flat tier meanwhile.
``convert.tiered_from_jax`` carries a JAX tiered index across and refuses
while insert jobs are pending.
"""

import contextlib
import threading

import numpy as np
import pytest
import torch

import vectorsimilarity_tpu as jvs
import vectorsimilarity_tpu_torch as tvs
from torch_port_common import assert_replies_parity, assert_same_graph, host_add
from vectorsimilarity_tpu import api as japi
from vectorsimilarity_tpu.utils.thread_pool import JobQueueThreadPool as JPool
from vectorsimilarity_tpu_torch import api as tapi
from vectorsimilarity_tpu_torch.convert import export_hnsw_state, tiered_from_jax
from vectorsimilarity_tpu_torch.core.results import QueryReply
from vectorsimilarity_tpu_torch.indexes.tiered import TieredHNSWIndex
from vectorsimilarity_tpu_torch.utils.thread_pool import JobQueueThreadPool

DIM = 8
BULK = 128  # rows of the bulk-GC cases, one connect batch


def _rows(seed, n):
    return np.random.default_rng(seed).standard_normal((n, DIM)).astype(np.float32)


QUERIES = _rows(100, 16)


def make_tiered(pkg, multi=False, swap_threshold=0, pool=None, flat_limit=0):
    primary = pkg.VecSimParams(algo=pkg.VecSimAlgo.HNSWLIB, hnswParams=pkg.HNSWParams(
        type=pkg.VecSimType.FLOAT32, dim=DIM, metric=pkg.VecSimMetric.L2, multi=multi,
        M=8, efConstruction=60, efRuntime=30))
    params = pkg.TieredIndexParams(
        primaryIndexParams=primary, flatBufferLimit=flat_limit,
        tieredHnswParams=pkg.TieredHNSWParams(swapJobThreshold=swap_threshold))
    if pool is not None:
        params.jobQueue, params.submitCb = pool, pool.submit_cb
    vp = pkg.VecSimParams(algo=pkg.VecSimAlgo.TIERED, tieredParams=params)
    return pkg.create_index(vp, device="cpu") if pkg is tvs else pkg.create_index(vp)


def _graph(backend) -> dict:
    """The backend's graph and labels as plain values."""
    st = export_hnsw_state(backend)
    keep = ("label", "level", "upper_row", "links0", "nlinks0", "flags")
    return {"arrays": {n: st["arrays"][n] for n in keep},
            "upper": st["upper"]["arrays"], "entry": (st["entry_id"], st["max_level"]),
            "labels": st["labels"]}


def _sizes(idx) -> tuple:
    return (idx.index_size, idx.index_label_count, idx.frontend.index_size,
            idx.backend.index_size, idx.backend.num_marked_deleted)


# ---------------------------------------------------------------------------
# Op sequences, each run on both packages (``pkg`` is either package)
# ---------------------------------------------------------------------------


def sc_sync_insert(pkg):
    idx = make_tiered(pkg)
    data = _rows(0, 32)
    adds = [idx.add_vector(v, i) for i, v in enumerate(data)]
    it = idx.new_batch_iterator(data[0])
    pages = []
    while not it.is_depleted() and len(pages) < 8:
        rep = it.get_next_results(7)
        if len(rep) == 0:
            break
        pages.append(rep)
    return {"adds": adds, "sizes": _sizes(idx), "batch": idx.topk_query_batch(data[:16], 5),
            "pages": pages, "graph": _graph(idx.backend)}


def sc_overwrite(pkg):
    idx = make_tiered(pkg)
    v1, v2 = np.full(DIM, 1.0, np.float32), np.full(DIM, 9.0, np.float32)
    rets = [idx.add_vector(v1, 5), idx.add_vector(v2, 5), idx.add_vector(v1, 6)]
    return {"rets": rets, "sizes": _sizes(idx), "dist": idx.get_distance_from(5, v2),
            "batch": idx.topk_query_batch(np.stack([v2] + [v1] * 15), 5)}


def sc_delete_gc(pkg):
    """Tombstones stay pending below the swap threshold (5); the fifth
    delete reaches it and the GC runs."""
    api = japi if pkg is jvs else tapi
    idx = make_tiered(pkg, swap_threshold=5)
    data = _rows(2, 32)
    for i, v in enumerate(data):
        idx.add_vector(v, i)
    out = {"deleted": [idx.delete_vector(3), idx.delete_vector(3), idx.delete_vector(99)],
           "marked": (idx.backend.num_marked_deleted,
                      idx.stats_info().numberOfMarkedDeleted),
           "tomb": idx.topk_query_batch(data[:16], 5),
           "range": [idx.range_query(QUERIES[0], 6.0)]}
    api.VecSimTieredIndex_AcquireSharedLocks(idx)
    api.VecSimTieredIndex_ReleaseSharedLocks(idx)
    count = idx.backend.store.count
    marked = []
    for lab in range(4, 8):
        idx.delete_vector(lab)
        marked.append(idx.backend.num_marked_deleted)  # 2, 3, 4, then 0: the GC ran
    api.VecSimTieredIndex_GC(idx)  # nothing left to remove
    out.update(marked_after=marked, removed=count - idx.backend.store.count,
               sizes=_sizes(idx), after=idx.topk_query_batch(QUERIES, 5),
               graph=_graph(idx.backend))
    return out


def sc_inplace(pkg):
    pkg.set_write_mode(pkg.VecSimWriteMode.InPlace)
    try:
        idx = make_tiered(pkg)
        v = np.ones(DIM, np.float32)
        out = {"add": [idx.add_vector(v, 1), idx.add_vector(2 * v, 2), idx.add_vector(v, 2)]}
        out["sizes"] = _sizes(idx)
        out["direct"] = idx.stats_info().directHNSWInsertions
        out["deleted"] = idx.delete_vector(1)
        out["after"] = _sizes(idx)
        return out
    finally:
        pkg.set_write_mode(pkg.VecSimWriteMode.Async)


def _tiered_params(pkg):
    primary = pkg.VecSimParams(algo=pkg.VecSimAlgo.HNSWLIB, hnswParams=pkg.HNSWParams(
        type=pkg.VecSimType.FLOAT32, dim=DIM, metric=pkg.VecSimMetric.L2, M=8))
    return pkg.VecSimParams(algo=pkg.VecSimAlgo.TIERED,
                            tieredParams=pkg.TieredIndexParams(primaryIndexParams=primary))


def sc_info(pkg):
    api = japi if pkg is jvs else tapi
    idx = make_tiered(pkg)
    for i, v in enumerate(_rows(8, 5)):
        idx.add_vector(v, i)
    info = idx.basic_info()
    dbg = idx.debug_info()
    fields = [(f.name, int(f.type)) for f in api.VecSimIndex_DebugInfoIterator(idx)]
    return {"basic": (info.isTiered, int(info.algo)), "buffer": dbg.tieredInfo.bufferLimit,
            "threshold": dbg.tieredInfo.specificTieredBackendInfo, "fields": fields,
            "flat": idx.stats_info().flatBufferSize,
            "estimates": (api.VecSimIndex_EstimateInitialSize(_tiered_params(pkg)),
                          api.VecSimIndex_EstimateElementSize(_tiered_params(pkg)))}


def sc_multi(pkg):
    idx = make_tiered(pkg, multi=True)
    e = np.eye(DIM, dtype=np.float32)
    for v, lab in ((e[0], 1), (e[1], 1), (e[2], 2), (e[0] + e[3], 3)):
        idx.add_vector(v, lab)
    out = {"sizes": _sizes(idx), "batch": idx.topk_query_batch(np.tile(e[0], (16, 1)), 2)}
    out["deleted"] = idx.delete_vector(1)
    out["after"] = _sizes(idx)
    idx.run_gc()
    out["graph"] = _graph(idx.backend)
    return out


def sc_bulk_gc(pkg):
    idx = make_tiered(pkg, swap_threshold=100000)
    data = _rows(6, BULK)
    idx.backend.add_vector_batch(data, list(range(BULK)))
    out = {"built": _graph(idx.backend)}
    for i in range(0, 80, 2):
        idx.delete_vector(i)
    out["marked"] = idx.backend.num_marked_deleted
    idx.run_gc()
    out.update(sizes=_sizes(idx), graph=_graph(idx.backend),
               after=idx.topk_query_batch(QUERIES, 5) + idx.topk_query_batch(data[:16], 5))
    return out


def sc_bulk_gc_multi(pkg):
    idx = make_tiered(pkg, multi=True, swap_threshold=100000)
    data = _rows(7, BULK)
    idx.backend.add_vector_batch(data, [i // 2 for i in range(BULK)])  # 2 rows a label
    deleted = [idx.delete_vector(lab) for lab in range(0, 40, 3)]
    idx.run_gc()
    return {"deleted": deleted, "sizes": _sizes(idx), "graph": _graph(idx.backend),
            "after": idx.topk_query_batch(QUERIES, 5)}


@contextlib.contextmanager
def stalled_pool(pkg):
    """A one-worker job queue of ``pkg`` whose worker waits on a gate (set
    by the caller, or at exit), so that jobs queue up until then."""
    pool = (JPool if pkg is jvs else JobQueueThreadPool)(1)
    gate = threading.Event()
    pool.submit_cb(None, None, [None], [lambda _: gate.wait(30)])
    try:
        yield pool, gate
    finally:
        gate.set()
        pool.shutdown()


def sc_pool_overwrite(pkg):
    """An overwrite while the first value's job waits invalidates that job."""
    with stalled_pool(pkg) as (pool, gate):
        idx = make_tiered(pkg, pool=pool)
        v1, v2 = np.full(DIM, 1.0, np.float32), np.full(DIM, 9.0, np.float32)
        rets = [idx.add_vector(v1, 5), idx.add_vector(v2, 5)]
        waiting = _sizes(idx)
        gate.set()
        assert pool.wait_for_quiescence(30)
        return {"rets": rets, "waiting": waiting, "sizes": _sizes(idx),
                "batch": idx.topk_query_batch(np.stack([v2] * 16), 1)}


def sc_flat_limit(pkg):
    """With the flat tier full (flatBufferLimit 1) inserts go straight into
    the backend."""
    with stalled_pool(pkg) as (pool, gate):
        idx = make_tiered(pkg, pool=pool, flat_limit=1)
        data = _rows(4, 5)
        rets = [idx.add_vector(v, i) for i, v in enumerate(data)]
        waiting = (_sizes(idx), idx.stats_info().directHNSWInsertions)
        gate.set()
        assert pool.wait_for_quiescence(30)
        return {"rets": rets, "waiting": waiting, "sizes": _sizes(idx),
                "graph": _graph(idx.backend)}


def sc_flat_reads(pkg):
    """Reads answer from the flat tier while every vector waits there."""
    with stalled_pool(pkg) as (pool, _):
        idx = make_tiered(pkg, pool=pool)
        data = _rows(5, 10)
        for i, v in enumerate(data):
            idx.add_vector(v, i)
        return {"sizes": _sizes(idx), "batch": idx.topk_query_batch(np.tile(data[6], (16, 1)), 3),
                "range": [idx.range_query(data[6], 4.0)]}


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_sync_insert, sc_overwrite, sc_delete_gc, sc_inplace, sc_info, sc_multi, sc_bulk_gc,
    sc_bulk_gc_multi, sc_pool_overwrite, sc_flat_limit, sc_flat_reads,
)}


def _assert_same(port, ref, where=""):
    if isinstance(ref, dict):
        assert port.keys() == ref.keys(), where
        for key in ref:
            _assert_same(port[key], ref[key], f"{where}.{key}")
    elif isinstance(ref, list) and ref and hasattr(ref[0], "ids"):
        assert all(isinstance(p, QueryReply) for p in port), where
        assert_replies_parity(port, ref)
    elif isinstance(ref, np.ndarray):
        assert np.array_equal(port, ref), where
    elif isinstance(ref, float):
        assert port == pytest.approx(ref, abs=1e-5), where
    else:
        assert port == ref, where


@pytest.fixture(scope="module")
def jax_runs():
    """Every sequence's observations on the JAX package; and a JAX tiered
    index with tombstones pending, for the conversion test, with its
    replies to ``QUERIES``."""
    runs = {name: fn(jvs) for name, fn in SCENARIOS.items()}
    jidx = make_tiered(jvs, swap_threshold=100000)
    for i, v in enumerate(_rows(9, 24)):
        jidx.add_vector(v, i)
    for lab in (2, 11):
        jidx.delete_vector(lab)
    return runs, jidx, jidx.topk_query_batch(QUERIES, 5)


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_sequence_matches_jax(jax_runs, name):
    _assert_same(SCENARIOS[name](tvs), jax_runs[0][name], name)


def test_sequences_hold_their_invariants(jax_runs):
    runs = jax_runs[0]
    sync = runs["sync_insert"]
    assert sync["sizes"] == (32, 32, 0, 32, 0)
    assert [r.ids[0] for r in sync["batch"]] == list(range(16))
    seen = [lab for page in sync["pages"] for lab in page.ids.tolist()]
    assert len(seen) == len(set(seen)) >= 28
    assert runs["overwrite"]["rets"] == [1, 0, 1]
    assert runs["overwrite"]["batch"][0].ids[0] == 5
    gc = runs["delete_gc"]
    assert gc["deleted"] == [1, 0, 0] and gc["marked"] == (1, 1)
    assert 3 not in gc["tomb"][3].ids.tolist()
    assert gc["marked_after"] == [2, 3, 4, 0] and gc["removed"] == 5
    assert runs["pool_overwrite"]["rets"] == [1, 0]
    assert runs["pool_overwrite"]["sizes"] == (1, 1, 0, 1, 0)
    assert runs["pool_overwrite"]["batch"][0].scores[0] == pytest.approx(0.0, abs=1e-5)
    assert runs["flat_limit"]["waiting"] == ((5, 5, 1, 4, 0), 4)
    assert runs["flat_limit"]["sizes"] == (5, 5, 0, 5, 0)
    assert runs["flat_reads"]["sizes"] == (10, 10, 10, 0, 0)
    assert runs["flat_reads"]["batch"][0].ids[0] == 6
    assert runs["bulk_gc"]["sizes"][3] == BULK - 40
    assert runs["bulk_gc_multi"]["deleted"] == [2] * 14


def test_pool_coalesces_one_batch_and_reads_see_the_flat_tier(jax_runs):
    """A stalled single-worker queue: 128 inserts wait in the flat tier
    (reads find them there), then one job migrates them all in one batch,
    the JAX backend's ``add_vector_batch`` of the same rows."""
    data = _rows(6, BULK)
    pool = JobQueueThreadPool(1)
    gate = threading.Event()
    try:
        idx = make_tiered(tvs, pool=pool)
        pool.submit_cb(None, None, [None], [lambda _: gate.wait(30)])  # stall
        for i, v in enumerate(data):
            idx.add_vector(v, i)
        assert idx.frontend.index_size == BULK and idx.backend.index_size == 0
        rep = idx.topk_query(data[6], 3)
        truth = np.argsort(((data - data[6]) ** 2).sum(1), kind="stable")[:3]
        assert rep.ids.tolist() == truth.tolist()
        assert tapi.VecSimIndex_DebugInfo(idx).tieredInfo.backgroundIndexing
        gate.set()
        assert pool.wait_for_quiescence(60)
        assert idx.migrations == 1
        assert _sizes(idx) == (BULK, BULK, 0, BULK, 0)
        _assert_same(_graph(idx.backend), jax_runs[0]["bulk_gc"]["built"], "pool")
    finally:
        gate.set()
        pool.shutdown()


def test_tiered_from_jax(jax_runs):
    _, jidx, jreplies = jax_runs
    tidx = tiered_from_jax(jidx, device="cpu")
    assert isinstance(tidx, TieredHNSWIndex) and tidx.device.type == "cpu"
    assert _sizes(tidx) == _sizes(jidx)
    assert tidx._pending_swaps == jidx._pending_swaps == 2
    _assert_same(_graph(tidx.backend), _graph(jidx.backend))
    assert_replies_parity(tidx.topk_query_batch(QUERIES, 5), jreplies)


def test_tiered_from_jax_refuses_pending_jobs():
    pool = JPool(1)
    gate = threading.Event()
    try:
        jidx = make_tiered(jvs, pool=pool)
        pool.submit_cb(None, None, [None], [lambda _: gate.wait(30)])  # stall
        for i, v in enumerate(_rows(10, 2)):
            jidx.add_vector(v, i)
        with pytest.raises(ValueError, match="pending"):
            tiered_from_jax(jidx, device="cpu")
        for lab in (0, 1):  # invalidates both jobs and empties the flat tier
            jidx.delete_vector(lab)
        assert tiered_from_jax(jidx, device="cpu").index_size == 0
        gate.set()
        assert pool.wait_for_quiescence(30)
    finally:
        gate.set()
        pool.shutdown()


def test_tiered_svs_raises_and_the_default_device_is_the_card():
    """Tiered SVS is ported (tests/port/test_torch_tiered_svs.py): it builds
    on the CPU, and its backend's host-orchestrated construction builds the
    JAX package's graph row for row."""
    def params_of(pkg):
        primary = pkg.VecSimParams(algo=pkg.VecSimAlgo.SVS, svsParams=pkg.SVSParams(
            dim=DIM, graph_max_degree=8))
        return pkg.VecSimParams(algo=pkg.VecSimAlgo.TIERED,
                                tieredParams=pkg.TieredIndexParams(primaryIndexParams=primary))

    idx = tvs.create_index(params_of(tvs), device="cpu")
    assert idx.backend.device.type == "cpu"
    assert tapi.VecSimIndex_EstimateElementSize(params_of(tvs)) == \
        japi.VecSimIndex_EstimateElementSize(params_of(jvs))
    jidx = jvs.create_index(params_of(jvs))
    x = _rows(9, 16)
    assert host_add(idx.backend, tvs.config, x, list(range(16))) == 16
    assert host_add(jidx.backend, jvs.config, x, list(range(16))) == 16
    assert_same_graph(jidx.backend, idx.backend)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tvs.create_index(_tiered_params(tvs))
