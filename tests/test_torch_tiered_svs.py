"""The port's tiered SVS index against the JAX package's, on the CPU, and the
shared SVS thread pool's rental protocol.

Op sequences (``SCENARIOS``) run on both packages' tiered SVS indexes with
no job queue, where every job runs inline: the first migration at the
training threshold, later ones at the update threshold, overwrites and
deletes in both tiers, in-place writes and the info surface. Their replies
agree (labels equal, distances within 1e-5), their counters are equal and
the backends' graphs are equal row for row. The JAX package's SVS index has
no bulk removal, so its tiered GC raises; the JAX side of the GC sequence
removes the same tombstones one by one with the JAX index's own
``_delete_node_tombstoned``, highest id first, which is what the port's GC
does. The JAX answers are computed once, in the module fixture.

With a job queue (``JobQueueThreadPool``), a stalled queue holds the
training migration while reads answer from the flat tier; then the backend
equals the JAX backend's ``add_vector_batch`` of the same rows.
``convert.tiered_svs_from_jax`` carries a JAX tiered SVS index across and
refuses while its batch update is pending.

The ``SharedSVSThreadPool`` cases are ``tests/test_svs_pool.py``'s, on the
port's pool: deferred sizing, disjoint rentals, errors, the scheduled-job
shrink, and the wiring through the API, the SVS index and the tiered
migration. Every case resets the pool and joins its threads.
"""

import threading
import time

import numpy as np
import pytest
import torch

import vectorsimilarity_tpu as jvs
import vectorsimilarity_tpu_torch as tvs
from test_torch_tiered import _assert_same, stalled_pool
from torch_port_common import assert_replies_parity, embedding_rows
from vectorsimilarity_tpu import api as japi
from vectorsimilarity_tpu_torch import api as tapi
from vectorsimilarity_tpu_torch.convert import export_svs_state, tiered_svs_from_jax
from vectorsimilarity_tpu_torch.indexes.tiered_svs import TieredSVSIndex
from vectorsimilarity_tpu_torch.utils.thread_pool import SharedSVSThreadPool

DIM = 16
TRAIN, UPDATE = 64, 16


def _rows(seed, n):
    return embedding_rows(np.random.default_rng(seed), n, DIM)


QUERIES = _rows(100, 16)


def make_tiered(pkg, quant="Scalar", multi=False, pool=None, train=TRAIN, swap=0):
    primary = pkg.VecSimParams(algo=pkg.VecSimAlgo.SVS, svsParams=pkg.SVSParams(
        type=pkg.VecSimType.FLOAT32, dim=DIM, metric=pkg.VecSimMetric.L2, multi=multi,
        quantBits=pkg.VecSimSvsQuantBits[quant], graph_max_degree=12,
        construction_window_size=48, search_window_size=24))
    params = pkg.TieredIndexParams(
        primaryIndexParams=primary,
        tieredHnswParams=pkg.TieredHNSWParams(swapJobThreshold=swap),
        tieredSVSParams=pkg.TieredSVSParams(trainingTriggerThreshold=train,
                                            updateTriggerThreshold=UPDATE))
    if pool is not None:
        params.jobQueue, params.submitCb = pool, pool.submit_cb
    vp = pkg.VecSimParams(algo=pkg.VecSimAlgo.TIERED, tieredParams=params)
    return pkg.create_index(vp, device="cpu") if pkg is tvs else pkg.create_index(vp)


def _graph(backend) -> dict:
    st = export_svs_state(backend)
    keep = ("label", "links", "nlinks", "flags")
    return {"arrays": {n: st["arrays"][n] for n in keep}, "entry": st["entry_id"],
            "labels": st["labels"]}


def _sizes(idx) -> tuple:
    return (idx.index_size, idx.index_label_count, idx.frontend.index_size,
            idx.backend.index_size, idx.backend.num_marked_deleted)


def _gc(pkg, idx) -> int:
    """The tiered GC; on the JAX side its one-by-one equivalent (see the
    module docstring). Returns the rows removed."""
    if pkg is tvs:
        before = idx.backend.store.count
        idx.run_gc()
        return before - idx.backend.store.count
    be = idx.backend
    flagged = np.nonzero(be.store.host["flags"][: be.store.count] & 1)[0]
    be._ensure_host_links()
    for node in sorted(flagged.tolist(), reverse=True):
        be._delete_node_tombstoned(node)
    be.num_marked_deleted -= len(flagged)
    idx._pending_swaps = max(0, idx._pending_swaps - len(flagged))
    be.store.maybe_shrink()
    return len(flagged)


# ---------------------------------------------------------------------------
# Op sequences, each run on both packages (``pkg`` is either package)
# ---------------------------------------------------------------------------


def sc_thresholds(pkg):
    """Training at 64 rows, then an update every 16."""
    idx = make_tiered(pkg)
    data = _rows(0, 100)
    sizes = []
    for i, v in enumerate(data):
        idx.add_vector(v, i)
        if i in (TRAIN - 2, TRAIN - 1, TRAIN + UPDATE - 1, 99):
            sizes.append(_sizes(idx))
    it = idx.new_batch_iterator(data[0])
    pages = [it.get_next_results(7) for _ in range(3)]
    return {"sizes": sizes, "batch": idx.topk_query_batch(data[:16], 5), "pages": pages,
            "range": [idx.range_query(QUERIES[0], 1.0)], "graph": _graph(idx.backend)}


def sc_overwrite_delete(pkg):
    """Overwrites and deletes of labels in the flat tier and in the backend
    (tombstones), then the GC."""
    idx = make_tiered(pkg)
    data = _rows(1, 80)
    for i, v in enumerate(data):
        idx.add_vector(v, i)
    rets = [idx.add_vector(data[40], 3), idx.add_vector(data[3], 70)]
    deleted = [idx.delete_vector(l) for l in (5, 5, 72, 999)]
    out = {"rets": rets, "deleted": deleted, "sizes": _sizes(idx),
           "dist": (idx.get_distance_from(3, data[40]), idx.get_distance_from(70, data[40])),
           "gone": bool(np.isnan(idx.get_distance_from(5, data[40]))),
           "tomb": idx.topk_query_batch(data[:16], 5)}
    out["removed"] = _gc(pkg, idx)
    out.update(after=_sizes(idx), graph=_graph(idx.backend),
               gc=idx.topk_query_batch(QUERIES, 5) + idx.topk_query_batch(data[:16], 5))
    return out


def sc_inplace(pkg):
    idx = make_tiered(pkg)
    for i, v in enumerate(_rows(2, TRAIN)):
        idx.add_vector(v, i)
    pkg.set_write_mode(pkg.VecSimWriteMode.InPlace)
    try:
        v = _rows(3, 2)
        out = {"add": [idx.add_vector(v[0], 100), idx.add_vector(v[1], 2)]}
        out["sizes"] = _sizes(idx)
        out["direct"] = idx.stats_info().directHNSWInsertions
        out["deleted"] = idx.delete_vector(100)
        out["after"] = _sizes(idx)
        out["graph"] = _graph(idx.backend)
        return out
    finally:
        pkg.set_write_mode(pkg.VecSimWriteMode.Async)


def sc_multi(pkg):
    idx = make_tiered(pkg, multi=True)
    data = _rows(4, TRAIN + 8)
    for i, v in enumerate(data):
        idx.add_vector(v, i // 2)
    out = {"sizes": _sizes(idx), "batch": idx.topk_query_batch(data[:16], 4)}
    out["deleted"] = [idx.delete_vector(3), idx.delete_vector(19)]
    out["after"] = _sizes(idx)
    out["removed"] = _gc(pkg, idx)
    out["graph"] = _graph(idx.backend)
    return out


def sc_info(pkg):
    api = japi if pkg is jvs else tapi
    idx = make_tiered(pkg, quant="Q4x8_LeanVec")
    for i, v in enumerate(_rows(5, 5)):
        idx.add_vector(v, i)
    info = idx.basic_info()
    fields = [(f.name, int(f.type)) for f in api.VecSimIndex_DebugInfoIterator(idx)]
    params = pkg.VecSimParams(algo=pkg.VecSimAlgo.TIERED, tieredParams=idx.params)
    return {"basic": (info.isTiered, int(info.algo)), "fields": fields,
            "flat": idx.stats_info().flatBufferSize,
            "estimates": (api.VecSimIndex_EstimateInitialSize(params),
                          api.VecSimIndex_EstimateElementSize(params))}


SCENARIOS = {f.__name__[3:]: f for f in (
    sc_thresholds, sc_overwrite_delete, sc_inplace, sc_multi, sc_info,
)}


@pytest.fixture(scope="module")
def jax_runs():
    return {name: fn(jvs) for name, fn in SCENARIOS.items()}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_sequence_matches_jax(jax_runs, name):
    _assert_same(SCENARIOS[name](tvs), jax_runs[name], name)


def test_sequences_hold_their_invariants(jax_runs):
    th = jax_runs["thresholds"]
    assert th["sizes"] == [(63, 63, 63, 0, 0), (64, 64, 0, 64, 0), (80, 80, 0, 80, 0),
                           (100, 100, 4, 96, 0)]
    assert [int(r.ids[0]) for r in th["batch"]] == list(range(16))
    ow = jax_runs["overwrite_delete"]
    assert ow["rets"] == [0, 0] and ow["deleted"] == [1, 0, 1, 0]
    assert ow["dist"][0] == pytest.approx(0.0, abs=1e-3) and ow["gone"]
    assert ow["removed"] == 4 and ow["after"][4] == 0
    for rep in ow["gc"]:
        assert not {5, 72} & set(rep.ids.tolist())
    assert jax_runs["inplace"]["direct"] == 2
    assert jax_runs["multi"]["deleted"] == [2, 2]


def test_pool_holds_the_training_migration(jax_runs):
    """A stalled single-worker queue: the training job waits while reads
    answer from the flat tier; then one batch builds the JAX backend's
    graph of the same rows."""
    data = _rows(6, TRAIN)
    with stalled_pool(tvs) as (pool, gate):
        idx = make_tiered(tvs, pool=pool)
        for i, v in enumerate(data):
            idx.add_vector(v, i)
        assert _sizes(idx) == (TRAIN, TRAIN, TRAIN, 0, 0)
        assert int(idx.topk_query(data[9], 1).ids[0]) == 9
        gate.set()
        assert pool.wait_for_quiescence(30)
    assert _sizes(idx) == (TRAIN, TRAIN, 0, TRAIN, 0)
    ref = make_tiered(jvs).backend
    ref.add_vector_batch(data, list(range(TRAIN)))
    _assert_same(_graph(idx.backend), _graph(ref))
    assert idx.migrations == 1


def test_convert_carries_and_refuses_while_pending():
    jidx = make_tiered(jvs)
    data = _rows(7, TRAIN + 8)
    for i, v in enumerate(data):
        jidx.add_vector(v, i)
    jidx.delete_vector(4)
    tidx = tiered_svs_from_jax(jidx, device="cpu")
    assert isinstance(tidx, TieredSVSIndex) and _sizes(tidx) == _sizes(jidx)
    assert_replies_parity(tidx.topk_query_batch(QUERIES, 5), jidx.topk_query_batch(QUERIES, 5))
    # The export reads either package's index; a stalled port queue holds
    # the batch update here (a JAX one would only add compiles).
    with stalled_pool(tvs) as (pool, gate):
        tp = make_tiered(tvs, pool=pool, train=4)
        for i, v in enumerate(data[:4]):
            tp.add_vector(v, i)
        with pytest.raises(ValueError, match="pending"):
            tiered_svs_from_jax(tp, device="cpu")
        gate.set()
        assert pool.wait_for_quiescence(30)
    assert tiered_svs_from_jax(tp, device="cpu").backend.index_size == 4


def test_tiered_svs_default_device_is_the_card():
    params = tvs.VecSimParams(algo=tvs.VecSimAlgo.TIERED,
                              tieredParams=make_tiered(tvs).params)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tvs.create_index(params)


# ---------------------------------------------------------------------------
# The shared SVS pool (tests/test_svs_pool.py's cases, on the port's pool)
# ---------------------------------------------------------------------------


@pytest.fixture
def fresh_pool():
    pool = SharedSVSThreadPool.instance()
    pool.reset_for_test()
    yield pool
    pool.reset_for_test()


def test_resize_deferred_until_first_index_attach(fresh_pool):
    fresh_pool.resize(4)
    assert fresh_pool.size() == 1  # recorded, not applied
    fresh_pool.on_index_attached()
    assert fresh_pool.size() == 4


def test_resize_immediate_once_attached(fresh_pool):
    fresh_pool.on_index_attached()
    for size, want in ((3, 3), (6, 6), (2, 2), (0, 1)):  # 0 is clamped to 1
        fresh_pool.resize(size)
        assert fresh_pool.size() == want


def test_parallel_for_covers_every_partition_once(fresh_pool):
    fresh_pool.on_index_attached()
    fresh_pool.resize(4)
    seen = [0] * 64
    lock = threading.Lock()

    def part(i):
        with lock:
            seen[i] += 1

    fresh_pool.parallel_for(part, 64)
    assert seen == [1] * 64


def test_parallel_for_uses_rented_threads(fresh_pool):
    fresh_pool.on_index_attached()
    fresh_pool.resize(4)
    tids = set()
    gate = threading.Barrier(4, timeout=10)

    def part(i):
        gate.wait()  # four threads at once
        tids.add(threading.get_ident())

    fresh_pool.parallel_for(part, 4, device="cpu")
    assert len(tids) == 4 and threading.get_ident() in tids  # the caller runs part 0


def test_parallel_for_degrades_serially_when_slots_busy(fresh_pool):
    fresh_pool.on_index_attached()  # size 1: no slots at all
    done = []
    fresh_pool.parallel_for(done.append, 5)
    assert sorted(done) == [0, 1, 2, 3, 4]


def test_parallel_for_propagates_worker_error(fresh_pool):
    fresh_pool.on_index_attached()
    fresh_pool.resize(3)

    def part(i):
        if i == 2:
            raise ValueError("partition 2 failed")

    with pytest.raises(ValueError, match="partition 2"):
        fresh_pool.parallel_for(part, 3)
    out = []
    fresh_pool.parallel_for(out.append, 3)  # the slots were released
    assert sorted(out) == [0, 1, 2]


def test_shrink_deferred_while_scheduled_job_pending(fresh_pool):
    fresh_pool.on_index_attached()
    fresh_pool.resize(4)
    assert fresh_pool.begin_scheduled_job() == 4
    fresh_pool.resize(2)
    assert fresh_pool.size() == 4  # shrink deferred
    fresh_pool.resize(6)
    assert fresh_pool.size() == 6  # growth applies at once
    fresh_pool.resize(2)
    fresh_pool.end_scheduled_job()
    assert fresh_pool.size() == 2  # applied at quiescence
    with pytest.raises(RuntimeError):
        fresh_pool.end_scheduled_job()


def test_concurrent_renters_take_disjoint_slots(fresh_pool):
    fresh_pool.on_index_attached()
    fresh_pool.resize(5)
    counts = {"a": 0, "b": 0}
    lock = threading.Lock()
    errs = []

    def renter(tag):
        try:
            def part(i):
                time.sleep(0.002)
                with lock:
                    counts[tag] += 1

            for _ in range(10):
                fresh_pool.parallel_for(part, 3)
        except BaseException as e:
            errs.append(e)

    ts = [threading.Thread(target=renter, args=(t,)) for t in ("a", "b")]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    assert not errs and counts == {"a": 30, "b": 30}


def test_api_update_thread_pool_size_resizes_shared_pool(fresh_pool):
    try:
        tapi.VecSim_UpdateThreadPoolSize(0)
        assert tvs.VecSimIndexBase.write_mode == tvs.VecSimWriteMode.InPlace
        tapi.VecSim_UpdateThreadPoolSize(3)
        assert tvs.VecSimIndexBase.write_mode == tvs.VecSimWriteMode.Async
        assert fresh_pool.size() == 1  # deferred: nothing attached yet
        fresh_pool.on_index_attached()
        assert fresh_pool.size() == 3
    finally:
        tvs.set_write_mode(tvs.VecSimWriteMode.Async)


def test_svs_index_attaches_and_shared_memory_reported(fresh_pool):
    tapi.VecSim_UpdateThreadPoolSize(4)
    assert tapi.VecSim_GetSharedMemory() == 0
    idx = tvs.create_index(tvs.VecSimParams(algo=tvs.VecSimAlgo.SVS, svsParams=tvs.SVSParams(
        dim=DIM, metric=tvs.VecSimMetric.Cosine, quantBits=tvs.VecSimSvsQuantBits.Scalar,
        graph_max_degree=8, construction_window_size=24)), device="cpu")
    assert fresh_pool.size() == 4 and tapi.VecSim_GetSharedMemory() > 0
    fields = {f.name: f.value for f in tapi.VecSimIndex_DebugInfoIterator(idx)}
    assert fields["SHARED_MEMORY"] == tapi.VecSim_GetSharedMemory()
    # 4096 rows: the storage normalization runs in pool partitions.
    vecs = np.random.default_rng(0).normal(size=(4096, DIM)).astype(np.float32)
    idx.add_vector_batch(vecs, list(range(4096)))
    assert idx.index_size == 4096 and int(idx.topk_query(vecs[7], 1).ids[0]) == 7


def test_tiered_svs_migration_is_one_scheduled_job(fresh_pool):
    """A shrink issued mid-migration lands after the batch update ends."""
    fresh_pool.on_index_attached()
    fresh_pool.resize(4)
    events = []
    orig = TieredSVSIndex._execute_batch_update_job

    def spy(self):
        fresh_pool.resize(2)  # arrives while the job is pending
        events.append(fresh_pool.size())
        return orig(self)

    idx = make_tiered(tvs, quant="NONE", train=100)  # no migration by itself
    for i, v in enumerate(_rows(8, 16)):
        idx.add_vector(v, i)
    try:
        TieredSVSIndex._execute_batch_update_job = spy
        idx.flush()
    finally:
        TieredSVSIndex._execute_batch_update_job = orig
    assert idx.backend.index_size == 16 and events == [4] and fresh_pool.size() == 2
