"""The port's query surface against the JAX package's, on the CPU.

The same calls go to the JAX ``api`` and the port's ``api``: on a flat index
filled through ``VecSimIndex_AddVector`` in both packages, and on the shared
JAX HNSW index (``torch_port_common.jax_hnsw_index``) carried across with
``convert.hnsw_from_jax``. Covered: ``resolve_params`` with good and bad
params, top-k / range / batch iterator / distance entry points, hybrid
queries in the ADHOC_BF and BATCHES policies with one predicate, the ad-hoc
scoring context, the debug-info field iterator, the estimates, the default
device, the tiered entry points on an index that is not tiered, and the
entry points of what was not ported before the SVS and persistence slices:
the SVS ones and the host-orchestrated build now work on the CPU (the host
build gives the JAX package's graph row for row). The JAX answers are
computed once per index, in the module fixtures.
"""

import dataclasses
import os
import shutil
import tempfile

import numpy as np
import pytest
import torch

import vectorsimilarity_tpu as jvs
import vectorsimilarity_tpu.api as japi
import vectorsimilarity_tpu_torch as tvs
import vectorsimilarity_tpu_torch.api as tapi
from torch_port_common import (
    TOL,
    assert_same_graph,
    hnsw_params,
    host_add,
    jax_hnsw_index,
    unit_rows,
)
from vectorsimilarity_tpu.core.hybrid import hybrid_topk as jhybrid
from vectorsimilarity_tpu.utils import serializer as jser
from vectorsimilarity_tpu_torch import config as tconfig
from vectorsimilarity_tpu_torch.convert import hnsw_from_jax
from vectorsimilarity_tpu_torch.core.hybrid import hybrid_topk as thybrid
from vectorsimilarity_tpu_torch.utils import serializer as tser
from vectorsimilarity_tpu_torch.utils.thread_pool import SharedSVSThreadPool

N_BF, DIM_BF, K = 60, 8, 7


def _bf_params(pkg):
    return pkg.VecSimParams(algo=pkg.VecSimAlgo.BF, bfParams=pkg.BFParams(
        type=pkg.VecSimType.FLOAT32, dim=DIM_BF, metric=pkg.VecSimMetric.L2))


def _qp(pkg, mode=None, ef=0):
    p = pkg.VecSimQueryParams()
    if mode is not None:
        p.searchMode = getattr(pkg.VecSearchMode, mode)
    p.hnswRuntimeParams.efRuntime = ef
    return p


def _same(got, want, ids_equal=True):
    assert int(got.code) == int(want.code) and len(got) == len(want)
    if ids_equal:
        assert np.array_equal(got.ids, want.ids)
    if len(want):
        assert np.abs(got.scores - want.scores).max() <= TOL


def _answers(api, pkg, hybrid, idx, queries, allowed, labels, radius):
    """Every call of the tests, through one package's surface."""
    out = {
        "topk": api.VecSimIndex_TopKQuery(idx, queries[0], K),
        "topk_by_id": api.VecSimIndex_TopKQuery(idx, queries[0], K,
                                                order=pkg.QueryReplyOrder.BY_ID),
        "range": api.VecSimIndex_RangeQuery(idx, queries[1], radius),
        "dist": api.VecSimIndex_GetDistanceFrom_Unsafe(idx, labels[0], queries[2]),
        "adhoc": api.VecSimIndex_AdhocBfCtx_GetExactDistances(
            api.VecSimIndex_AdhocBfCtx_New(idx, queries[2]), list(labels) + [10**6]),
        "hybrid_adhoc": hybrid(idx, queries[3], K, allowed, _qp(pkg, "HYBRID_ADHOC_BF")),
        "hybrid_batches": hybrid(idx, queries[3], K, allowed, _qp(pkg, "HYBRID_BATCHES")),
        "hybrid_auto": hybrid(idx, queries[3], K, allowed),
        "info": api.VecSimIndex_DebugInfoIterator(idx),
    }
    it = api.VecSimBatchIterator_New(idx, queries[4])
    pages = [api.VecSimBatchIterator_Next(it, 5) for _ in range(2)]
    api.VecSimBatchIterator_Reset(it)
    out["pages"] = pages + [api.VecSimBatchIterator_Next(it, 5),
                            api.VecSimBatchIterator_HasNext(it)]
    return out


@pytest.fixture(scope="module")
def bf():
    """(jax answers, port answers, jax index, port index) of the flat case."""
    x = np.random.default_rng(1).standard_normal((N_BF, DIM_BF)).astype(np.float32)
    queries = np.random.default_rng(2).standard_normal((5, DIM_BF)).astype(np.float32)
    jidx = japi.VecSimIndex_New(_bf_params(jvs))
    tidx = tapi.VecSimIndex_New(_bf_params(tvs), device="cpu")
    for i, v in enumerate(x):
        assert japi.VecSimIndex_AddVector(jidx, v, i) == tapi.VecSimIndex_AddVector(tidx, v, i) == 1
    args = (queries, set(range(0, N_BF, 3)), [3, 11, 40], 6.0)
    return (_answers(japi, jvs, jhybrid, jidx, *args),
            _answers(tapi, tvs, thybrid, tidx, *args), jidx, tidx)


@pytest.fixture(scope="module")
def hnsw():
    """(jax answers, port answers, jax index, port index) of the HNSW case."""
    jidx, x = jax_hnsw_index()
    tidx = hnsw_from_jax(jidx, device="cpu")
    queries = unit_rows(np.random.default_rng(5), 5, x.shape[1])
    args = (queries, set(range(0, len(x), 3)), [3, 11, 40], 0.3)
    return (_answers(japi, jvs, jhybrid, jidx, *args),
            _answers(tapi, tvs, thybrid, tidx, *args), jidx, tidx)


@pytest.mark.parametrize("case", ["bf", "hnsw"])
def test_query_entry_points(case, request):
    """Top-k (both orders), range, distance, batch-iterator pages (with a
    reset) through the API. The HNSW answers ride the bf16 navigation
    shadow in both packages (re-scored exactly), so near-ties may reorder:
    there the label SETS must agree and the distances."""
    want, got, _, _ = request.getfixturevalue(case)
    exact = case == "bf"
    for name in ("topk", "topk_by_id", "range"):
        if not exact:
            assert set(got[name].ids.tolist()) == set(want[name].ids.tolist())
        _same(got[name], want[name], ids_equal=exact or name == "topk_by_id")
    assert abs(got["dist"] - want["dist"]) <= TOL
    for g, w in zip(got["pages"][:3], want["pages"][:3]):
        _same(g, w, ids_equal=exact)
    assert got["pages"][0].ids.tolist() == got["pages"][2].ids.tolist()  # reset
    assert got["pages"][3] == want["pages"][3]


@pytest.mark.parametrize("case", ["bf", "hnsw"])
def test_adhoc_ctx_distances(case, request):
    want, got, _, _ = request.getfixturevalue(case)
    assert np.array_equal(np.isnan(got["adhoc"]), np.isnan(want["adhoc"]))
    assert np.isnan(got["adhoc"][-1])
    ok = ~np.isnan(want["adhoc"])
    assert np.abs(got["adhoc"][ok] - want["adhoc"][ok]).max() <= TOL


@pytest.mark.parametrize("case", ["bf", "hnsw"])
def test_hybrid_policies(case, request):
    """ADHOC_BF and BATCHES with one predicate give the same labels, each
    equal to the JAX package's; the automatic policy picks as JAX does."""
    want, got, jidx, tidx = request.getfixturevalue(case)
    _same(got["hybrid_adhoc"], want["hybrid_adhoc"])
    _same(got["hybrid_batches"], got["hybrid_adhoc"])
    assert set(got["hybrid_batches"].ids.tolist()) == set(want["hybrid_batches"].ids.tolist())
    _same(got["hybrid_auto"], want["hybrid_auto"])
    assert all(int(l) % 3 == 0 for l in got["hybrid_batches"].ids)


def _flat(fields, prefix=""):
    for f in fields:
        if isinstance(f.value, list):
            yield from _flat(f.value, prefix + f.name + ".")
        else:
            yield prefix + f.name, int(f.type), f.value


@pytest.mark.parametrize("case", ["bf", "hnsw"])
def test_debug_info_iterator(case, request):
    """The same fields, types and values; memory sizes aside (the two
    packages hold different arrays)."""
    want, got, _, _ = request.getfixturevalue(case)
    w = {n: (t, v) for n, t, v in _flat(want["info"]) if "memory" not in n.lower()}
    g = {n: (t, v) for n, t, v in _flat(got["info"]) if "memory" not in n.lower()}
    assert g.keys() == w.keys() and "SHARED_MEMORY" in {n for n, _, _ in _flat(got["info"])}
    for n in w:
        assert g[n][0] == w[n][0], n
        if n != "commonInfo.lastMode":
            assert g[n][1] == w[n][1], n


# (algo, raw params, query type) — the resolver cases of tests/test_api.py
# and the HNSW ones: good params, and each error code.
RESOLVE_CASES = [
    ("bf", [("BATCH_SIZE", "50")], "HYBRID"),
    ("bf", [("BATCH_SIZE", "50")], "KNN"),
    ("bf", [("HYBRID_POLICY", "adhoc_bf"), ("BATCH_SIZE", "10")], "HYBRID"),
    ("bf", [("NOPE", "1")], "KNN"),
    ("bf", [("EF_RUNTIME", "20")], "KNN"),
    ("bf", [("HYBRID_POLICY", "batches"), ("BATCH_SIZE", "-3")], "HYBRID"),
    ("hnsw", [("EF_RUNTIME", "20")], "KNN"),
    ("hnsw", [("ef_runtime", "20"), ("EF_RUNTIME", "30")], "KNN"),
    ("hnsw", [("EF_RUNTIME", "abc")], "KNN"),
    ("hnsw", [("EF_RUNTIME", "20")], "RANGE"),
    ("hnsw", [("EPSILON", "0.05")], "RANGE"),
    ("hnsw", [("EPSILON", "0.05")], "KNN"),
    ("hnsw", [("HYBRID_POLICY", "adhoc_bf"), ("EF_RUNTIME", "5")], "HYBRID"),
    ("hnsw", [("HYBRID_POLICY", "nope")], "HYBRID"),
    ("hnsw", [("HYBRID_POLICY", "batches"), ("BATCH_SIZE", "8")], "HYBRID"),
    ("hnsw", [("SEARCH_WINDOW_SIZE", "8")], "KNN"),
]


@pytest.mark.parametrize("algo,raw,qtype", RESOLVE_CASES)
def test_resolve_params(algo, raw, qtype, request):
    _, _, jidx, tidx = request.getfixturevalue(algo)
    jcode, jqp = japi.VecSimIndex_ResolveParams(jidx, raw, jvs.VecsimQueryType[qtype])
    tcode, tqp = tapi.VecSimIndex_ResolveParams(tidx, raw, tvs.VecsimQueryType[qtype])
    assert tcode.name == jcode.name
    if jcode == jvs.VecSimResolveCode.OK:
        assert tqp.batchSize == jqp.batchSize
        assert int(tqp.searchMode) == int(jqp.searchMode)
        assert dataclasses.asdict(tqp.hnswRuntimeParams) == dataclasses.asdict(jqp.hnswRuntimeParams)


def test_element_neighbors_and_estimates(hnsw, bf):
    _, _, jh, th = hnsw
    _, _, jb, tb = bf
    for label in (0, 5, 99):
        jc, jn = japi.VecSimDebug_GetElementNeighborsInHNSWGraph(jh, label)
        tc, tn = tapi.VecSimDebug_GetElementNeighborsInHNSWGraph(th, label)
        assert (tc.name, tn) == (jc.name, jn)
    assert tapi.VecSimDebug_GetElementNeighborsInHNSWGraph(th, 10**6)[0].name == "LabelNotExists"
    assert tapi.VecSimDebug_GetElementNeighborsInHNSWGraph(tb, 0)[0].name == "BadIndex"
    for make in (_bf_params, lambda pkg: hnsw_params(pkg)):
        assert tapi.VecSimIndex_EstimateInitialSize(make(tvs)) == \
            japi.VecSimIndex_EstimateInitialSize(make(jvs))
        assert tapi.VecSimIndex_EstimateElementSize(make(tvs)) == \
            japi.VecSimIndex_EstimateElementSize(make(jvs))
    assert tapi.VecSimParams_GetQueryBlobSize(tvs.VecSimType.INT8, 10, tvs.VecSimMetric.Cosine) == 14
    assert tapi.VecSim_GetSharedMemory() == 0


def _tiered_svs_params():
    primary = tvs.VecSimParams(algo=tvs.VecSimAlgo.SVS, svsParams=tvs.types.SVSParams(dim=8))
    return tvs.VecSimParams(algo=tvs.VecSimAlgo.TIERED,
                            tieredParams=tvs.types.TieredIndexParams(primaryIndexParams=primary))


def _host_build(idx):
    """An insert batch through the host-orchestrated construction, on
    copies of the shared HNSW graph in both packages (carried by the
    serializers): the same graph row for row after it."""
    tmp = tempfile.mkdtemp()
    try:
        tser.save_index(idx, os.path.join(tmp, "hnsw.npz"))
        port = tser.load_index(os.path.join(tmp, "hnsw.npz"), device="cpu")
        ref = jser.load_index(os.path.join(tmp, "hnsw.npz"))
    finally:
        shutil.rmtree(tmp)
    rows = unit_rows(np.random.default_rng(6), 4, idx.dim)
    labels = [10**6 + i for i in range(4)]
    assert host_add(port, tconfig, rows, labels) == host_add(ref, jvs.config, rows, labels) == 4
    assert_same_graph(ref, port)


def _pool_size(idx):
    try:
        tapi.VecSim_UpdateThreadPoolSize(2)
        assert SharedSVSThreadPool.instance().size() in (1, 2)  # 1 until an SVS index attaches
    finally:
        SharedSVSThreadPool.instance().reset_for_test()


@pytest.mark.parametrize("call", [
    _pool_size,
    lambda idx: tapi.VecSimIndex_New(tvs.VecSimParams(
        algo=tvs.VecSimAlgo.SVS, svsParams=tvs.types.SVSParams(dim=8)), device="cpu"),
    lambda idx: tapi.VecSimIndex_New(_tiered_svs_params(), device="cpu"),
    lambda idx: tapi.VecSimIndex_EstimateElementSize(tvs.VecSimParams(
        algo=tvs.VecSimAlgo.SVS, svsParams=tvs.types.SVSParams(dim=8))),
    lambda idx: tapi.VecSimIndex_EstimateInitialSize(_tiered_svs_params()),
    _host_build,
], ids=["pool_size", "svs", "tiered_svs", "svs_estimate", "tiered_svs_estimate", "host_build"])
def test_not_ported_entry_points_raise(call, hnsw):
    """The SVS entry points and the host-orchestrated build are ported and
    work on the CPU: none of these raises any more."""
    call(hnsw[3])


def test_tiered_entry_points_work_on_any_index(hnsw):
    """The three tiered entry points: the GC does nothing on an index that is
    not tiered, and the shared locks are the index's own."""
    _, _, _, tidx = hnsw
    tapi.VecSimTieredIndex_GC(tidx)
    tapi.VecSimTieredIndex_AcquireSharedLocks(tidx)
    try:
        assert tidx._lock._is_owned()
    finally:
        tapi.VecSimTieredIndex_ReleaseSharedLocks(tidx)
    assert not tidx._lock._is_owned()
    with pytest.raises(ValueError, match="primaryIndexParams"):
        tapi.VecSimIndex_New(tvs.VecSimParams(
            algo=tvs.VecSimAlgo.TIERED, tieredParams=tvs.types.TieredIndexParams()), device="cpu")


def test_default_device_is_the_card():
    """Without ``device=`` an index goes to the current CUDA device; with no
    card that is an error, never a silent CPU index."""
    for params in (hnsw_params(tvs), _bf_params(tvs)):
        if torch.cuda.is_available():
            assert tapi.VecSimIndex_New(params).device.type == "cuda"
        else:
            with pytest.raises(RuntimeError):
                tapi.VecSimIndex_New(params)
