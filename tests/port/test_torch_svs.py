"""The port's SVS-Vamana index against the JAX package's, on the CPU.

The graph ops first, on stores made with numpy and quantized by the JAX
package: ``gathered_dists`` and ``diversity_prune`` of the ``sq8`` and
``sq4`` kinds agree (distances within 1e-5, the same picks), and
``vamana_connect`` of a batch into a numpy-made graph writes the same rows.

Then one JAX ``SVSIndex`` build per mode NONE, Scalar and Q4x8
(``torch_port_common.jax_svs_index``: 512 x 32 embedding-like Cosine rows,
R = 16, L = 64, chunks of 128), whose answers the module fixture computes
once (every JAX shape compiles, and the suite's conftest drops compiled code
every few tests):

- the port's own build of the same rows has the same codes and the same
  links row for row, and the same medoid entry;
- carried across (``convert.svs_from_jax``), ``topk_query_batch``,
  ``range_query``, batch-iterator pages, the ad-hoc exact distances and
  ``get_distance_from`` give the same labels, distances within 1e-5;
- eager deletes leave the same graph row for row, tombstones
  (``mark_delete``) the same replies; debug info is equal.

The other modes (Q4, Q8, Q4x4, the LeanVec ones) reach the JAX package's own
recall floors (``tests/test_svs_quant.py``: 0.75 for Q4, 0.85 else); a
LeanVec build given the JAX package's projection builds the JAX graph, and
``bulk_build_device`` builds the JAX package's bulk-built graph (its medoid
refreshes between segments). Every mode builds through ``create_index`` on
the CPU, and the size estimates are the JAX package's.
"""

import dataclasses
import enum

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorsimilarity_tpu as jvs
import vectorsimilarity_tpu_torch as tvs
from torch_port_common import (
    SVS_DIM,
    SVS_N,
    TOL,
    assert_replies_parity,
    assert_same_graph,
    embedding_rows,
    host_add,
    jax_svs_index,
    np_of,
    svs_build,
    svs_params,
)
from vectorsimilarity_tpu import api as japi
from vectorsimilarity_tpu import config as jconfig
from vectorsimilarity_tpu.core.adhoc import AdhocBfCtx as JAdhoc
from vectorsimilarity_tpu.ops import graph_build as jgb
from vectorsimilarity_tpu.ops import graph_search as jgs
from vectorsimilarity_tpu.ops import quantize as jq
from vectorsimilarity_tpu.utils import serializer as jser
from vectorsimilarity_tpu_torch import api as tapi
from vectorsimilarity_tpu_torch import config as tconfig
from vectorsimilarity_tpu_torch.convert import export_svs_state, svs_from_jax, svs_from_state
from vectorsimilarity_tpu_torch.core.adhoc import AdhocBfCtx as TAdhoc
from vectorsimilarity_tpu_torch.ops import graph_build as tgb
from vectorsimilarity_tpu_torch.ops import graph_search as tgs
from vectorsimilarity_tpu_torch.utils import serializer as tser

K = 10
MODES = ["NONE", "Scalar", "Q4x8"]
PAGES, PAGE = 3, 10
GONE = [3, 17, 200, 511]  # eagerly deleted labels (the entry's joins them)
MARKED = [5, 6, 7]  # tombstoned labels, after the deletes


def _t(x):
    return torch.from_numpy(np.array(x))


# ---------------------------------------------------------------------------
# Graph ops of the quantized kinds, on numpy-made stores
# ---------------------------------------------------------------------------


def _store(kind, n=160, d=33, seed=0):
    """(x, JAX StoreCtx, port StoreCtx) of rows quantized by the JAX
    package (odd d: the 4-bit pack pads a column)."""
    x = embedding_rows(np.random.default_rng(seed), n, d)
    quant = jq.sq4_quantize if kind == "sq4" else jq.sq8_quantize
    codes, vmin, delta, _, sq = (np_of(a) for a in quant(x))
    jctx = jgs.StoreCtx(data=codes, sqnorm=sq, vmin=vmin, delta=delta)
    tctx = tgs.StoreCtx(data=_t(codes), sqnorm=_t(sq), vmin=_t(vmin), delta=_t(delta))
    return x, jctx, tctx


def _meta(q):
    s = q.sum(-1, dtype=np.float32), (q * q).sum(-1, dtype=np.float32)
    return s, tuple(_t(a) for a in s)


@pytest.mark.parametrize("metric", ["L2", "IP"])
@pytest.mark.parametrize("kind", ["sq8", "sq4"])
def test_gathered_dists_quantized(kind, metric):
    x, jctx, tctx = _store(kind)
    q = embedding_rows(np.random.default_rng(1), 8, x.shape[1])
    ids = np.random.default_rng(2).integers(-1, len(x), size=(8, 24)).astype(np.int32)
    jm, tm = _meta(q)
    m = jvs.VecSimMetric[metric]
    want = jgs.dists_to_ids(q, ids, jctx, metric=m, kind=kind, q_meta=jm)
    got = tgs.dists_to_ids(_t(q), _t(ids), tctx, metric=tvs.VecSimMetric[metric], kind=kind,
                           q_meta=tm)
    assert np.array_equal(np.isinf(np_of(got)), ids < 0)
    ok = ids >= 0
    np.testing.assert_allclose(np_of(got)[ok], np_of(want)[ok], rtol=TOL, atol=TOL)


@pytest.mark.parametrize("alpha", [1.2, 0.95])
@pytest.mark.parametrize("kind", ["sq8", "sq4"])
def test_diversity_prune_quantized(kind, alpha):
    x, jctx, tctx = _store(kind)
    metric = "L2" if alpha > 1 else "IP"
    rng = np.random.default_rng(3)
    owners = rng.integers(0, len(x), size=12)
    cand = np.stack([rng.permutation(len(x))[:40] for _ in owners]).astype(np.int32)
    cand[:, 30:] = -1
    cand[cand == owners[:, None]] = -1
    jq_, jqn, jqm = jgb.anchor_queries(jctx, owners.astype(np.int32), kind,
                                       jvs.VecSimMetric[metric])
    tq_, tqn, tqm = tgb.anchor_queries(tctx, _t(owners), kind, tvs.VecSimMetric[metric])
    np.testing.assert_allclose(np_of(tq_), np_of(jq_), rtol=TOL, atol=TOL)
    cd = np_of(jgs.dists_to_ids(jq_, cand, jctx, metric=jvs.VecSimMetric[metric], kind=kind,
                                q_meta=jqm))
    want = jgs.diversity_prune(jq_, cand, cd, jctx, m=8, metric=jvs.VecSimMetric[metric],
                               kind=kind, alpha=alpha)
    got = tgs.diversity_prune_chunked(tq_, _t(cand), None, tctx, m=8,
                                      metric=tvs.VecSimMetric[metric], kind=kind, alpha=alpha,
                                      q_meta=tqm)
    assert np.array_equal(np_of(got), np_of(want))


@pytest.mark.parametrize("kind", ["sq8", "sq4"])
def test_vamana_connect_quantized(kind):
    """A batch of 32 rows connected into a graph of 128 made with numpy."""
    x, jctx, tctx = _store(kind)
    n0, R = 128, 8
    rng = np.random.default_rng(4)
    links = np.full((len(x), R), -1, dtype=np.int32)
    for r in range(n0):
        nb = rng.permutation(n0)
        nb = nb[nb != r][: rng.integers(3, R + 1)]
        links[r, : len(nb)] = nb
    nlinks = (links >= 0).sum(1).astype(np.int32)
    ids = np.arange(n0, n0 + 32, dtype=np.int32)
    kw = dict(L=32, deg=R, metric=jvs.VecSimMetric.L2, kind=kind, alpha=1.2)
    jstate, jdrop = jgb.vamana_connect(jgb.VamanaState(links, nlinks, np.int32(5)), jctx,
                                       ids, **kw)
    kw["metric"] = tvs.VecSimMetric.L2
    tstate, tdrop = tgb.vamana_connect(tgb.VamanaState(_t(links), _t(nlinks), 5), tctx, ids,
                                       **kw)
    assert np.array_equal(np_of(tstate.links), np_of(jstate.links))
    assert np.array_equal(np_of(tstate.nlinks), np_of(jstate.nlinks))
    assert tstate.entry == int(jstate.entry) and int(tdrop) == int(jdrop)


# ---------------------------------------------------------------------------
# The index: one JAX build per mode, its answers computed once
# ---------------------------------------------------------------------------


def _radius(x, q, rank=12):
    d = np.sort(1.0 - q @ x.T)
    return float((d[rank] + d[rank + 1]) / 2)


def _plain(x):
    """A dataclass tree with enums as ints, memory dropped (each package
    counts its own buffers)."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)
                if f.name != "memory"}
    return int(x) if isinstance(x, enum.Enum) else x


def _answers(idx, x, queries):
    """Every read of the JAX index the tests compare, in one place."""
    it = idx.new_batch_iterator(queries[1])
    labels = [0, 9, 100, 511, 10**6]
    return {
        "topk": idx.topk_query_batch(queries, K),
        "range": idx.range_query(queries[0], _radius(x, queries[0])),
        "pages": [(it.get_next_results(PAGE), it.is_depleted()) for _ in range(PAGES)],
        "adhoc": JAdhoc(idx, queries[2]).get_exact_distances(labels),
        "dist": [idx.get_distance_from(l, queries[3]) for l in labels],
        "fields": [(f.name, int(f.type)) for f in japi.VecSimIndex_DebugInfoIterator(idx)],
        "neighbors": japi.VecSimDebug_GetElementNeighborsInHNSWGraph(idx, 0)[0].name,
    }


def _writes(idx, queries):
    """Eager deletes (the entry's label among them), then tombstones."""
    gone = GONE + [int(idx.store.host["label"][idx.entry_id])]
    deleted = [idx.delete_vector(l) for l in gone]
    idx._ensure_host_links()
    count = idx.store.count
    out = {"deleted": deleted, "count": count, "entry": idx.entry_id,
           "links": idx.store.host["links"][:count].copy(),
           "labels": idx.store.host["label"][:count].copy(),
           "marked": [idx.mark_delete(l) for l in MARKED]}
    out["after"] = idx.topk_query_batch(queries, K)
    return out


@pytest.fixture(scope="module", params=MODES)
def built(request):
    mode = request.param
    jidx, x = jax_svs_index(mode)
    info = _plain(jidx.debug_info())  # before any query: the last mode is the default
    queries = embedding_rows(np.random.default_rng(11), 16, SVS_DIM)
    carried = svs_from_jax(jidx, device="cpu")
    own = tvs.create_index(svs_params(tvs, mode), device="cpu")
    svs_build(own, x, tconfig)
    own._ensure_host_links()
    ref = _answers(jidx, x, queries)
    ref["info"] = info
    ref["state"] = export_svs_state(jidx)
    ref["writes"] = _writes(jidx, queries)
    return mode, x, queries, carried, own, ref


def test_build_links_row_for_row(built):
    _, _, _, _, own, ref = built
    st = ref["state"]
    assert own.entry_id == st["entry_id"]
    for name, want in st["arrays"].items():
        got = own.store.host[name][: st["count"]]
        if name in ("sqnorm", "rsq"):  # sums of the rows, in another order
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
        else:
            assert np.array_equal(got, want), name


def test_topk_and_range_parity(built):
    _, _, queries, carried, own, ref = built
    for idx in (carried, own):
        assert_replies_parity(idx.topk_query_batch(queries, K), ref["topk"])
    got = carried.range_query(queries[0], _radius(built[1], queries[0]))
    assert len(ref["range"]) > 0
    assert_replies_parity([got], [ref["range"]])


def test_batch_iterator_parity(built):
    _, _, queries, carried, _, ref = built
    it = carried.new_batch_iterator(queries[1])
    for want, want_done in ref["pages"]:
        assert_replies_parity([it.get_next_results(PAGE)], [want])
        assert it.is_depleted() == want_done


def test_adhoc_and_distance_parity(built):
    _, _, queries, carried, _, ref = built
    labels = [0, 9, 100, 511, 10**6]
    got = TAdhoc(carried, queries[2]).get_exact_distances(labels)
    np.testing.assert_allclose(got, ref["adhoc"], rtol=TOL, atol=TOL)  # NaN for 10**6
    got = [carried.get_distance_from(l, queries[3]) for l in labels]
    np.testing.assert_allclose(got, ref["dist"], rtol=TOL, atol=TOL)


def test_info_parity(built):
    """Debug info of a fresh carry (the fixture's carried index may have
    answered queries already, which set its last mode)."""
    _, _, _, carried, _, ref = built
    assert _plain(svs_from_state(ref["state"], device="cpu").debug_info()) == ref["info"]
    assert carried.stats_info().numberOfMarkedDeleted == 0
    assert [(f.name, int(f.type)) for f in tapi.VecSimIndex_DebugInfoIterator(carried)] == \
        ref["fields"]
    assert tapi.VecSimDebug_GetElementNeighborsInHNSWGraph(carried, 0)[0].name == \
        ref["neighbors"] == "BadIndex"


def test_deletes_and_tombstones_parity(built):
    _, _, queries, carried, _, ref = built
    got, want = _writes(carried, queries), ref["writes"]
    assert got["deleted"] == want["deleted"] and got["count"] == want["count"]
    assert got["entry"] == want["entry"]
    assert np.array_equal(got["labels"], want["labels"])
    assert np.array_equal(got["links"], want["links"])
    assert [sorted(m) for m in got["marked"]] == [sorted(m) for m in want["marked"]]
    assert_replies_parity(got["after"], want["after"])
    for rep in got["after"]:
        assert not set(rep.ids.tolist()) & set(MARKED + GONE)


# ---------------------------------------------------------------------------
# The other modes, LeanVec with the JAX projection, the bulk build
# ---------------------------------------------------------------------------


def _recall(replies, truth):
    return float(np.mean([len(set(r.ids.tolist()) & set(t.tolist())) / len(t)
                          for r, t in zip(replies, truth)]))


@pytest.mark.parametrize("mode", ["Q4", "Q8", "Q4x4", "Q4x8_LeanVec", "Q8x8_LeanVec"])
def test_quant_mode_recall(mode):
    """The JAX package's floors (test_svs_quant.py: 600 x 48, L = 150,
    ws = 80), and re-ranked distances equal ``get_distance_from``."""
    rng = np.random.default_rng(4)
    n, d = 600, 48
    x = embedding_rows(rng, n, d)
    idx = tvs.create_index(svs_params(tvs, mode, metric="L2", dim=d, graph_max_degree=32,
                                      construction_window_size=150, search_window_size=80),
                           device="cpu")
    idx.add_vector_batch(x, list(range(n)))
    q = embedding_rows(rng, 12, d)
    truth = np.argsort(((q[:, None, :] - x[None]) ** 2).sum(-1), axis=1, kind="stable")[:, :K]
    replies = idx.topk_query_batch(q, K)
    assert _recall(replies, truth) >= (0.75 if mode == "Q4" else 0.85)
    assert int(idx.topk_query(x[17], 1).ids[0]) == 17
    for lab, dist in zip(replies[0].ids.tolist(), replies[0].scores.tolist()):
        assert abs(dist - idx.get_distance_from(int(lab), q[0])) < 1e-3


def test_leanvec_with_jax_projection():
    """Given the JAX build's projection, the port's LeanVec build is the
    JAX graph (a code at a rounding boundary may move one step: at least
    95% of rows equal) and answers alike."""
    jidx, x = jax_svs_index("Q8x8_LeanVec")
    queries = embedding_rows(np.random.default_rng(12), 16, SVS_DIM)
    idx = tvs.create_index(svs_params(tvs, "Q8x8_LeanVec"), device="cpu")
    idx._P = _t(np_of(jidx._P))
    svs_build(idx, x, tconfig)
    idx._ensure_host_links()
    same = (idx.store.host["links"][:SVS_N] == jidx.store.host["links"][:SVS_N]).all(1)
    assert same.mean() >= 0.95
    carried = svs_from_jax(jidx, device="cpu")
    assert torch.equal(carried._P, _t(np_of(jidx._P)))
    want = carried.topk_query_batch(queries, K)
    assert _recall(idx.topk_query_batch(queries, K), np.stack([r.ids for r in want])) >= 0.95


def test_bulk_build_device_parity():
    """``bulk_build_device`` in scan segments of 2 x 64 rows (the medoid
    refreshed between segments on the +12.5% rule) and a pow2 tail."""
    x = embedding_rows(np.random.default_rng(5), 400, SVS_DIM)
    jidx = jvs.create_index(svs_params(jvs, "Scalar"))
    # The rows are unit already: two normalizations may round a code
    # differently at a .5 boundary.
    jidx.bulk_build_device(jnp.asarray(x), batch=64, scan_batches=2, assume_normalized=True)
    jidx._ensure_host_links()
    idx = tvs.create_index(svs_params(tvs, "Scalar"), device="cpu")
    idx.bulk_build_device(_t(x), batch=64, scan_batches=2, assume_normalized=True)
    idx._ensure_host_links()
    assert idx.entry_id == jidx.entry_id
    assert idx.build_dropped() == jidx.build_dropped()
    for name in ("links", "data", "vmin", "delta"):
        idx.store.pull_host(name)
        jidx.store.pull_host(name)
        assert np.array_equal(idx.store.host[name][:400], np.asarray(jidx.store.host[name][:400]))


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", [m.name for m in tvs.VecSimSvsQuantBits])
def test_create_index_every_mode(mode):
    x = embedding_rows(np.random.default_rng(6), 64, SVS_DIM)
    idx = tapi.VecSimIndex_New(svs_params(tvs, mode, metric="L2"), device="cpu")
    idx.add_vector_batch(x, list(range(64)))
    assert idx.index_size == 64 and int(idx.topk_query(x[3], 1).ids[0]) == 3
    for fn in ("VecSimIndex_EstimateElementSize", "VecSimIndex_EstimateInitialSize"):
        assert getattr(tapi, fn)(svs_params(tvs, mode)) == getattr(japi, fn)(
            svs_params(jvs, mode))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            tvs.create_index(svs_params(tvs, mode))


def test_multi_value_and_host_build(tmp_path):
    """A multi-value index answers each label once; after its deletes, the
    host-orchestrated construction (``config.graph_build_device`` off)
    inserts into its device-built graph as the JAX package's does into the
    same graph (carried by the serializer): the same graph row for row."""
    x = embedding_rows(np.random.default_rng(7), 96, SVS_DIM)
    idx = tvs.create_index(svs_params(tvs, "Scalar", multi=True), device="cpu")
    idx.add_vector_batch(x, [i // 2 for i in range(96)])
    rep = idx.topk_query(x[10], 10)
    assert len(set(rep.ids.tolist())) == len(rep.ids) == 10 and int(rep.ids[0]) == 5
    assert idx.delete_vector(5) == 2 and 5 not in idx.topk_query(x[10], 10).ids.tolist()
    tser.save_index(idx, str(tmp_path / "svs.npz"))
    jidx = jser.load_index(str(tmp_path / "svs.npz"))
    y = embedding_rows(np.random.default_rng(8), 4, SVS_DIM)
    assert host_add(idx, tconfig, y, [1000, 1000, 1001, 1002]) == 4
    assert host_add(jidx, jconfig, y, [1000, 1000, 1001, 1002]) == 4
    assert_same_graph(jidx, idx)
    assert int(idx.topk_query(y[3], 1).ids[0]) == 1002
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            svs_from_state(export_svs_state(idx))
