"""The port's HNSW index against the JAX package's, on the CPU.

One JAX ``HNSWIndex`` is built (``torch_port_common.jax_hnsw_index``: 384 x
16 fp32 Cosine, M = 8, efC = 64, level seed 200, batches of 128) and carried
across with ``convert.hnsw_from_jax``, so both packages search one graph:

- with the bf16 navigation shadow off in both, ``topk_query_batch``,
  ``range_query``, batch-iterator pages and ``get_element_neighbors`` give
  the same labels, distances within 1e-5;
- with the shadow on, recall@10 against the exact answer agrees within 0.02;
- the port's own build of the same rows with the same seed samples the same
  levels and entry point, at least 95% of its level-0 rows equal the JAX
  build's as sets, and its recall@10 at ef = 64 is within 0.02 of JAX's;
- tombstoned labels never come back, in both packages;
- a timeout that fires mid-search returns the same partial beams;
- a multi-value index returns each label once;
- capacity growth of the store and of the upper levels keeps the graph.

The JAX answers are computed once, in the module fixture: every JAX search
shape compiles, and the suite's conftest drops compiled code every few
tests.
"""

import numpy as np
import pytest
import torch

import vectorsimilarity_tpu as jvs
import vectorsimilarity_tpu_torch as tvs
from torch_port_common import (
    HNSW_BATCH,
    HNSW_N,
    TOL,
    assert_replies_parity,
    hnsw_params,
    jax_hnsw_index,
    unit_rows,
)
from vectorsimilarity_tpu import config as jconfig
from vectorsimilarity_tpu.core.interface import VecSimIndexBase as JBase
from vectorsimilarity_tpu_torch import config as tconfig
from vectorsimilarity_tpu_torch.core.interface import VecSimIndexBase as TBase
from vectorsimilarity_tpu_torch.convert import export_hnsw_state, hnsw_from_jax

K = 10
PAGES, PAGE = 3, 10


def _params(pkg, ef):
    p = pkg.VecSimQueryParams()
    p.hnswRuntimeParams.efRuntime = ef
    return p


def _truth(x, queries, k=K):
    return np.argsort(1.0 - queries @ x.T, axis=1, kind="stable")[:, :k]


def _recall(replies, truth):
    return float(np.mean([len(set(r.ids.tolist()) & set(t.tolist())) / len(t)
                          for r, t in zip(replies, truth)]))


def _radius(x, q, rank=12):
    """A radius midway between the rank-th and the next distance (a radius
    at a distance would hang the answer on its last bit)."""
    d = np.sort(1.0 - q @ x.T)
    return float((d[rank] + d[rank + 1]) / 2)


def _gone(jidx, x, queries):
    """Labels to tombstone: the true top-3 of four queries and the entry."""
    return sorted(set(_truth(x, queries[:4], 3).reshape(-1).tolist()) | {jidx.entry_id})


def _tombstoned_answers(idx, x, queries):
    return idx.topk_query_batch(queries, K), idx.range_query(queries[0], _radius(x, queries[0]))


def _timed_out(idx, pkg, base, cfg, queries):
    """top-k with beams of 2 iterations a segment and a callback that fires
    at its third poll (the first is before the search): two segments run."""
    saved = (base.timeout_callback, cfg.timeout_poll_iters)
    polls = []
    base.timeout_callback = staticmethod(lambda ctx: polls.append(ctx) or int(len(polls) >= 3))
    cfg.timeout_poll_iters = 2
    try:
        return idx.topk_query_batch(queries, K, pkg.VecSimQueryParams(timeoutCtx="ctx"))
    finally:
        base.timeout_callback, cfg.timeout_poll_iters = saved


@pytest.fixture(scope="module")
def pair():
    """(jax index, carried port index, rows, queries, JAX answers)."""
    jidx, x = jax_hnsw_index()
    queries = unit_rows(np.random.default_rng(11), 16, x.shape[1])
    tidx = hnsw_from_jax(jidx, device="cpu")
    state = export_hnsw_state(jidx)

    def restore():
        jidx.labels.label_to_id = dict(state["labels"]["label_to_id"])
        jidx.store.host["flags"][:HNSW_N] = state["arrays"]["flags"]
        jidx.num_marked_deleted = 0
        jidx.entry_id, jidx.max_level = state["entry_id"], state["max_level"]

    ref = {}
    saved = jconfig.search_nav_bf16
    jconfig.search_nav_bf16 = False
    try:
        ref["topk"] = jidx.topk_query_batch(queries, K)
        ref["range"] = jidx.range_query(queries[0], _radius(x, queries[0]))
        it = jidx.new_batch_iterator(queries[1])
        ref["pages"] = [(it.get_next_results(PAGE), it.is_depleted()) for _ in range(PAGES)]
        ref["timeout"] = _timed_out(jidx, jvs, JBase, jconfig, queries)
        ref["neighbors"] = {l: jidx.get_element_neighbors(l) for l in (0, 7, jidx.entry_id)}
        # Tombstones, then the index is restored for the other tests.
        gone = _gone(jidx, x, queries)
        ref["marked"] = [jidx.mark_delete(l) for l in gone]
        ref["entry_after"] = jidx.entry_id
        ref["tomb"] = _tombstoned_answers(jidx, x, queries)
        restore()
        jconfig.search_nav_bf16 = True
        ref["topk64"] = jidx.topk_query_batch(queries, K, _params(jvs, 64))
    finally:
        jconfig.search_nav_bf16 = saved
        restore()
    return jidx, tidx, x, queries, ref


@pytest.fixture
def nav_off(monkeypatch):
    monkeypatch.setattr(tconfig, "search_nav_bf16", False)


def test_carried_graph_is_the_same(pair):
    jidx, tidx, *_ = pair
    js, ts = export_hnsw_state(jidx), export_hnsw_state(tidx)
    assert (ts["entry_id"], ts["max_level"], ts["lmax"]) == (js["entry_id"], js["max_level"],
                                                              js["lmax"])
    for name in ("links0", "nlinks0", "level", "upper_row", "data"):
        assert np.array_equal(ts["arrays"][name], js["arrays"][name])
    for name in ("links", "nlinks", "vec"):
        assert np.array_equal(ts["upper"]["arrays"][name], js["upper"]["arrays"][name])


def test_topk_same_labels(pair, nav_off):
    _, tidx, _, queries, ref = pair
    got = tidx.topk_query_batch(queries, K)
    assert_replies_parity(got, ref["topk"], TOL)
    for g, r in zip(got, ref["topk"]):
        assert np.array_equal(g.ids, r.ids)


def test_range_same_labels(pair, nav_off):
    _, tidx, x, queries, ref = pair
    got = tidx.range_query(queries[0], _radius(x, queries[0]))
    assert len(got) == len(ref["range"]) == 13
    assert np.array_equal(got.ids, ref["range"].ids)
    assert np.abs(got.scores - ref["range"].scores).max() <= TOL


def test_batch_iterator_pages(pair, nav_off):
    _, tidx, _, queries, ref = pair
    it = tidx.new_batch_iterator(queries[1])
    for want, depleted in ref["pages"]:
        got = it.get_next_results(PAGE)
        assert np.array_equal(got.ids, want.ids)
        assert np.abs(got.scores - want.scores).max() <= TOL
        assert it.is_depleted() == depleted


def test_timeout_same_partial_results(pair, nav_off):
    _, tidx, _, queries, ref = pair
    got = _timed_out(tidx, tvs, TBase, tconfig, queries)
    assert all(int(r.code) == int(tvs.VecSimQueryReplyCode.TimedOut) for r in ref["timeout"])
    assert_replies_parity(got, ref["timeout"], TOL)
    for g, r in zip(got, ref["timeout"]):
        assert np.array_equal(g.ids, r.ids)
    # The partial beams are not the converged ones.
    assert any(not np.array_equal(a.ids, b.ids) for a, b in zip(got, ref["topk"]))


def test_element_neighbors(pair):
    _, tidx, _, _, ref = pair
    for label, want in ref["neighbors"].items():
        assert tidx.get_element_neighbors(label) == want
    assert tidx.get_element_neighbors(10**6) is None


def test_recall_with_nav_shadow(pair):
    """The bf16 shadow may reorder near-ties, so hold recall, not labels."""
    _, tidx, x, queries, ref = pair
    assert tconfig.search_nav_bf16
    truth = _truth(x, queries)
    rj = _recall(ref["topk64"], truth)
    rt = _recall(tidx.topk_query_batch(queries, K, _params(tvs, 64)), truth)
    assert abs(rt - rj) <= 0.02 and rt >= 0.8


@pytest.mark.parametrize("how", ["add_vector_batch", "bulk_build_device"])
def test_own_build_matches_jax_build(pair, monkeypatch, how):
    """The JAX index was built by add_vector_batch in batches of 128; the
    port builds the same batches either way (bulk: one build_scan of two,
    then the last through the add path), and samples the same levels."""
    jidx, _, x, queries, ref = pair
    monkeypatch.setattr(tconfig, "build_batch", HNSW_BATCH)
    own = tvs.create_index(hnsw_params(tvs), device="cpu")
    if how == "add_vector_batch":
        assert own.add_vector_batch(x, list(range(HNSW_N))) == HNSW_N
    else:
        own.bulk_build_device(torch.from_numpy(x), scan_batches=2)
        assert own.index_size == own.index_label_count == HNSW_N
    js, ts = export_hnsw_state(jidx), export_hnsw_state(own)
    assert np.array_equal(ts["arrays"]["level"], js["arrays"]["level"])
    assert (own.entry_id, own.max_level) == (jidx.entry_id, jidx.max_level)
    l0j, l0t = js["arrays"]["links0"], ts["arrays"]["links0"]
    same = np.mean([set(a[a >= 0]) == set(b[b >= 0]) for a, b in zip(l0j, l0t)])
    assert same >= 0.95, same
    truth = _truth(x, queries)
    rj = _recall(ref["topk64"], truth)
    rt = _recall(own.topk_query_batch(queries, K, _params(tvs, 64)), truth)
    assert abs(rt - rj) <= 0.02
    assert own.build_dropped() == 0


def test_mark_delete_never_returns(pair):
    jidx, _, x, queries, ref = pair
    tidx = hnsw_from_jax(jidx, device="cpu")
    gone = _gone(jidx, x, queries)
    assert [tidx.mark_delete(l) for l in gone] == ref["marked"] == [[l] for l in gone]
    assert tidx.entry_id == ref["entry_after"] and tidx.entry_id not in gone
    assert tidx.num_marked_deleted == len(gone)
    for replies, rng_reply in (_tombstoned_answers(tidx, x, queries), ref["tomb"]):
        for r in replies:
            assert len(r) == K and not set(r.ids.tolist()) & set(gone)
        assert len(rng_reply) and not set(rng_reply.ids.tolist()) & set(gone)


def test_multi_value_labels_once():
    """Every label twice (the second copy a small perturbation): top-k and
    range return each label once."""
    rng = np.random.default_rng(3)
    base = unit_rows(rng, 100, 16)
    twin = base + 0.01 * unit_rows(rng, 100, 16)
    idx = tvs.create_index(hnsw_params(tvs, multi=True), device="cpu")
    idx.add_vector_batch(np.concatenate([base, twin]), list(range(100)) * 2)
    assert idx.index_size == 200 and idx.index_label_count == 100
    queries = unit_rows(rng, 8, 16)
    for r in idx.topk_query_batch(queries, K):
        assert len(r) == K == len(set(r.ids.tolist()))
    rep = idx.range_query(queries[0], 1.0)
    assert len(rep) == len(set(rep.ids.tolist())) > 0


def _graph_of(idx):
    """{(node, level): sorted neighbour ids} over every node and level."""
    return {(v, l): sorted(idx.get_links(v, l))
            for v in range(idx.index_size) for l in range(idx.node_level(v) + 1)}


def test_growth_keeps_the_graph():
    """Two inserts that grow the vector store (1024 -> 2048 rows) and the
    upper levels (M = 4 samples levels past the initial 4) while the links
    live on the device, against the same inserts into a store and upper
    levels made big enough up front: the same graph."""
    rng = np.random.default_rng(8)
    x = unit_rows(rng, 1088, 16)
    params = hnsw_params(tvs)
    params.hnswParams.M = 4
    grown = tvs.create_index(params, device="cpu")
    params.hnswParams.initialCapacity = 2048
    sized = tvs.create_index(params, device="cpu")
    sized.lmax = 16
    sized.upper = sized._new_upper_store(16)
    for idx in (grown, sized):
        idx.add_vector_batch(x[:1024], range(1024))  # one connect batch
        idx.add_vector_batch(x[1024:], range(1024, 1088))
    assert grown.lmax > 4 and grown.store.capacity == sized.store.capacity == 2048
    assert (grown.entry_id, grown.max_level) == (sized.entry_id, sized.max_level)
    assert _graph_of(grown) == _graph_of(sized)
    truth = _truth(x, x[:20])
    assert _recall(grown.topk_query_batch(x[:20], K, _params(tvs, 64)), truth) >= 0.9
