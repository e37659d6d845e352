"""The port's data-sharded graph indexes (``ShardedHNSW``, ``ShardedVamana``)
against the JAX package's, on the CPU.

The module fixture builds, once, a JAX ``ShardedHNSW`` and a JAX
``ShardedVamana`` (SVS Scalar, SQ8 primaries) over ``make_mesh(jax.devices()
[:2])`` from 256 x 16 unit Cosine rows (128 a shard, chunks of 128), and the
port's own builds over ``make_mesh(["cpu"] * 2)``; every JAX answer is
computed there (a JAX sharded program compiles for seconds, and the
conftest drops compiled code every few tests):

- the routing and each shard's links equal the JAX index's row for row;
- the replies of the port's build, and of the JAX index carried across
  (``convert.sharded_hnsw_from_jax`` / ``sharded_vamana_from_jax``), equal
  the JAX index's; the merged reply equals the merge of every shard's own
  search;
- files cross both ways: the port loads the JAX package's ``save``
  directory, and the JAX package loads the port's. The JAX ``load`` leaves
  ``_devs`` unset (its first query raises ``AttributeError``, recorded
  here); it is set by hand for the comparison. The port's ``load`` pins
  each shard to its mesh device;
- deletes, the crowded multi-value case of ``tests/test_multi_distinct.py``,
  the range union, the batch iterator (and its stop on a reply that adds
  nothing), the deferred round-robin ``bulk_build_device`` against the
  port's unsharded bulk builds, and the refused two-level modes.

Distances within ``TOL`` (1e-5), ids equal except at near-ties.
"""

import os
import threading

import jax
import numpy as np
import pytest
import torch

import vectorsimilarity_tpu as vs
import vectorsimilarity_tpu_torch as vt
from torch_port_common import (
    assert_replies_parity,
    assert_same_graph,
    hnsw_params,
    svs_params,
    unit_rows,
)
from vectorsimilarity_tpu import config as jconfig
from vectorsimilarity_tpu.parallel import sharded_graph as jsg
from vectorsimilarity_tpu.parallel.sharding import make_mesh as jmake_mesh
from vectorsimilarity_tpu_torch import config as tconfig
from vectorsimilarity_tpu_torch import convert
from vectorsimilarity_tpu_torch.core.results import make_reply
from vectorsimilarity_tpu_torch.indexes.hnsw import HNSWIndex
from vectorsimilarity_tpu_torch.indexes.svs import SVSIndex
from vectorsimilarity_tpu_torch.parallel import ShardedBatchIterator, ShardedHNSW, ShardedVamana
from vectorsimilarity_tpu_torch.parallel.sharding import make_mesh

S, N, DIM, K, BATCH = 2, 256, 16, 10, 128
ALGOS = ("hnsw", "vamana")


def _params(pkg, algo, **kw):
    if algo == "hnsw":
        return hnsw_params(pkg, **kw).hnswParams
    return svs_params(pkg, "Scalar", dim=DIM, **kw).svsParams


def _cls(pkg, algo):
    if pkg is vs:
        return jsg.ShardedHNSW if algo == "hnsw" else jsg.ShardedVamana
    return ShardedHNSW if algo == "hnsw" else ShardedVamana


def _build(pkg, cfg, algo, mesh, x):
    idx = _cls(pkg, algo)(_params(pkg, algo), mesh)
    saved, cfg.build_batch = cfg.build_batch, BATCH
    try:
        idx.add_vector_batch(x, list(range(len(x))))
    finally:
        cfg.build_batch = saved
    return idx


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """Per algo: the JAX build, the port's build, the JAX replies, the JAX
    package's save directory, and the JAX replies of the port's save loaded
    by the JAX package."""
    rng = np.random.default_rng(0)
    x, q = unit_rows(rng, N, DIM), unit_rows(rng, 7, DIM)
    jmesh, tmesh = jmake_mesh(jax.devices()[:S]), make_mesh(["cpu"] * S)
    out = {"x": x, "q": q, "tmesh": tmesh}
    for algo in ALGOS:
        jidx = _build(vs, jconfig, algo, jmesh, x)
        tidx = _build(vt, tconfig, algo, tmesh, x)
        jdir = str(tmp_path_factory.mktemp(f"jax_{algo}"))
        tdir = str(tmp_path_factory.mktemp(f"port_{algo}"))
        jidx.save(jdir)
        tidx.save(tdir)
        jload = _cls(vs, algo).load(tdir, jmesh)
        try:
            jload.topk_query_batch(q, K)
            raise AssertionError("the JAX load now sets its device list: update the docs")
        except AttributeError:  # the JAX package's load leaves _devs unset
            pass
        jload._devs = list(jmesh.devices.flat)
        out[algo] = {"jax": jidx, "port": tidx, "jdir": jdir, "tdir": tdir,
                     "jax_replies": jidx.topk_query_batch(q, K),
                     "jax_of_port_file": jload.topk_query_batch(q, K)}
    return out


@pytest.mark.parametrize("algo", ALGOS)
def test_routing_and_links_equal_jax(built, algo):
    j, t = built[algo]["jax"], built[algo]["port"]
    assert t._label_shard == {int(k): v for k, v in j._label_shard.items()} and t._rr == j._rr
    for js_, ts_, dev in zip(j.shards, t.shards, built["tmesh"].devices):
        assert_same_graph(js_, ts_)
        assert ts_.store.device == dev


@pytest.mark.parametrize("algo", ALGOS)
def test_replies_equal_jax(built, algo):
    b = built[algo]
    assert_replies_parity(b["port"].topk_query_batch(built["q"], K), b["jax_replies"])
    carried = (convert.sharded_hnsw_from_jax if algo == "hnsw"
               else convert.sharded_vamana_from_jax)(b["jax"], built["tmesh"])
    assert_replies_parity(carried.topk_query_batch(built["q"], K), b["jax_replies"])


@pytest.mark.parametrize("algo", ALGOS)
def test_reply_is_the_merge_of_the_shards(built, algo, monkeypatch):
    """The merged reply equals the merge of every shard's own search at the
    same window (HNSW's shards navigating the exact rows, as the sharded
    path does)."""
    monkeypatch.setattr(tconfig, "search_nav_bf16", False)
    idx = built[algo]["port"]
    for b, rep in enumerate(idx.topk_query_batch(built["q"], K)):
        per_shard = []
        for s in idx.shards:
            r = s.topk_query(built["q"][b], K)
            per_shard += list(zip(r.scores.tolist(), r.ids.tolist()))
        want = sorted(per_shard)[:K]
        assert rep.ids.tolist() == [t[1] for t in want]
        np.testing.assert_allclose(rep.scores, [t[0] for t in want], rtol=1e-6)


@pytest.mark.parametrize("algo", ALGOS)
def test_save_load_both_ways(built, algo):
    b, q = built[algo], built["q"]
    mesh = make_mesh(["cpu:0", "cpu:1"])
    loaded = _cls(vt, algo).load(b["jdir"], mesh)
    assert [s.store.device for s in loaded.shards] == list(mesh.devices)
    assert loaded._label_shard == b["port"]._label_shard and loaded._rr == b["port"]._rr
    assert_replies_parity(loaded.topk_query_batch(q, K), b["jax_replies"])
    assert_replies_parity(b["jax_of_port_file"], b["port"].topk_query_batch(q, K))
    with pytest.raises(ValueError, match="shards"):
        _cls(vt, algo).load(b["tdir"], make_mesh(["cpu"] * 3))


@pytest.mark.parametrize("algo", ALGOS)
def test_delete_and_requery(built, algo):
    """Deletes on the JAX build carried across: no deleted label answers,
    recall over the live rows, and later adds keep the round-robin routing."""
    x, q = built["x"], built["q"]
    idx = (convert.sharded_hnsw_from_jax if algo == "hnsw"
           else convert.sharded_vamana_from_jax)(built[algo]["jax"], built["tmesh"])
    for lab in range(0, N, 3):
        assert idx.delete_vector(lab) == 1
    assert idx.delete_vector(0) == 0
    assert idx.size == N - len(range(0, N, 3))
    live = np.asarray([lab for lab in range(N) if lab % 3])
    hits = 0
    for b, r in enumerate(idx.topk_query_batch(q, K)):
        assert not any(lab % 3 == 0 for lab in r.ids.tolist()) and len(r) == K
        want = live[np.argsort(-(x[live] @ q[b]))[:K]]
        hits += len(set(r.ids.tolist()) & set(want.tolist()))
    assert hits / (K * len(q)) >= 0.9
    fresh = unit_rows(np.random.default_rng(9), 4, DIM)
    idx.add_vector_batch(fresh, list(range(N, N + 4)))
    assert [idx._label_shard[N + i] for i in range(4)] == [0, 1, 0, 1]
    assert idx.topk_query(fresh[3], 1).ids.tolist() == [N + 3]


def test_crowded_multi_value():
    """``tests/test_multi_distinct.py``'s crowd: a label's many values
    colocate on one shard and the merge widens until k distinct labels
    answer, also after tombstones on the shards."""
    rng = np.random.default_rng(14)
    dim, k = 16, 8
    center = rng.standard_normal(dim).astype(np.float32)
    dup = (center + 0.01 * rng.standard_normal((48, dim))).astype(np.float32)
    far = (center + np.linspace(0.5, 3.0, 64)[:, None]
           * rng.standard_normal((64, dim))).astype(np.float32)
    p = vt.HNSWParams(type=vt.VecSimType.FLOAT32, dim=dim, metric=vt.VecSimMetric.L2,
                      multi=True, M=8, efConstruction=80, efRuntime=k)
    idx = ShardedHNSW(p, make_mesh(["cpu"] * 8))
    idx.add_vector_batch(dup, [0] * len(dup))
    idx.add_vector_batch(far, list(range(1, len(far) + 1)))
    labs = idx.topk_query(center, k).ids.tolist()
    assert len(labs) == k and len(set(labs)) == k and 0 in labs
    order = np.argsort(np.linalg.norm(far - center, axis=1))
    for lab in [int(o) + 1 for o in order[: len(far) // 2]]:
        assert idx.shards[idx._label_shard[lab]].mark_delete(lab)
    labs = idx.topk_query(center, k).ids.tolist()
    assert len(labs) == k and len(set(labs)) == k
    assert not set(labs) & {int(o) + 1 for o in order[: len(far) // 2]}


@pytest.mark.parametrize("algo", ALGOS)
def test_range_union_and_batch_iterator(built, algo):
    idx, x = built[algo]["port"], built["x"]
    q = x[42]
    d = 1.0 - x @ q
    rad = float(np.sort(d)[12] + 1e-4)
    rep = idx.range_query(q, rad)
    union = []
    for s in idx.shards:
        r = s.range_query(q, rad)
        union += list(zip(r.scores.tolist(), r.ids.tolist()))
    assert list(zip(rep.scores.tolist(), rep.ids.tolist())) == sorted(union)
    assert set(rep.ids.tolist()) <= set(np.where(d <= rad + 1e-3)[0].tolist())
    by_id = idx.range_query(q, rad, order=vt.QueryReplyOrder.BY_ID)
    assert (np.diff(by_id.ids) > 0).all()
    it = idx.new_batch_iterator(q)
    got = []
    while not it.is_depleted():
        page = it.get_next_results(40)
        if not len(page):
            break
        got += page.ids.tolist()
    assert len(got) == len(set(got)) and len(got) >= int(0.95 * N)
    assert set(np.argsort(d)[:8].tolist()) <= set(got[:40])


def test_refill_stops_on_a_reply_that_adds_nothing():
    """A shard iterator that never reports depletion but answers nothing
    must not spin (the JAX ``_refill`` would loop on it forever)."""

    class Stuck:
        calls = 0

        def is_depleted(self):
            return False

        def get_next_results(self, n, order):
            Stuck.calls += 1
            return make_reply([], [])

    class Shard:
        index_size = 1

        def new_batch_iterator(self, query, params):
            return Stuck()

    class Index:
        shards = [Shard(), Shard()]

    it = ShardedBatchIterator(Index(), np.zeros(4, np.float32))
    assert len(it.get_next_results(10)) == 0
    assert it.is_depleted() and Stuck.calls == 2


@pytest.mark.parametrize("algo", ALGOS)
def test_deferred_bulk_build(algo):
    """The round-robin deferred build equals each shard's own unsharded
    ``bulk_build_device`` of its strided rows, and a deferred build is a
    generator that builds nothing until driven and holds the index's lock
    until it ends."""
    n = 320  # 160 a shard: two segments of two batches of 32, then a tail batch
    x = torch.from_numpy(unit_rows(np.random.default_rng(21), n, DIM))
    p = _params(vt, algo)
    kw = dict(batch=32, scan_batches=2)
    idx = _cls(vt, algo)(p, make_mesh(["cpu"] * S))
    idx.bulk_build_device(x, **kw)
    assert idx.size == n and idx._rr == n
    for i, shard in enumerate(idx.shards):
        own = (HNSWIndex(p, seed=200 + 1000 * i, device="cpu") if algo == "hnsw"
               else SVSIndex(p, device="cpu"))
        gen = own.bulk_build_device(x[i::S], labels=list(range(i, n, S)), _deferred=True, **kw)
        assert own.index_size == n // S and own.entry_id == -1  # rows adopted, no graph yet
        # The build holds the index's lock until it is driven to its end: a
        # search on another thread waits for the whole graph.
        found = []
        t = threading.Thread(target=lambda: found.append(own.search_knn(x[i:i + 1].numpy(), K, 16)))
        t.start()
        t.join(0.2)
        assert t.is_alive() and not found
        for _ in gen:
            pass
        t.join(60)
        assert found and found[0][1][0, 0] == 0  # row 0 holds the query itself
        assert_same_graph(own, shard)
    with pytest.raises(ValueError, match="empty"):
        idx.bulk_build_device(x)
    q = x[:5].numpy()
    assert [r.ids[0] for r in idx.topk_query_batch(q, K)] == list(range(5))


def test_vamana_refuses_two_level_modes():
    for quant in ("Q4x8", "Q8x8_LeanVec"):
        with pytest.raises(ValueError, match="single-level"):
            ShardedVamana(svs_params(vt, quant, dim=DIM).svsParams, make_mesh(["cpu"] * 2))


def test_info_aggregates(built):
    idx = built["hnsw"]["port"]
    info = idx.debug_info()
    assert info.commonInfo.indexSize == N and info.commonInfo.indexLabelCount == N
    assert len(idx.shard_debug_info()) == S
    assert idx.stats_info().memory == idx.memory_bytes == sum(s.memory_bytes for s in idx.shards)
    assert idx.basic_info().dim == DIM and os.path.isdir(built["hnsw"]["tdir"])
