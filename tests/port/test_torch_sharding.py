"""The port's row-sharded flat scan and query-parallel graph serving against
the JAX package's, on the CPU.

The JAX side runs over ``make_mesh(jax.devices()[:S])`` (the conftest's
virtual CPU devices), the port over a mesh of torch devices: ``["cpu"] * S``
(every shard a view of one tensor), and ``["cpu:0", "cpu:1", "cpu:1",
"cpu:2"]``, which torch treats as three devices (a copy per device), so the
paths that move rows and replicas between devices run too. Each JAX answer
is computed once, in a module fixture: a JAX sharded program compiles for
seconds and the conftest drops compiled code every few tests.

- ``sharded_topk`` in the float (L2, IP, Cosine), int8 (Cosine, query
  norms) and sq8 kinds, a count off the shard grid, at k = 10, 100 and 500
  (500 above the shard's rows), against JAX's at k = 500 cut to k (both are
  exact top-k lists in (distance, id) order); each shard runs the flat
  index's engine for its k (K1, K3, K4: their plain versions here), and one
  grid with 65,536 rows a shard runs K4 on each;
- ``scores_sq8`` / ``scores_sq4`` and the sq kinds of ``streaming_topk`` and
  ``full_scores``;
- ``BruteForceIndex.to_sharded``: adds, swap-deletes, growth that
  re-shards, range queries, the batch iterator and the ad-hoc hybrid
  policy against the port's unsharded index, and one JAX ``to_sharded``
  reply set;
- query-sharded HNSW and SVS at an odd batch of 2S + 1 against the
  unsharded answers, replicas remade after a mutation;
- ``dryrun_multichip(8, device="cpu")``, and its default, the card.

Distances within ``TOL`` (1e-5), ids equal except at near-ties; integer
lanes exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorsimilarity_tpu as vs
import vectorsimilarity_tpu_torch as vt
from torch_port_common import TOL, assert_replies_parity, assert_topk_parity, np_of, unit_rows
from vectorsimilarity_tpu.ops import distances as jd
from vectorsimilarity_tpu.parallel import sharding as js
from vectorsimilarity_tpu_torch.core.adhoc import AdhocBfCtx
from vectorsimilarity_tpu_torch.core.hybrid import hybrid_topk
from vectorsimilarity_tpu_torch.core.store import BlockStore, FieldSpec, ShardedRows
from vectorsimilarity_tpu_torch.indexes import brute_force as tbf
from vectorsimilarity_tpu_torch.ops import distances as td
from vectorsimilarity_tpu_torch.parallel import sharding as ts
from vectorsimilarity_tpu_torch.types import VecSearchMode

S = 8
SHARD_N, DIM, B = 128, 16, 5
COUNT = S * SHARD_N - 24  # shard 7 holds 104 live rows
KS = (10, 100, 500)
BIGK_S, BIGK_SHARD_N, BIGK_DIM = 2, 65536, 8
DISTINCT = ["cpu:0", "cpu:1", "cpu:1", "cpu:2"]
CASES = ("f32_L2", "f32_IP", "f32_Cosine", "s8_Cosine", "sq8_L2")


def _inputs(case: str, n: int, dim: int, seed: int):
    """(store columns, queries, query norms) of one case, numpy."""
    rng = np.random.default_rng(seed)
    lane, metric = case.split("_")
    if lane == "f32":
        if metric == "Cosine":
            x, q = unit_rows(rng, n, dim), unit_rows(rng, B, dim)
        else:
            x = rng.standard_normal((n, dim)).astype(np.float32)
            q = rng.standard_normal((B, dim)).astype(np.float32)
        aux = (x * x).sum(1).astype(np.float32) if metric == "L2" else None
        return (x, aux), q, None
    if lane == "s8":
        x = rng.integers(-128, 128, (n, dim)).astype(np.int8)
        q = rng.integers(-128, 128, (B, dim)).astype(np.int8)
        norm = lambda v: np.sqrt((v.astype(np.int64) ** 2).sum(1)).astype(np.float32)  # noqa: E731
        aux = norm(x) if metric == "Cosine" else None
        return (x, aux), q, (norm(q) if metric == "Cosine" else None)
    codes = rng.integers(0, 256, (n, dim)).astype(np.uint8)
    vmin = (0.1 * rng.standard_normal(n)).astype(np.float32)
    delta = rng.uniform(1e-3, 1e-2, n).astype(np.float32)
    dec = vmin[:, None] + delta[:, None] * codes.astype(np.float32)
    xsumsq = (dec * dec).sum(1).astype(np.float32)
    return (codes, vmin, delta, xsumsq), rng.standard_normal((B, dim)).astype(np.float32), None


def _kind(case: str) -> str:
    return {"f32": "float", "s8": "int", "sq8": "sq8"}[case.split("_")[0]]


def _metric(case: str, pkg):
    return pkg.VecSimMetric[case.split("_")[1]]


def _jax_topk(case, n_shards, shard_n, dim, count, k, seed):
    cols, q, qn = _inputs(case, n_shards * shard_n, dim, seed)
    mesh = js.make_mesh(jax.devices()[:n_shards])
    store = tuple(None if c is None else js.shard_rows(jnp.asarray(c), mesh) for c in cols)
    d, i = js.sharded_topk(jnp.asarray(q), store, jnp.int32(count), k,
                           metric=_metric(case, vs), kind=_kind(case), mesh=mesh,
                           query_norms=None if qn is None else jnp.asarray(qn))
    return np.asarray(d), np.asarray(i)


@pytest.fixture(scope="module")
def jax_topk():
    """JAX's sharded top-500 of every case, and of the big-k grids."""
    out = {case: _jax_topk(case, S, SHARD_N, DIM, COUNT, max(KS), 0) for case in CASES}
    for case in ("f32_L2", "s8_L2"):
        out["bigk", case] = _jax_topk(case, BIGK_S, BIGK_SHARD_N, BIGK_DIM,
                                      BIGK_S * BIGK_SHARD_N - 777, 500, 1)
    return out


@pytest.fixture
def engines(monkeypatch):
    """The names of the engines the flat index's ``engine_topk`` and the
    sq8 scan ran, one entry per call."""
    calls = []
    for mod, name in ((tbf, "topk_gm_exact"), (tbf, "topk_fused"), (tbf, "topk_bigk_exact"),
                      (tbf, "streaming_topk"), (ts, "streaming_topk")):
        fn = getattr(mod, name)

        def spy(*a, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)

        monkeypatch.setattr(mod, name, spy)
    return calls


def _port_topk(case, mesh, shard_n, dim, count, k, seed):
    cols, q, qn = _inputs(case, mesh.size * shard_n, dim, seed)
    store = tuple(None if c is None else torch.from_numpy(c) for c in cols)
    return ts.sharded_topk(torch.from_numpy(q), store, count, k, metric=_metric(case, vt),
                           kind=_kind(case), mesh=mesh,
                           query_norms=None if qn is None else torch.from_numpy(qn))


@pytest.mark.parametrize("k", KS)
@pytest.mark.parametrize("case", CASES)
def test_sharded_topk_parity(jax_topk, engines, case, k):
    d, i = _port_topk(case, ts.make_mesh(["cpu"] * S), SHARD_N, DIM, COUNT, k, 0)
    rd, ri = jax_topk[case]
    if case.startswith("s8"):
        assert np.array_equal(np_of(i), ri[:, :k]) and np.array_equal(np_of(d), rd[:, :k])
    else:
        assert_topk_parity(d, i, rd[:, :k], ri[:, :k])
    want = {"float": {10: "topk_gm_exact"}, "int": {10: "topk_gm_exact"}}.get(_kind(case), {})
    # k = 500 exceeds a shard's 128 rows: each shard answers its 128, from K3.
    engine = want.get(k, "topk_fused") if _kind(case) != "sq8" else "streaming_topk"
    assert engines == [engine] * S


@pytest.mark.parametrize("case", ("f32_L2", "s8_L2"))
def test_sharded_topk_bigk_per_shard(jax_topk, engines, case):
    """65,536 rows a shard: k = 500 runs the per-tile top-c engine (K4) on
    each shard."""
    count = BIGK_S * BIGK_SHARD_N - 777
    d, i = _port_topk(case, ts.make_mesh(["cpu"] * BIGK_S), BIGK_SHARD_N, BIGK_DIM, count, 500, 1)
    rd, ri = jax_topk["bigk", case]
    assert_topk_parity(d, i, rd, ri)
    assert engines == ["topk_bigk_exact"] * BIGK_S


def test_sharded_topk_distinct_devices():
    """Shards on three devices (rows copied to each) answer as on one, and
    a shard with no live row answers nothing."""
    mesh = ts.make_mesh(DISTINCT)
    for count in (COUNT // 2, SHARD_N // 2):
        for k in KS:
            d, i = _port_topk("f32_L2", mesh, 2 * SHARD_N, DIM, count, k, 0)
            rd, ri = _port_topk("f32_L2", ts.make_mesh(["cpu"]), 4 * 2 * SHARD_N, DIM, count, k, 0)
            assert_topk_parity(d, i, rd, ri)
            assert (np_of(i) < count).all()


@pytest.mark.parametrize("metric", ("L2", "IP"))
@pytest.mark.parametrize("kind", ("sq8", "sq4"))
def test_sq_scores_parity(kind, metric):
    """scores_sq8 / scores_sq4 and the sq kinds of streaming_topk and
    full_scores; sq4 at an odd dim (the query padded to the codes)."""
    rng = np.random.default_rng(3)
    n, dim, count, k = 300, 15 if kind == "sq4" else 16, 290, 20
    width = (dim + 1) // 2 if kind == "sq4" else dim
    codes = rng.integers(0, 256 if kind == "sq8" else 16, (n, dim if kind == "sq8" else 2 * width))
    if kind == "sq4":
        codes[:, dim:] = 0
        codes = (codes[:, :width] | (codes[:, width:] << 4))
    codes = codes.astype(np.uint8)
    vmin = (0.1 * rng.standard_normal(n)).astype(np.float32)
    delta = rng.uniform(1e-3, 1e-2, n).astype(np.float32)
    xsumsq = rng.uniform(0.5, 2.0, n).astype(np.float32)
    q = rng.standard_normal((B, dim)).astype(np.float32)
    cols = (codes, vmin, delta, xsumsq)
    jm, tm = vs.VecSimMetric[metric], vt.VecSimMetric[metric]
    jfn, tfn = (jd.scores_sq8, td.scores_sq8) if kind == "sq8" else (jd.scores_sq4, td.scores_sq4)
    got = tfn(torch.from_numpy(q), *map(torch.from_numpy, cols), tm)
    want = np.asarray(jfn(jnp.asarray(q), *map(jnp.asarray, cols), jm))
    assert np.abs(np_of(got) - want).max() <= TOL
    tcols = tuple(map(torch.from_numpy, cols))
    jcols = tuple(map(jnp.asarray, cols))
    full = td.full_scores(torch.from_numpy(q), tcols, count, metric=tm, kind=kind)
    jfull = np.asarray(jd.full_scores(jnp.asarray(q), jcols, jnp.int32(count), metric=jm, kind=kind))
    assert np.array_equal(np.isinf(np_of(full)), np.isinf(jfull))
    fin = np.isfinite(jfull)
    assert np.abs(np_of(full)[fin] - jfull[fin]).max() <= TOL
    d, i = td.streaming_topk(torch.from_numpy(q), tcols, count, k, metric=tm, kind=kind, chunk=64)
    rd, ri = jd.streaming_topk(jnp.asarray(q), jcols, jnp.int32(count), k, metric=jm, kind=kind,
                               chunk=64)
    assert_topk_parity(d, i, rd, ri)


# ---------------------------------------------------------------------------
# The sharded flat index
# ---------------------------------------------------------------------------

FLAT_DIM, FLAT_N0, FLAT_MORE = 24, 1500, 2048


def _flat_ops(seed=7):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((FLAT_N0, FLAT_DIM)).astype(np.float32),
            rng.standard_normal((FLAT_MORE, FLAT_DIM)).astype(np.float32),
            rng.standard_normal((B, FLAT_DIM)).astype(np.float32))


def _flat_params(pkg):
    return pkg.VecSimParams(algo=pkg.VecSimAlgo.BF, bfParams=pkg.BFParams(
        type=pkg.VecSimType.FLOAT32, dim=FLAT_DIM, metric=pkg.VecSimMetric.L2))


def _flat_stages(idx, data, more):
    """add -> query -> delete every second label (swaps cross the shard
    boundaries) -> query -> grow past the capacity bucket -> query; yields
    after each mutation."""
    idx.add_vector_batch(data, list(range(FLAT_N0)))
    yield "added"
    for lab in range(0, FLAT_N0, 2):
        idx.delete_vector(lab)
    yield "deleted"
    idx.add_vector_batch(more, list(range(FLAT_N0, FLAT_N0 + FLAT_MORE)))
    yield "grown"


@pytest.fixture(scope="module")
def jax_flat_replies():
    """One JAX ``to_sharded`` reply set per stage (k = 10), 8 shards."""
    data, more, q = _flat_ops()
    idx = vs.create_index(_flat_params(vs))
    idx.to_sharded(js.make_mesh(jax.devices()[:S]))
    return {stage: idx.topk_query_batch(q, 10) for stage in _flat_stages(idx, data, more)}


@pytest.mark.parametrize("devices", (["cpu"] * S, DISTINCT), ids=("one_device", "three_devices"))
def test_flat_to_sharded_lifecycle(jax_flat_replies, devices):
    data, more, q = _flat_ops()
    mesh = ts.make_mesh(devices)
    idx = vt.create_index(_flat_params(vt), device="cpu").to_sharded(mesh)
    ref = vt.create_index(_flat_params(vt), device="cpu")
    for stage, _ in zip(_flat_stages(idx, data, more), _flat_stages(ref, data, more)):
        if devices == ["cpu"] * S:
            assert_replies_parity(idx.topk_query_batch(q, 10), jax_flat_replies[stage])
        for k in KS:
            assert_replies_parity(idx.topk_query_batch(q, k), ref.topk_query_batch(q, k))
        dev = idx.store.device_arrays()["data"]
        assert isinstance(dev, ShardedRows) and dev.shape[0] == idx.store.capacity
        assert len(dev.blocks) == len(mesh.runs())
        if len(mesh.runs()) == 1:  # shards on one device share its one copy
            assert idx.memory_bytes == ref.memory_bytes
        rad = float(np.sort(((data - q[0]) ** 2).sum(1))[40])
        r1, r2 = idx.range_query(q[0], rad), ref.range_query(q[0], rad)
        assert_replies_parity([r1], [r2])
        it1, it2 = idx.new_batch_iterator(q[1]), ref.new_batch_iterator(q[1])
        assert_replies_parity([it1.get_next_results(25), it1.get_next_results(25)],
                              [it2.get_next_results(25), it2.get_next_results(25)])
        dq = torch.from_numpy(q)
        d, i = idx.search_knn_device(dq, 10)
        rd, ri = ref.search_knn_device(dq, 10)
        assert_topk_parity(d, i, rd, ri)
        # A small filter set takes the ad-hoc policy: each label is scored
        # on its shard's device (deleted and absent labels answer NaN).
        filt = list(range(1, FLAT_N0 + FLAT_MORE, 97)) + [0, 10**6]
        h1, h2 = hybrid_topk(idx, q[2], 10, filt), hybrid_topk(ref, q[2], 10, filt)
        assert idx.last_mode == VecSearchMode.HYBRID_ADHOC_BF
        assert_replies_parity([h1], [h2])
        e1 = AdhocBfCtx(idx, q[3]).get_exact_distances(filt)
        e2 = AdhocBfCtx(ref, q[3]).get_exact_distances(filt)
        assert np.array_equal(np.isnan(e1), np.isnan(e2)) and np.isnan(e1[-1])
        assert np.abs(e1 - e2)[~np.isnan(e2)].max() <= TOL
    assert idx.store.capacity == 4096  # grew from 2048 and re-sharded


def test_flat_to_sharded_refusals():
    mesh = ts.make_mesh(["cpu"] * 3)
    idx = vt.create_index(_flat_params(vt), device="cpu")
    with pytest.raises(ValueError, match="divide"):
        idx.to_sharded(mesh)  # 1024 rows over 3 shards
    multi = vt.create_index(vt.VecSimParams(algo=vt.VecSimAlgo.BF, bfParams=vt.BFParams(
        type=vt.VecSimType.FLOAT32, dim=4, metric=vt.VecSimMetric.L2, multi=True)), device="cpu")
    with pytest.raises(ValueError, match="single-value"):
        multi.to_sharded(ts.make_mesh(["cpu"] * 2))


def test_store_sharded_rows_and_set_device():
    """Row writes, swap-deletes and deferred device moves land in the shard
    that owns the row; pull_host reads every shard; set_device moves an
    unsharded store."""
    rng = np.random.default_rng(5)
    store = BlockStore({"data": FieldSpec((4,), np.float32)}, 1024, device="cpu")
    rows = rng.standard_normal((700, 4)).astype(np.float32)
    store.append({"data": rows})
    store.set_sharding(ts.make_mesh(DISTINCT))
    sh = store.device_arrays()["data"]
    assert [(lo, hi) for lo, hi, _ in sh.blocks] == [(0, 256), (256, 768), (768, 1024)]
    assert torch.equal(sh.read_range(0, 700), torch.from_numpy(rows))
    assert torch.equal(sh.shard(2), sh.blocks[1][2][256:512])
    store.set_row(300, {"data": np.full(4, 7.0, np.float32)})
    store.swap_delete(10)  # row 699 moves into row 10
    store.device_arrays()
    want = rows[:699].copy()
    want[300], want[10] = 7.0, rows[699]
    assert torch.equal(sh.read_range(0, 699), torch.from_numpy(want))
    # Device-authoritative rows: swap-deletes become deferred moves.
    store.mark_host_stale("data")
    store.host["data"][:] = 0
    store.swap_delete(600)  # row 698 -> 600, across blocks
    store.swap_delete(5)  # row 697 -> 5
    store.pull_host()
    want[600], want[5] = want[698], want[697]
    assert np.array_equal(store.host["data"][:697], want[:697])
    with pytest.raises(ValueError, match="row-sharded"):
        store.set_device("cpu")
    plain = BlockStore({"data": FieldSpec((4,), np.float32)}, 1024, device="cpu")
    plain.append({"data": rows})
    before = plain.device_arrays()["data"].clone()
    plain.set_device("cpu:1")
    assert plain.device == torch.device("cpu", 1)
    assert torch.equal(plain.device_arrays()["data"], before)


def test_make_mesh(monkeypatch):
    mesh = ts.make_mesh(DISTINCT)
    assert mesh.shape[ts.AXIS] == 4 and mesh.size == 4
    assert [(str(d), a, b) for d, a, b in mesh.runs()] == [("cpu:0", 0, 1), ("cpu:1", 1, 3),
                                                           ("cpu:2", 3, 4)]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ts.make_mesh()
    with pytest.raises(ValueError):
        ts.make_mesh([])
    reps = ts.replicate(torch.ones(3), mesh)
    assert len(reps) == 4 and reps[1] is reps[2]
    fs = ts.ShardedFlatStore(mesh)
    placed = fs.place({"x": np.arange(10, dtype=np.float32)})["x"]
    assert placed.shape == (12,) and torch.equal(placed.read_range(0, 10), torch.arange(10.0))


# ---------------------------------------------------------------------------
# Query-parallel graph serving
# ---------------------------------------------------------------------------

GRAPH_N, GRAPH_DIM = 384, 16


@pytest.fixture(scope="module")
def graphs():
    """One port HNSW and one SVS (Scalar) index over the same rows."""
    x = unit_rows(np.random.default_rng(4), GRAPH_N, GRAPH_DIM)
    h = vt.create_index(vt.VecSimParams(algo=vt.VecSimAlgo.HNSWLIB, hnswParams=vt.HNSWParams(
        type=vt.VecSimType.FLOAT32, dim=GRAPH_DIM, metric=vt.VecSimMetric.Cosine, M=8,
        efConstruction=64, efRuntime=40)), device="cpu")
    s = vt.create_index(vt.VecSimParams(algo=vt.VecSimAlgo.SVS, svsParams=vt.SVSParams(
        type=vt.VecSimType.FLOAT32, dim=GRAPH_DIM, metric=vt.VecSimMetric.L2,
        quantBits=vt.VecSimSvsQuantBits.Scalar, graph_max_degree=16,
        construction_window_size=64, search_window_size=40)), device="cpu")
    for idx in (h, s):
        idx.add_vector_batch(x, list(range(GRAPH_N)))
    return {"hnsw": h, "svs": s}


@pytest.mark.parametrize("devices", (["cpu"] * 4, DISTINCT), ids=("one_device", "three_devices"))
@pytest.mark.parametrize("algo", ("hnsw", "svs"))
def test_query_sharded_graph(graphs, algo, devices):
    idx = graphs[algo]
    mesh = ts.make_mesh(devices)
    rng = np.random.default_rng(6)
    qs = unit_rows(rng, 2 * mesh.size + 1, GRAPH_DIM)  # odd: padded to the mesh
    try:
        base = idx.topk_query_batch(qs, 10)
        bd, bi = idx.search_knn(qs[:8], 10, 40)
        idx.to_query_sharded(mesh)
        assert_replies_parity(idx.topk_query_batch(qs, 10), base)
        d, i = ts.query_parallel_search(idx, qs[:8], 10, 40, mesh)
        assert np.array_equal(i, bi) and np.array_equal(d, bd)
        with pytest.raises(ValueError, match="pad"):
            ts.query_parallel_search(idx, qs[:7], 10, 40, mesh)
        distinct = len(mesh.runs()) > 1
        assert len(idx._replicas) == (3 if distinct else 0)  # one per device not the index's
        # A mutation makes the replicas stale: the next search copies again.
        label = int(base[0].ids[0])
        idx.delete_vector(label)
        after = idx.topk_query_batch(qs, 10)
        assert all(label not in r.ids for r in after)
        idx.to_query_sharded(None)
        assert_replies_parity(after, idx.topk_query_batch(qs, 10))
    finally:
        idx.to_query_sharded(None)
        idx._replicas.clear()
        if idx.index_size < GRAPH_N:
            x = unit_rows(np.random.default_rng(4), GRAPH_N, GRAPH_DIM)
            idx.add_vector_batch(x[label : label + 1], [label])


def test_dryrun_multichip(monkeypatch):
    from vectorsimilarity_tpu_torch.dryrun import dryrun_multichip

    dryrun_multichip(8, device="cpu")
    # Unasked, the dry run takes the card, and without one it raises.
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dryrun_multichip(8)
