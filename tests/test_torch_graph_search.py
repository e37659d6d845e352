"""The port's graph loops against the JAX package's, on graphs made with numpy.

A two-level graph (``torch_port_common.numpy_graph``: n = 300, D = 16,
M0 = 16) and the same queries go through the JAX ``graph_search`` functions
and their ports on the CPU: ``dists_to_ids``, ``exact_rerank``,
``greedy_level`` (upper level, through ``upper_row``), ``beam_search``
(expand 1 and 4; resumed from ``init_state`` with ``iter_budget``) and
``diversity_prune``. Lanes fp32 and int8, metrics L2 / IP / Cosine. Ids are
equal; fp32 distances agree within 1e-5 relative, int8 distances exactly;
empty beam slots are (inf, -1) on both sides. No JAX index is built here.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import lane_aux, np_of, numpy_graph
from vectorsimilarity_tpu.ops import graph_search as jgs
from vectorsimilarity_tpu.types import VecSimMetric as JMetric
from vectorsimilarity_tpu_torch.ops import graph_search as tgs
from vectorsimilarity_tpu_torch.types import VecSimMetric as TMetric

N, D, M0, B = 300, 16, 16, 12
LANE_METRICS = [(lane, m) for lane in ("f32", "s8") for m in ("L2", "IP", "Cosine")]


@functools.lru_cache(maxsize=None)
def _graph(lane):
    return numpy_graph(np.random.default_rng(7), N, D, M0, lane)


def _setup(lane, metric, seed=3):
    """(g, jax args, port args): the graph, and per package the store
    context, the queries (B of them) and the query norms."""
    g = _graph(lane)
    rng = np.random.default_rng(seed)
    if lane == "s8":
        q = rng.integers(-128, 128, size=(B, D)).astype(np.int8)
        qn = np.sqrt((q.astype(np.float64) ** 2).sum(1)).astype(np.float32)
    else:
        q = rng.standard_normal((B, D)).astype(np.float32)
        if metric == "Cosine":
            q /= np.linalg.norm(q, axis=1, keepdims=True)
        qn = None
    qn = qn if (lane == "s8" and metric == "Cosine") else None
    sqnorm, norm = lane_aux(g["x"], metric, lane)

    def side(to, ctx_cls):
        ctx = ctx_cls(data=to(g["x"]), sqnorm=None if sqnorm is None else to(sqnorm),
                      norm=None if norm is None else to(norm))
        return ctx, to(q), None if qn is None else to(qn)

    return g, side(jnp.asarray, jgs.StoreCtx), side(torch.from_numpy, tgs.StoreCtx)


def _kind(lane):
    return "int" if lane == "s8" else "float"


def _assert_dists(d, rd, lane):
    d, rd = np_of(d), np_of(rd)
    fin = np.isfinite(rd)
    assert np.array_equal(np.isfinite(d), fin)
    if lane == "s8":
        assert np.array_equal(d[fin], rd[fin])
    elif fin.any():
        rel = np.abs(d[fin].astype(np.float64) - rd[fin]) / np.maximum(np.abs(rd[fin]), 1.0)
        assert rel.max() <= 1e-5


def _ids_with_pad(g, rng, width=24):
    """[B, width] candidate ids: random rows, the last third -1."""
    ids = rng.integers(0, N, size=(B, width)).astype(np.int32)
    ids[:, -width // 3 :] = -1
    return ids


@pytest.mark.parametrize("lane,metric", LANE_METRICS)
def test_dists_to_ids(lane, metric):
    g, (jctx, jq, jqn), (tctx, tq, tqn) = _setup(lane, metric)
    ids = _ids_with_pad(g, np.random.default_rng(1))
    kw = dict(kind=_kind(lane))
    rd = jgs.dists_to_ids(jq, jnp.asarray(ids), jctx, metric=JMetric[metric], q_norm=jqn, **kw)
    d = tgs.dists_to_ids(tq, torch.from_numpy(ids), tctx, metric=TMetric[metric], q_norm=tqn, **kw)
    _assert_dists(d, rd, lane)
    assert np.isinf(np_of(d)[ids < 0]).all()


@pytest.mark.parametrize("lane,metric", [("f32", "L2")])
def test_exact_rerank(lane, metric):
    g, (jctx, jq, jqn), (tctx, tq, tqn) = _setup(lane, metric)
    ids = _ids_with_pad(g, np.random.default_rng(2))
    ids[:, 3] = ids[:, 0]  # a repeated id: an exact tie, ordered by id
    kw = dict(kind=_kind(lane))
    rd, ri = jgs.exact_rerank(jq, jnp.asarray(ids), jctx, metric=JMetric[metric], q_norm=jqn, **kw)
    d, i = tgs.exact_rerank(tq, torch.from_numpy(ids), tctx, metric=TMetric[metric], q_norm=tqn,
                            **kw)
    assert np.array_equal(np_of(i), np_of(ri))
    _assert_dists(d, rd, lane)
    assert (np_of(i)[:, -8:] == -1).all() and np.isinf(np_of(d)[:, -8:]).all()


def _entry_dists(tq, tctx, entry, lane, metric, tqn):
    """Distances to the entry nodes, from the port (held to the JAX package
    by test_dists_to_ids), handed to both packages' loops."""
    return tgs.dists_to_ids(tq, torch.from_numpy(entry[:, None]), tctx, metric=TMetric[metric],
                            kind=_kind(lane), q_norm=tqn)[:, 0].numpy()


# Each loop runs in a few lanes and metrics (every JAX compile costs ~0.5 s
# here); together the loop cases cover all six, dists_to_ids each of them.
@pytest.mark.parametrize("lane,metric", [("f32", "Cosine"), ("s8", "L2")])
def test_greedy_level(lane, metric):
    """Greedy descent over the upper level (3-D links through upper_row),
    every query from the entry node; half the rows inactive stay put."""
    g, (jctx, jq, jqn), (tctx, tq, tqn) = _setup(lane, metric)
    kind = _kind(lane)
    active = np.arange(B) % 2 == 0
    entry = np.full(B, g["entry"], dtype=np.int32)
    ed = _entry_dists(tq, tctx, entry, lane, metric, tqn)
    rc, rcd = jgs.greedy_level(
        jq, jctx, jnp.asarray(g["ulinks"]), jnp.asarray(g["upper_row"]), jnp.asarray(entry),
        jnp.asarray(ed), jnp.int32(1), jnp.asarray(active), metric=JMetric[metric], kind=kind,
        q_norm=jqn,
    )
    c, cd = tgs.greedy_level(
        tq, tctx, torch.from_numpy(g["ulinks"]), torch.from_numpy(g["upper_row"]),
        torch.from_numpy(entry), torch.from_numpy(ed), 1,
        torch.from_numpy(active), metric=TMetric[metric], kind=kind, q_norm=tqn,
    )
    assert np.array_equal(np_of(c), np_of(rc))
    assert (np_of(c)[~active] == g["entry"]).all()
    _assert_dists(cd, rcd, lane)


BEAM_CASES = [("f32", "Cosine", 1), ("s8", "IP", 1), ("f32", "L2", 4), ("s8", "Cosine", 4)]


def _beams(lane, metric, expand, ef=24, **extra):
    """Both packages' beam_search from node 0 with every third row inactive;
    returns (jax out, port out, active)."""
    g, (jctx, jq, jqn), (tctx, tq, tqn) = _setup(lane, metric)
    kind = _kind(lane)
    active = np.arange(B) % 3 != 0
    entry = np.zeros(B, dtype=np.int32)
    ed = _entry_dists(tq, tctx, entry, lane, metric, tqn)
    jout = jgs.beam_search(
        jq, jctx, jnp.asarray(g["links0"]), None, jnp.asarray(entry), jnp.asarray(ed), N,
        None, jnp.asarray(active), ef=ef, metric=JMetric[metric], kind=kind, q_norm=jqn,
        expand=expand, **extra,
    )
    tout = tgs.beam_search(
        tq, tctx, torch.from_numpy(g["links0"]), None, torch.from_numpy(entry),
        torch.from_numpy(ed), N, None, torch.from_numpy(active), ef=ef,
        metric=TMetric[metric], kind=kind, q_norm=tqn, expand=expand, **extra,
    )
    return jout, tout, active


@pytest.mark.parametrize("lane,metric,expand", BEAM_CASES)
def test_beam_search(lane, metric, expand):
    (rd, ri), (d, i), active = _beams(lane, metric, expand)
    assert np.array_equal(np_of(i), np_of(ri))
    _assert_dists(d, rd, lane)
    # Inactive rows: every slot empty, (inf, -1).
    assert (np_of(i)[~active] == -1).all() and np.isinf(np_of(d)[~active]).all()
    assert (np_of(i)[active, 0] >= 0).all()


@pytest.mark.parametrize("lane,metric", [("f32", "IP")])
def test_beam_search_resumed(lane, metric):
    """A beam cut by ``iter_budget`` and resumed from its state at a larger
    ef: the states and the final beams agree step for step."""
    kw = dict(return_state=True, iter_budget=3)
    (rd, ri, rstate, rdone, rit), (d, i, state, done, it), active = _beams(
        lane, metric, 1, ef=16, **kw)
    assert bool(np_of(rdone)) is done is False and int(np_of(rit)) == int(it) == 3
    _assert_dists(state[0], rstate[0], lane)
    for a, b in zip(state[1:3], rstate[1:3]):
        assert np.array_equal(np_of(a), np_of(b))
    # The visited bitmaps: int32 words here, uint32 there, the same bits.
    assert np.array_equal(np_of(state[3]).view(np.uint32), np_of(rstate[3]))
    g, (jctx, jq, jqn), (tctx, tq, tqn) = _setup(lane, metric)
    kind = _kind(lane)
    zeros = np.zeros(B, dtype=np.int32)
    rd2, ri2, _, rdone2, _ = jgs.beam_search(
        jq, jctx, jnp.asarray(g["links0"]), None, jnp.asarray(zeros), jnp.zeros(B), N,
        None, jnp.asarray(active), ef=32, metric=JMetric[metric], kind=kind, q_norm=jqn,
        init_state=rstate, return_state=True,
    )
    d2, i2, _, done2, _ = tgs.beam_search(
        tq, tctx, torch.from_numpy(g["links0"]), None, torch.from_numpy(zeros), torch.zeros(B),
        N, None, torch.from_numpy(active), ef=32, metric=TMetric[metric], kind=kind, q_norm=tqn,
        init_state=state, return_state=True,
    )
    assert bool(np_of(rdone2)) and done2
    assert np.array_equal(np_of(i2), np_of(ri2))
    _assert_dists(d2, rd2, lane)


@pytest.mark.parametrize("lane,metric,nav", [("f32", "L2", True), ("s8", "Cosine", False)])
def test_diversity_prune(lane, metric, nav):
    """Heuristic 2 over the same candidates (some -1, some repeated
    distances); with ``nav`` the store carries the bf16 shadow on both sides,
    and the prune rescores its anchor leg in fp32."""
    g, (jctx, _, _), (tctx, _, _) = _setup(lane, metric)
    kind = _kind(lane)
    rng = np.random.default_rng(5)
    anchors = rng.integers(0, N, size=B).astype(np.int32)
    cand = np.stack([rng.permutation(N)[:40] for _ in range(B)]).astype(np.int32)
    cand[:, -6:] = -1
    cand[cand == anchors[:, None]] = -1
    jq = jnp.asarray(g["x"][anchors])
    jqn = jctx.norm[anchors] if jctx.norm is not None else None
    cd = np_of(jgs.dists_to_ids(jq, jnp.asarray(cand), jctx, metric=JMetric[metric], kind=kind,
                                q_norm=jqn))
    if nav:
        jctx = jctx._replace(nav=jctx.data.astype(jnp.bfloat16))
        tctx = tctx._replace(nav=tctx.data.to(torch.bfloat16))
    ref = jgs.diversity_prune(jq, jnp.asarray(cand), jnp.asarray(cd), jctx, m=8,
                              metric=JMetric[metric], kind=kind)
    cd = cd.copy()
    got = tgs.diversity_prune(torch.from_numpy(g["x"][anchors]), torch.from_numpy(cand),
                              torch.from_numpy(cd), tctx, m=8, metric=TMetric[metric], kind=kind)
    assert np.array_equal(np_of(got), np_of(ref))
    # Chunking changes no row: 5 rows at a time.
    chunked = tgs.diversity_prune_chunked(
        torch.from_numpy(g["x"][anchors]), torch.from_numpy(cand), torch.from_numpy(cd), tctx,
        m=8, metric=TMetric[metric], kind=kind, chunk_rows=5,
    )
    assert np.array_equal(np_of(chunked), np_of(ref))
