"""The port's flat index against the JAX package's, end to end on the CPU.

The same add -> delete (swap-with-last) -> overwrite -> query sequence goes
through both packages' ``create_index``. The port serves k <= 32 from the
group-min engine, k <= 128 from the fused engine and k <= 2048 from the
big-k engine (their kernels' plain versions on the CPU); the JAX package on
the CPU serves all of them from its streaming scan, the engine the others
must equal.
Distances within 1e-5, ids equal except at near-ties; integer stores
bit-exact.
"""

import dataclasses
import enum

import numpy as np
import pytest

import vectorsimilarity_tpu.types as jt
import vectorsimilarity_tpu_torch.types as tt
from torch_port_common import TOL, assert_replies_parity, assert_same_graph, host_add, unit_rows
from vectorsimilarity_tpu import config as jconfig
from vectorsimilarity_tpu.core.interface import VecSimIndexBase as JBase
from vectorsimilarity_tpu.indexes.factory import create_index as jcreate
from vectorsimilarity_tpu_torch import config as tconfig
from vectorsimilarity_tpu_torch.convert import bruteforce_from_state, export_state
from vectorsimilarity_tpu_torch.core.interface import VecSimIndexBase as TBase
from vectorsimilarity_tpu_torch.core.results import make_reply
from vectorsimilarity_tpu_torch.indexes.factory import create_index as tcreate
from vectorsimilarity_tpu_torch.ops.kernels import bf_topk as bfk

DIM = 24


@pytest.fixture
def small_tiles(monkeypatch):
    """Kernel tiles small enough for a 1024-row store to hold 64 groups,
    and a counter of the group-min engine's plain-version calls."""
    monkeypatch.setattr(tconfig, "tile_n", 64)
    monkeypatch.setattr(tconfig, "gm_group_n", 16)
    calls = []
    ref = bfk.group_min_scores_ref

    def counted(*a, **kw):
        calls.append(1)
        return ref(*a, **kw)

    monkeypatch.setattr(bfk, "group_min_scores_ref", counted)
    return calls


def _pair(metric, multi, vtype="FLOAT32"):
    def params(types):
        bf = types.BFParams(type=types.VecSimType[vtype], dim=DIM,
                            metric=types.VecSimMetric[metric], multi=multi)
        return types.VecSimParams(algo=types.VecSimAlgo.BF, bfParams=bf)

    return jcreate(params(jt)), tcreate(params(tt), device="cpu")


def _vectors(rng, n, vtype):
    if vtype == "INT8":
        return rng.integers(-128, 128, size=(n, DIM)).astype(np.int8)
    return unit_rows(rng, n, DIM)


def _fill(rng, j, t, multi, vtype="FLOAT32", n=600):
    """The same writes into both: a bulk add, swap-with-last deletes,
    overwrites (single) or extra rows (multi). Returns live labels."""
    x = _vectors(rng, n, vtype)
    labels = (rng.integers(0, n // 2, size=n) if multi else np.arange(n)).tolist()
    for idx in (j, t):
        assert idx.add_vector_batch(x, labels) == n
    dead = rng.choice(sorted(set(labels)), size=40, replace=False).tolist()
    for lab in dead:
        assert j.delete_vector(lab) == t.delete_vector(lab) > 0
    live = sorted(set(labels) - set(dead))
    for lab, v in zip(live[:30], _vectors(rng, 30, vtype)):
        assert j.add_vector(v, lab) == t.add_vector(v, lab)
    assert j.index_size == t.index_size and j.index_label_count == t.index_label_count
    return live, dead


def _same_replies(port, ref, exact):
    if exact:
        assert [r.code for r in port] == [r.code for r in ref]
        for p, r in zip(port, ref):
            assert np.array_equal(p.ids, r.ids) and np.array_equal(p.scores, r.scores)
    else:
        assert_replies_parity(port, ref)


@pytest.mark.parametrize("multi", [False, True])
@pytest.mark.parametrize("metric", ["L2", "IP", "Cosine"])
def test_flat_index_matches_jax(metric, multi, small_tiles):
    rng = np.random.default_rng(["L2", "IP", "Cosine"].index(metric) * 2 + multi)
    j, t = _pair(metric, multi)
    live, dead = _fill(rng, j, t, multi)
    q = unit_rows(rng, 5, DIM)

    for k in (10, 64):
        _same_replies(t.topk_query_batch(q, k), j.topk_query_batch(q, k), exact=False)
    assert bool(small_tiles) != multi  # single-value k=10 ran the group-min engine

    scores = np.sort(j.topk_query(q[0], 200).scores)
    gaps = np.flatnonzero(np.diff(scores[50:]) > 10 * TOL)
    radius = float(scores[50 + gaps[0]:52 + gaps[0]].mean())
    _same_replies([t.range_query(q[0], radius)], [j.range_query(q[0], radius)], exact=False)

    it_j, it_t = j.new_batch_iterator(q[1]), t.new_batch_iterator(q[1])
    got, want = [], []
    while not it_j.is_depleted():
        assert not it_t.is_depleted()
        got.append(it_t.get_next_results(97))
        want.append(it_j.get_next_results(97))
        assert len(got[-1]) == len(want[-1])
    assert it_t.is_depleted()
    _same_replies([_concat(got)], [_concat(want)], exact=False)

    for lab in live[:3] + dead[:1]:
        a, b = t.get_distance_from(lab, q[2]), j.get_distance_from(lab, q[2])
        assert (np.isnan(a) and np.isnan(b)) or abs(a - b) <= TOL


def _concat(replies):
    """The batches of an iterator as one reply, in the order served."""
    return make_reply(np.concatenate([r.ids for r in replies]),
                      np.concatenate([r.scores for r in replies]))


def test_int8_store_is_bit_exact():
    rng = np.random.default_rng(5)
    j, t = _pair("L2", False, vtype="INT8")
    _fill(rng, j, t, False, vtype="INT8")
    q = _vectors(rng, 4, "INT8")
    _same_replies(t.topk_query_batch(q, 10), j.topk_query_batch(q, 10), exact=True)


@pytest.mark.parametrize("multi", [False, True])
def test_timeout_returns_the_same_partial_results(multi, monkeypatch):
    rng = np.random.default_rng(6)
    j, t = _pair("Cosine", multi)
    _fill(rng, j, t, multi)
    q = unit_rows(rng, 3, DIM)
    # 256-row segments; the callback fires at its third poll (the first is
    # before the scan), so two segments are scanned and the reply is the
    # prefix's top-k, flagged TimedOut.
    for mod in (jconfig, tconfig):
        monkeypatch.setattr(mod, "timeout_poll_rows", 256)
    for base in (JBase, TBase):
        polls = []
        monkeypatch.setattr(base, "timeout_callback",
                            staticmethod(lambda ctx, polls=polls: polls.append(ctx) or
                                         int(len(polls) >= 3)))
    ref = j.topk_query_batch(q, 10, jt.VecSimQueryParams(timeoutCtx="ctx"))
    got = t.topk_query_batch(q, 10, tt.VecSimQueryParams(timeoutCtx="ctx"))
    assert all(r.code == jt.VecSimQueryReplyCode.TimedOut for r in ref)
    _same_replies(got, ref, exact=False)


@pytest.mark.parametrize("multi", [False, True])
def test_convert_carries_a_jax_index_with_deletes(multi, small_tiles):
    rng = np.random.default_rng(7)
    j, t0 = _pair("L2", multi)
    live, _ = _fill(rng, j, t0, multi)
    t = bruteforce_from_state(export_state(j), device="cpu")
    assert t.index_size == j.index_size and t.index_label_count == j.index_label_count
    state_j, state_t = export_state(j), export_state(t)
    assert state_t["labels"] == state_j["labels"] and state_t["count"] == state_j["count"]
    for n, a in state_j["arrays"].items():
        assert np.array_equal(state_t["arrays"][n], a), n
    q = unit_rows(rng, 4, DIM)
    _same_replies(t.topk_query_batch(q, 10), j.topk_query_batch(q, 10), exact=False)
    # Both keep working alike after the hand-over.
    v = unit_rows(rng, 1, DIM)[0]
    for idx in (j, t):
        idx.delete_vector(live[0])
        idx.add_vector(v, 99_999)
    _same_replies(t.topk_query_batch(q, 10), j.topk_query_batch(q, 10), exact=False)


def test_unported_algorithms_raise():
    """Every algorithm is ported, and since the persistence slice so is the
    host-orchestrated construction: with ``config.graph_build_device`` off,
    SVS and the tiered SVS backend build on the CPU, the same graph as the
    JAX package's host build."""
    rows = unit_rows(np.random.default_rng(8), 12, DIM)
    for tiered in (False, True):
        built = []
        for types, create, cfg in ((jt, jcreate, jconfig), (tt, tcreate, tconfig)):
            svs = types.VecSimParams(algo=types.VecSimAlgo.SVS,
                                     svsParams=types.SVSParams(dim=DIM, graph_max_degree=8))
            params = svs if not tiered else types.VecSimParams(
                algo=types.VecSimAlgo.TIERED,
                tieredParams=types.TieredIndexParams(primaryIndexParams=svs))
            idx = create(params) if cfg is jconfig else create(params, device="cpu")
            target = idx.backend if tiered else idx
            assert host_add(target, cfg, rows, list(range(12))) == 12
            built.append(target)
        assert_same_graph(*built)
        assert built[1].index_size == 12 and not built[1]._host_links_stale


def _plain(x):
    """A dataclass tree with its enums as ints, for comparing packages."""
    if dataclasses.is_dataclass(x):
        return {f.name: _plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    return int(x) if isinstance(x, enum.Enum) else x


@pytest.mark.parametrize("dim", [64, 200, 512, 768, 1024])
def test_adhoc_policy_and_info_match(dim, monkeypatch):
    j, t = _pair("IP", False)
    for idx in (j, t):
        monkeypatch.setattr(idx, "dim", dim)
    for size in (5000, 100_000, 500_000, 2_000_000):
        for cls in (type(j), type(t)):
            monkeypatch.setattr(cls, "index_size", property(lambda s, n=size: n))
            monkeypatch.setattr(cls, "index_label_count", property(lambda s, n=size: n))
        for frac in (0.05, 0.2, 0.3, 0.4, 0.6, 0.7, 0.9):
            for initial in (False, True):
                sub = int(frac * size)
                assert t.prefer_adhoc_search(sub, 10, initial) == \
                    j.prefer_adhoc_search(sub, 10, initial)
                assert int(t.last_mode) == int(j.last_mode)
    info_j, info_t = _plain(j.debug_info()), _plain(t.debug_info())
    for info in (info_j, info_t):
        info["commonInfo"].pop("memory")  # each package counts its own buffers
    assert info_t == info_j
    assert _plain(t.basic_info()) == _plain(j.basic_info())
