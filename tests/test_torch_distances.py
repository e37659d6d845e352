"""The port's scoring, selection and streaming top-k against the JAX package.

Float lanes: fp32 on both sides in different summation orders, distances
within 1e-5 (unit vectors, as the main path stores them). Integer lanes:
bit-exact distances and ids.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import TOL, assert_topk_parity, np_of, unit_rows
from vectorsimilarity_tpu.ops import distances as jd
from vectorsimilarity_tpu.ops import normalize as jn
from vectorsimilarity_tpu.ops import topk as jk
from vectorsimilarity_tpu.types import VecSimMetric as JM
from vectorsimilarity_tpu.types import VecSimType as JT
from vectorsimilarity_tpu.types import numpy_dtype
from vectorsimilarity_tpu_torch.ops import distances as td
from vectorsimilarity_tpu_torch.ops import normalize as tn
from vectorsimilarity_tpu_torch.ops import topk as tk
from vectorsimilarity_tpu_torch.types import VecSimMetric as TM
from vectorsimilarity_tpu_torch.types import VecSimType as TT

METRICS = ["L2", "IP", "Cosine"]
T = torch.from_numpy


def _int_data(rng, dtype, n, d):
    lo, hi = (-128, 128) if dtype == np.int8 else (0, 256)
    return rng.integers(lo, hi, size=(n, d)).astype(dtype)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("with_sqn", [True, False])
def test_scores_float_matches(metric, with_sqn):
    rng = np.random.default_rng(1)
    q, x = unit_rows(rng, 5, 24), unit_rows(rng, 70, 24)
    sqn = (x * x).sum(1) if with_sqn else None
    ref = jd.scores_float(jnp.asarray(q), jnp.asarray(x), JM[metric],
                          None if sqn is None else jnp.asarray(sqn))
    got = td.scores_float(T(q), T(x), TM[metric], None if sqn is None else T(sqn))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(np_of(got), np_of(ref), atol=TOL, rtol=0)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("dtype", [np.int8, np.uint8])
def test_scores_int_bit_exact(metric, dtype):
    rng = np.random.default_rng(2)
    q, x = _int_data(rng, dtype, 4, 40), _int_data(rng, dtype, 50, 40)
    qn = np.sqrt((q.astype(np.int64) ** 2).sum(1).astype(np.float32))
    xn = np.sqrt((x.astype(np.int64) ** 2).sum(1).astype(np.float32))
    ref = jd.scores_int(jnp.asarray(q), jnp.asarray(x), JM[metric],
                        jnp.asarray(xn), jnp.asarray(qn))
    got = td.scores_int(T(q), T(x), TM[metric], T(xn), T(qn))
    assert np.array_equal(np_of(got), np_of(ref))
    ref = jd.one_to_one(jnp.asarray(q[0]), jnp.asarray(x[1]), JM[metric],
                        jnp.asarray(qn[0]), jnp.asarray(xn[1]))
    got = td.one_to_one(T(q[0]), T(x[1]), TM[metric], qn[0], xn[1])
    assert float(got) == float(ref)


def test_one_to_one_float_matches():
    rng = np.random.default_rng(3)
    a, b = unit_rows(rng, 2, 16)
    for m in METRICS:
        ref = float(jd.one_to_one(jnp.asarray(a), jnp.asarray(b), JM[m]))
        assert abs(float(td.one_to_one(T(a), T(b), TM[m])) - ref) <= TOL


@pytest.mark.parametrize("k", [1, 5, 16, 40])
def test_lex_topk_ties_and_inf_match(k):
    rng = np.random.default_rng(k)
    d = rng.integers(0, 6, size=(6, 40)).astype(np.float32)  # dense ties
    d[rng.random(d.shape) < 0.3] = np.inf
    d[0] = np.inf  # an all-inf row
    rv, rp = jd._lex_topk(jnp.asarray(d), k)
    tv, tp = td._lex_topk(T(d), k)
    assert np.array_equal(np_of(tv), np_of(rv))
    fin = np.isfinite(np_of(rv))
    assert np.array_equal(np_of(tp)[fin], np_of(rp)[fin])
    # finite entries come out in (value, position) order
    top = min(k, 3)
    assert np.array_equal(np_of(tp)[1:, :top], np.argsort(d[1:], axis=1, kind="stable")[:, :top])


def test_merge_topk_matches():
    rng = np.random.default_rng(4)
    bd = np.sort(rng.integers(0, 4, size=(3, 8)).astype(np.float32), axis=1)
    bi = rng.permutation(100)[:24].reshape(3, 8).astype(np.int32)
    nd = rng.integers(0, 4, size=(3, 6)).astype(np.float32)
    ni = (100 + np.arange(18)).reshape(3, 6).astype(np.int32)
    rv, ri = jd._merge_topk(*(jnp.asarray(x) for x in (bd, bi, nd, ni)), 8)
    tv, ti = td._merge_topk(T(bd), T(bi.astype(np.int64)), T(nd), T(ni.astype(np.int64)), 8)
    assert np.array_equal(np_of(tv), np_of(rv)) and np.array_equal(np_of(ti), np_of(ri))


@pytest.mark.parametrize("metric", METRICS)
def test_streaming_topk_float_whole_and_segmented(metric):
    rng = np.random.default_rng(5)
    x, q = unit_rows(rng, 300, 16), unit_rows(rng, 6, 16)
    sqn = (x * x).sum(1) if metric == "L2" else None
    count, k, chunk = 257, 12, 64
    jstore = (jnp.asarray(x), None if sqn is None else jnp.asarray(sqn))
    tstore = (T(x), None if sqn is None else T(sqn))
    rd, ri = jd.streaming_topk(jnp.asarray(q), jstore, jnp.int32(count), k,
                               metric=JM[metric], kind="float", chunk=chunk)
    d, i = td.streaming_topk(T(q), tstore, count, k, metric=TM[metric], kind="float",
                             chunk=chunk)
    assert_topk_parity(d, i, rd, ri)
    # Segments of two chunks, each continuing from the one before.
    jb = tb = None
    for s0 in (0, 2, 4):
        jb = jd.streaming_topk(jnp.asarray(q), jstore, jnp.int32(count), k,
                               metric=JM[metric], kind="float", chunk=chunk,
                               seg_chunks=2, start_chunk=jnp.int32(s0), best_init=jb)
        tb = td.streaming_topk(T(q), tstore, count, k, metric=TM[metric], kind="float",
                               chunk=chunk, seg_chunks=2, start_chunk=s0, best_init=tb)
        assert_topk_parity(tb[0], tb[1], jb[0], jb[1])
    assert_topk_parity(tb[0], tb[1], rd, ri)


@pytest.mark.parametrize("dtype,metric", [(np.int8, "L2"), (np.uint8, "Cosine"), (np.int8, "IP")])
def test_streaming_topk_int_bit_exact(dtype, metric):
    rng = np.random.default_rng(6)
    x, q = _int_data(rng, dtype, 200, 12), _int_data(rng, dtype, 4, 12)
    xn = np.sqrt((x.astype(np.int64) ** 2).sum(1).astype(np.float32))
    qn = np.sqrt((q.astype(np.int64) ** 2).sum(1).astype(np.float32))
    norms = xn if metric == "Cosine" else None
    rd, ri = jd.streaming_topk(jnp.asarray(q), (jnp.asarray(x), None if norms is None
                                                else jnp.asarray(norms)),
                               jnp.int32(190), 9, metric=JM[metric], kind="int", chunk=64,
                               query_norms=jnp.asarray(qn))
    d, i = td.streaming_topk(T(q), (T(x), None if norms is None else T(norms)), 190, 9,
                             metric=TM[metric], kind="int", chunk=64, query_norms=T(qn))
    assert np.array_equal(np_of(d), np_of(rd)) and np.array_equal(np_of(i), np_of(ri))


def test_streaming_topk_unfilled_slots():
    rng = np.random.default_rng(7)
    x, q = unit_rows(rng, 64, 8), unit_rows(rng, 2, 8)
    d, i = td.streaming_topk(T(q), (T(x), None), 5, 8, metric=TM.Cosine, kind="float",
                             chunk=16)
    rd, ri = jd.streaming_topk(jnp.asarray(q), (jnp.asarray(x), None), jnp.int32(5), 8,
                               metric=JM.Cosine, kind="float", chunk=16)
    assert_topk_parity(d, i, rd, ri)
    assert np.isinf(np_of(d)[:, 5:]).all() and (np_of(i)[:, 5:] == -1).all()


@pytest.mark.parametrize("kind", ["float", "int"])
def test_full_scores_matches(kind):
    rng = np.random.default_rng(8)
    if kind == "float":
        x, q = unit_rows(rng, 40, 8), unit_rows(rng, 3, 8)
        js, ts, qn = (jnp.asarray(x), jnp.asarray((x * x).sum(1))), (T(x), T((x * x).sum(1))), None
        metric = "L2"
    else:
        x, q = _int_data(rng, np.int8, 40, 8), _int_data(rng, np.int8, 3, 8)
        js, ts = (jnp.asarray(x), None), (T(x), None)
        qn, metric = None, "IP"
    ref = jd.full_scores(jnp.asarray(q), js, jnp.int32(33), metric=JM[metric], kind=kind)
    got = td.full_scores(T(q), ts, 33, metric=TM[metric], kind=kind)
    np.testing.assert_allclose(np_of(got), np_of(ref), atol=TOL if kind == "float" else 0, rtol=0)


def test_slot_min_and_topk_by_slot_match():
    rng = np.random.default_rng(9)
    scores = rng.integers(0, 5, size=(3, 30)).astype(np.float32)  # ties
    scores[:, 25:] = np.inf
    slots = rng.integers(0, 7, size=30).astype(np.int32)
    slots[27:] = -1
    ref = jk.slot_min_scores(jnp.asarray(scores), jnp.asarray(slots), 8)
    got = tk.slot_min_scores(T(scores), T(slots), 8)
    assert np.array_equal(np_of(got), np_of(ref))
    rv, rs = jk.topk_by_slot(jnp.asarray(scores), jnp.asarray(slots), 8, 6)
    tv, ts = tk.topk_by_slot(T(scores), T(slots), 8, 6)
    assert np.array_equal(np_of(tv), np_of(rv)) and np.array_equal(np_of(ts), np_of(rs))


def test_normalize_functions_match():
    rng = np.random.default_rng(10)
    x = rng.standard_normal((4, 10)).astype(np.float32)
    np.testing.assert_allclose(np_of(tn.normalize_batch(T(x))),
                               np_of(jn.normalize_batch(jnp.asarray(x))), atol=1e-7)
    xi = _int_data(rng, np.int8, 4, 10)
    assert np.array_equal(np_of(tn.int_norms(T(xi))), np_of(jn.int_norms(jnp.asarray(xi))))
    for jtype in (JT.FLOAT32, JT.INT8, JT.UINT8):
        blob = xi[0].astype(numpy_dtype(jtype))
        assert np.array_equal(tn.normalize_blob(blob, TT(int(jtype))),
                              jn.normalize_blob(blob, jtype))
        for m in METRICS:
            assert tn.needs_query_normalize(TT(int(jtype)), TM[m]) == \
                jn.needs_query_normalize(jtype, JM[m])
