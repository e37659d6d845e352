"""The float64 reference against a brute NumPy sort and the integer Cosine,
and its TF32 and fp16 controls."""

import numpy as np
import pytest
import torch

from portbench.reference import Reference, control_precision, lex_smallest, to_tf32


def _numpy_topk(rows, queries, k):
    x = rows.astype(np.float64)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    q = queries.astype(np.float64)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    d = 1.0 - q @ x.T
    ids = np.arange(len(rows))
    order = np.stack([np.lexsort((ids, row))[:k] for row in d])
    return np.take_along_axis(d, order, 1), order


@pytest.mark.parametrize("row_block", [7, 64, 1 << 17])
def test_exact_topk_orders_ties_by_row(row_block):
    rng = np.random.default_rng(3)
    rows = rng.standard_normal((200, 24)).astype(np.float32)
    rows[150:] = rows[10]  # fifty-one rows tied with row 10 at every query
    rows[60] = 2.5 * rows[11]  # a tie of distance after normalisation
    queries = np.concatenate([rows[[10, 11, 3]], rng.standard_normal((5, 24)).astype(np.float32)])
    ref = Reference(rows, "cpu", row_block=row_block, query_block=3)
    for k in (1, 10, 60):
        d, i = ref.topk(queries, k)
        want_d, want_i = _numpy_topk(rows, queries, k)
        np.testing.assert_array_equal(i, want_i)
        np.testing.assert_allclose(d, want_d, rtol=0, atol=1e-12)


def test_lex_smallest_takes_lowest_positions_of_a_tie():
    d = torch.tensor([[3.0, 1.0, 1.0, 1.0, 0.5, 1.0]])
    vals, pos = lex_smallest(d, 3)
    assert pos.tolist() == [[4, 1, 2]]
    assert vals.tolist() == [[0.5, 1.0, 1.0]]


def test_distances_are_those_of_the_rows_named():
    rng = np.random.default_rng(4)
    rows = rng.standard_normal((50, 16)).astype(np.float32)
    q = rng.standard_normal((3, 16)).astype(np.float32)
    ref = Reference(rows, "cpu")
    which = np.asarray([[0, 5, 49], [7, 7, 1], [2, 3, 4]])
    got = ref.distances(q, which, block=4)
    x = rows / np.linalg.norm(rows.astype(np.float64), axis=1, keepdims=True)
    qq = q / np.linalg.norm(q.astype(np.float64), axis=1, keepdims=True)
    want = 1.0 - np.einsum("bd,bjd->bj", qq, x[which])
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_tf32_keeps_ten_mantissa_bits_rounded_to_nearest():
    x = torch.tensor([1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-11, 1.0 + 2.0**-12, -(1.0 + 3 * 2.0**-11)])
    assert to_tf32(x).tolist() == [1.0, 1.0 + 2.0**-10, 1.0 + 2.0**-10, 1.0, -(1.0 + 2.0**-9)]


def _int8(rng, shape):
    return rng.integers(-127, 128, size=shape).astype(np.int8)


def test_float64_reference_is_the_integer_cosine_on_int8():
    """1 - <q, x> / (|q| |x|): the dot product an exact integer, the norms
    float64 square roots of exact integer sums."""
    rng = np.random.default_rng(5)
    rows, q = _int8(rng, (300, 1024)), _int8(rng, (6, 1024))
    ip = q.astype(np.int64) @ rows.astype(np.int64).T
    norm = lambda a: np.sqrt((a.astype(np.int64) ** 2).sum(axis=1).astype(np.float64))
    want = 1.0 - ip / (norm(q)[:, None] * norm(rows)[None, :])
    ref = Reference(rows, "cpu", row_block=128)
    d, i = ref.topk(q, 300)
    np.testing.assert_allclose(d, np.take_along_axis(want, i, 1), rtol=0, atol=1e-15)
    assert (np.diff(d, axis=1) >= 0).all()
    which = np.tile(np.arange(0, 300, 7), (6, 1))
    np.testing.assert_allclose(ref.distances(q, which), np.take_along_axis(want, which, 1),
                               rtol=0, atol=1e-15)


def test_integer_control_rounds_norms_and_quotient_to_fp16():
    rng = np.random.default_rng(6)
    rows, q = _int8(rng, (200, 1024)), _int8(rng, (4, 1024))
    ip = (q.astype(np.int64) @ rows.astype(np.int64).T).astype(np.float64)
    norm16 = lambda a: np.sqrt((a.astype(np.int64) ** 2).sum(axis=1)).astype(np.float16)
    quot = ip / (norm16(q).astype(np.float64)[:, None] * norm16(rows).astype(np.float64)[None, :])
    want = 1.0 - quot.astype(np.float16).astype(np.float64)
    ref = Reference(rows, "cpu", "int_fp16", row_block=64)
    d, i = ref.topk(q, 200)
    np.testing.assert_array_equal(d, np.take_along_axis(want, i, 1))
    exact = Reference(rows, "cpu").distances(q, i)
    assert np.abs(d - exact).max() > 1e-5  # fp16 steps of 2^-11 near a cosine of 1
    assert (control_precision("INT8"), control_precision("FLOAT32")) == ("int_fp16", "tf32")
