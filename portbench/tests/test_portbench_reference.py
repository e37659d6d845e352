"""The float64 reference against a brute NumPy sort, and its TF32 control."""

import numpy as np
import pytest
import torch

from portbench.reference import Reference, lex_smallest, to_tf32


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
