"""The port's fused top-k engine (kernel K3 and its host part ``topk_fused``)
against the JAX package's ``pallas_topk`` in interpret mode.

On the CPU the engine runs the kernel's plain version ``fused_topk_ref``; the
kernel itself is held against that plain version on the card by
``test_torch_bf_topk_cuda.py`` and ``chip_smoke.py``. The cases mirror
``tests/test_pallas_topk.py``. Tolerances: the float lanes sum in fp32 on
both sides in different orders (the JAX fp32 lane scores in bf16_3x), so
distances within 1e-5 and ids equal except at near-ties; the integer lanes
are exact on both sides and must be equal (Cosine rounds one fp32 divide:
1e-6).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import assert_topk_parity, np_of, unit_rows
from vectorsimilarity_tpu.ops.pallas.bf_topk import pallas_topk
from vectorsimilarity_tpu.types import VecSimMetric as JM
from vectorsimilarity_tpu_torch.ops.kernels import bf_topk as bfk
from vectorsimilarity_tpu_torch.types import VecSimMetric as TM

T = torch.from_numpy


def _both(q, x, aux, count, k, metric, tile_n, *, qn=None, group_n=512, jdtype=None,
          tdtype=None):
    """(port result, JAX result) of the fused engine on the same inputs."""
    cast_j = (lambda a: jnp.asarray(a)) if jdtype is None else (lambda a: jnp.asarray(a, jdtype))
    cast_t = (lambda a: T(a)) if tdtype is None else (lambda a: T(a).to(tdtype))
    ref = pallas_topk(cast_j(q), cast_j(x), None if aux is None else jnp.asarray(aux),
                      jnp.int32(count), k, metric=JM[metric], tile_n=tile_n, interpret=True,
                      query_norms=None if qn is None else jnp.asarray(qn), group_n=group_n)
    got = bfk.topk_fused(cast_t(q), cast_t(x), None if aux is None else T(aux), count, k,
                         metric=TM[metric], query_norms=None if qn is None else T(qn))
    assert got[0].dtype == torch.float32 and got[1].dtype == torch.int64
    return got, ref


def _ints(rng, n, d, dtype):
    lo, hi = (-127, 128) if dtype == np.int8 else (0, 256)
    return rng.integers(lo, hi, size=(n, d)).astype(dtype)


def _norms(a):
    return np.sqrt((a.astype(np.int64) ** 2).sum(1).astype(np.float32))


@pytest.mark.parametrize("metric", ["Cosine", "L2"])
def test_parity_small_k(metric):
    rng = np.random.default_rng(0)
    x, q = unit_rows(rng, 512, 48), unit_rows(rng, 8, 48)
    sqn = (x * x).sum(1) if metric == "L2" else None
    (d, i), (rd, ri) = _both(q, x, sqn, 512, 10, metric, 128)
    assert_topk_parity(d, i, rd, ri)


def test_count_masking():
    rng = np.random.default_rng(1)
    x, q = unit_rows(rng, 256, 32), unit_rows(rng, 4, 32)
    (d, i), (rd, ri) = _both(q, x, None, 100, 8, "Cosine", 64)
    assert int(np_of(i).max()) < 100
    assert_topk_parity(d, i, rd, ri)


def test_k_exceeds_count():
    rng = np.random.default_rng(2)
    x, q = unit_rows(rng, 128, 32), unit_rows(rng, 4, 32)
    (d, i), (rd, ri) = _both(q, x, None, 10, 16, "Cosine", 64)
    assert (np_of(i)[:, 10:] == -1).all() and np.isinf(np_of(d)[:, 10:]).all()
    assert_topk_parity(d, i, rd, ri)


def test_multipass_large_k():
    # k > 128 chains passes on the lexicographic lower bound.
    rng = np.random.default_rng(3)
    x, q = unit_rows(rng, 512, 32), unit_rows(rng, 4, 32)
    (d, i), (rd, ri) = _both(q, x, None, 512, 200, "Cosine", 128)
    assert_topk_parity(d, i, rd, ri)
    assert (np.diff(np_of(d), axis=1) >= 0).all()
    assert all(len(set(row)) == 200 for row in np_of(i).tolist())


@pytest.mark.parametrize("k,tile_n,copies", [(140, 64, 16), (64, 128, 64)])
def test_duplicate_vectors_tie_order(k, tile_n, copies):
    # Every vector repeated: exact distance ties inside a pass and across the
    # pass boundary must come out lower id first, none dropped or repeated.
    # (The second case is test_group_duplicate_ties_exactness.)
    rng = np.random.default_rng(4)
    base = unit_rows(rng, 8, 16)
    x, q = np.tile(base, (copies, 1)), base[:2]
    n = len(x)
    (d, i), (rd, ri) = _both(q, x, None, n, k, "Cosine", tile_n, group_n=32)
    want = min(k, n)
    assert all(len(set(row[:want])) == want for row in np_of(i).tolist())
    assert_topk_parity(d, i, rd, ri)
    # Exactly the lex order of the port's own fp32 scores, lower id first.
    s = 1.0 - T(q) @ T(x).T
    order = np.lexsort((np.broadcast_to(np.arange(n), s.shape), s.numpy()), axis=1)[:, :want]
    assert np.array_equal(np_of(i)[:, :want], order)


def test_group_repair_collisions():
    # All of the true top-k sit 64 rows apart in one tile (one strided group
    # of the JAX kernel's compact view); every planted id must be found.
    rng = np.random.default_rng(21)
    n, d, b, k, g = 512, 32, 4, 8, 64
    x, q = unit_rows(rng, n, d), unit_rows(rng, b, d)
    for t in range(k):
        v = q[t % b] + 1e-4 * rng.standard_normal(d).astype(np.float32)
        x[t * g] = v / np.linalg.norm(v)
    (dd, ii), (rd, ri) = _both(q, x, None, n, k, "Cosine", 512, group_n=g)
    assert_topk_parity(dd, ii, rd, ri)
    for b_i in range(b):
        planted = {t * g for t in range(k) if t % b == b_i}
        assert planted <= set(np_of(ii)[b_i].tolist())


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_bf16_store_native_lane(dtype):
    rng = np.random.default_rng(5)
    x, q = unit_rows(rng, 256, 32), unit_rows(rng, 4, 32)
    (d, i), (rd, ri) = _both(q, x, None, 256, 8, "Cosine", 64, jdtype=getattr(jnp, dtype),
                             tdtype=getattr(torch, dtype))
    assert_topk_parity(d, i, rd, ri)


@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_int8_lane_parity(metric):
    rng = np.random.default_rng(10)
    x, q = _ints(rng, 512, 64, np.int8), _ints(rng, 4, 64, np.int8)
    (d, i), (rd, ri) = _both(q, x, None, 512, 10, metric, 128)
    assert np.array_equal(np_of(d), np_of(rd)) and np.array_equal(np_of(i), np_of(ri))


def test_int8_cosine_parity():
    rng = np.random.default_rng(11)
    x, q = _ints(rng, 512, 64, np.int8), _ints(rng, 4, 64, np.int8)
    (d, i), (rd, ri) = _both(q, x, _norms(x), 512, 10, "Cosine", 128, qn=_norms(q))
    assert_topk_parity(d, i, rd, ri, 1e-6)


@pytest.mark.parametrize("metric", ["L2", "IP"])
def test_uint8_lane_parity(metric):
    rng = np.random.default_rng(30)
    x, q = _ints(rng, 512, 64, np.uint8), _ints(rng, 4, 64, np.uint8)
    (d, i), (rd, ri) = _both(q, x, None, 512, 10, metric, 128)
    assert np.array_equal(np_of(d), np_of(rd)) and np.array_equal(np_of(i), np_of(ri))


def test_uint8_cosine_parity():
    rng = np.random.default_rng(31)
    x, q = _ints(rng, 512, 64, np.uint8), _ints(rng, 4, 64, np.uint8)
    (d, i), (rd, ri) = _both(q, x, _norms(x), 512, 10, "Cosine", 128, qn=_norms(q))
    assert_topk_parity(d, i, rd, ri, 1e-6)


def test_uint8_count_masking_multipass():
    # Integer lanes stay exact across the chained passes' lower bound.
    rng = np.random.default_rng(32)
    x, q = _ints(rng, 512, 32, np.uint8), _ints(rng, 2, 32, np.uint8)
    (d, i), (rd, ri) = _both(q, x, None, 300, 150, "L2", 256, group_n=64)
    assert int(np_of(i).max()) < 300
    assert np.array_equal(np_of(d), np_of(rd)) and np.array_equal(np_of(i), np_of(ri))


def test_fused_pass_takes_a_lower_bound():
    # One pass above a bound equals the tail of a longer pass.
    rng = np.random.default_rng(6)
    x, q = T(_ints(rng, 300, 16, np.int8)), T(_ints(rng, 3, 16, np.int8))
    d, i = bfk.fused_topk(q, x, None, 280, 60, metric=TM.L2)
    lo = (d[:, 19].contiguous(), i[:, 19].contiguous())
    d2, i2 = bfk.fused_topk(q, x, None, 280, 40, metric=TM.L2, lo=lo)
    assert torch.equal(d2, d[:, 20:]) and torch.equal(i2, i[:, 20:])
    assert i.dtype == torch.int32


def test_fused_wrapper_rejects_what_it_cannot_launch():
    rng = np.random.default_rng(0)
    x, q = T(unit_rows(rng, 128, 8)), T(unit_rows(rng, 2, 8))
    before = bfk.fused_topk.launches
    with pytest.raises(ValueError, match="CUDA"):
        bfk.fused_topk(q.to("meta"), x.to("meta"), None, 128, 8, metric=TM.IP)
    with pytest.raises(ValueError):
        bfk.fused_topk(q, x, None, 128, 129, metric=TM.IP)  # one pass holds 128
    with pytest.raises(TypeError):
        bfk.fused_topk(q.double(), x.double(), None, 128, 8, metric=TM.IP)
    with pytest.raises(TypeError):
        bfk.fused_topk(q, x.to(torch.bfloat16), None, 128, 8, metric=TM.IP)
    with pytest.raises(ValueError):
        bfk.fused_topk(q, x, None, 128, 8, metric=TM.L2)  # L2 needs sqnorms
    with pytest.raises(TypeError):
        bfk.fused_topk(q, x, None, 128, 8, metric=TM.IP,
                       lo=(torch.zeros(2), torch.zeros(2)))  # ids must be int32
    wide = torch.zeros((2, 40000), dtype=torch.uint8)
    with pytest.raises(ValueError, match="int32"):
        bfk.fused_topk(wide, wide, None, 2, 1, metric=TM.IP)
    assert bfk.fused_topk.launches == before


@pytest.mark.parametrize("dtype,dim,admit", [
    (torch.float32, 40, True), (torch.float32, 37, False), (torch.float16, 64, True),
    (torch.bfloat16, 36, False), (torch.int8, 48, True), (torch.int8, 40, False),
    (torch.uint8, 16, True), (torch.float64, 64, False)])
def test_fused_tc_admits_row_widths_and_types(dtype, dim, admit):
    # The tensor-core K3 loads rows by TMA: a row of a multiple of 16 bytes,
    # in a type with a scoring lane.
    q, x = torch.zeros((3, dim), dtype=dtype), torch.zeros((10, dim), dtype=dtype)
    assert bfk.fused_tc_admits(q, x) is admit


def test_fused_tc_admits_refuses_an_unaligned_view():
    x, q = torch.zeros((11, 64), dtype=torch.bfloat16), torch.zeros((3, 64), dtype=torch.bfloat16)
    assert bfk.fused_tc_admits(q, x[1:])  # a whole row in: 128 bytes, aligned
    off = x.flatten()[1:1 + 10 * 64].view(10, 64)  # 2 bytes in
    assert off.is_contiguous() and not bfk.fused_tc_admits(q, off)
    assert bfk.fused_tc_admits(q.flatten()[8:8 + 2 * 64].view(2, 64), x)  # 16 bytes in
    assert not bfk.fused_tc_admits(q.flatten()[4:4 + 2 * 64].view(2, 64), x)  # 8 bytes in


@pytest.mark.parametrize("B,live,sms", [
    (1024, 1_000_000, 132), (1, 70_000, 132), (130, 20_000, 132), (7, 100, 132), (1, 0, 132),
    (5000, 3_000_000, 132), (64, 128_001, 114)])
def test_fused_tc_range_planner(B, live, sms):
    # Ranges are whole 128-row sub-tiles (so a row always lands in the same
    # column and scores the same in every pass), cover the live rows with no
    # empty range, and the grid is one wave of blocks of 64 queries.
    rows, n = bfk._fused_tc_ranges(B, live, sms)
    assert rows % 128 == 0 and rows >= 1024 and n >= 1
    assert n * rows >= live and (n - 1) * rows < max(live, 1)
    qblocks = -(-B // 64)
    assert n * qblocks <= max(sms, qblocks)
    if (B, live) == (1024, 1_000_000):
        assert (rows, n) == (125_056, 8)  # the headline: 16 query blocks x 8 ranges
