"""The port's big-k engine (kernel K4 and its host part ``topk_bigk`` /
``topk_bigk_exact``) against the JAX package's ``pallas_topk_bigk`` /
``pallas_topk_bigk_exact`` in interpret mode.

On the CPU the engine runs the kernel's plain version ``tile_topc_ref``; the
kernel itself is held against that plain version on the card by
``test_torch_bf_topk_cuda.py`` and ``chip_smoke.py``. The cases mirror
``tests/test_pallas_topk.py``. Tolerances as in ``test_torch_bf_fused.py``:
float lanes within 1e-5 with ids equal except at near-ties, integer lanes
equal; the ``truncated`` flags must be equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import assert_topk_parity, np_of, unit_rows
from vectorsimilarity_tpu.ops.pallas.bf_topk import pallas_topk_bigk, pallas_topk_bigk_exact
from vectorsimilarity_tpu.types import VecSimMetric as JM
from vectorsimilarity_tpu_torch.ops.kernels import bf_topk as bfk
from vectorsimilarity_tpu_torch.types import VecSimMetric as TM

T = torch.from_numpy


def _both(q, x, aux, count, k, metric, tile_n, local_c):
    ref = pallas_topk_bigk(jnp.asarray(q), jnp.asarray(x),
                           None if aux is None else jnp.asarray(aux), jnp.int32(count), k,
                           metric=JM[metric], tile_n=tile_n, local_c=local_c, interpret=True)
    got = bfk.topk_bigk(T(q), T(x), None if aux is None else T(aux), count, k,
                        metric=TM[metric], tile_n=tile_n, local_c=local_c)
    assert np.array_equal(np_of(got[2]), np_of(ref[2]))  # the truncated flags
    return got, ref


def _one_tile_near(rng):
    """256 rows whose 64 nearest to the query all sit in the first tile."""
    target = unit_rows(rng, 1, 16)
    near = target + 0.01 * rng.standard_normal((64, 16)).astype(np.float32)
    x = np.concatenate([near, rng.standard_normal((192, 16)).astype(np.float32)])
    return target, (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("metric", ["Cosine", "L2"])
def test_bigk_parity(metric):
    rng = np.random.default_rng(6)
    x, q = unit_rows(rng, 2048, 32), unit_rows(rng, 4, 32)
    sqn = (x * x).sum(1) if metric == "L2" else None
    (d, i, t), (rd, ri, _) = _both(q, x, sqn, 2048, 300, metric, 128, 64)
    assert not np_of(t).any()
    assert_topk_parity(d, i, rd, ri)
    assert all(len(set(row)) == 300 for row in np_of(i).tolist())


def test_bigk_truncation_flag_fires():
    q, x = _one_tile_near(np.random.default_rng(7))
    (_, _, t), _ = _both(q, x, None, 256, 40, "Cosine", 64, 16)
    assert np_of(t).all()


def test_bigk_count_mask_and_short_index():
    # Fewer live rows than k: an exact prefix and an (inf, -1) tail. The k-th
    # distance is +inf, so the full first tile counts as truncated on both
    # sides; with c = tile_n the lists still hold every live row.
    rng = np.random.default_rng(8)
    x, q = unit_rows(rng, 512, 32), unit_rows(rng, 2, 32)
    (d, i, t), (rd, ri, _) = _both(q, x, None, 150, 200, "Cosine", 128, 128)
    assert np_of(t).all()
    assert (np_of(i)[:, 150:] == -1).all() and int(np_of(i).max()) < 150
    assert_topk_parity(d, i, rd, ri)


@pytest.mark.parametrize("dtype", [np.int8, np.uint8])
def test_bigk_int8_parity(dtype):
    rng = np.random.default_rng(13)
    lo, hi = (-127, 128) if dtype == np.int8 else (0, 256)
    x = rng.integers(lo, hi, size=(1024, 32)).astype(dtype)
    q = rng.integers(lo, hi, size=(2, 32)).astype(dtype)
    (d, i, t), (rd, ri, _) = _both(q, x, None, 1024, 200, "L2", 128, 64)
    assert not np_of(t).any()
    assert np.array_equal(np_of(d), np_of(rd)) and np.array_equal(np_of(i), np_of(ri))


@pytest.mark.parametrize("case", ["random", "truncated"])
def test_bigk_exact_fused_fallback(case):
    if case == "random":
        rng = np.random.default_rng(22)
        x, q = unit_rows(rng, 1024, 32), unit_rows(rng, 4, 32)
        n, k, tile_n, c = 1024, 192, 128, 32
    else:  # every row identical: each tile fills its 16 slots inside the top-48
        base = np.full((1, 32), 32 ** -0.5, np.float32)
        x, q = np.tile(base, (256, 1)), np.tile(base, (2, 1))
        n, k, tile_n, c = 256, 48, 64, 16
    rd, ri = pallas_topk_bigk_exact(jnp.asarray(q), jnp.asarray(x), None, jnp.int32(n), k,
                                    metric=JM.Cosine, kind="float", tile_n=tile_n, local_c=c,
                                    interpret=True)
    # The port falls back exactly when the JAX flag fires on some query.
    fired = bool(np_of(pallas_topk_bigk(jnp.asarray(q), jnp.asarray(x), None, jnp.int32(n), k,
                                        metric=JM.Cosine, tile_n=tile_n, local_c=c,
                                        interpret=True)[2]).any())
    assert fired or case == "random"
    before = bfk.topk_bigk_exact.fallbacks
    d, i = bfk.topk_bigk_exact(T(q), T(x), None, n, k, metric=TM.Cosine, kind="float",
                               tile_n=tile_n, local_c=c)
    assert bfk.topk_bigk_exact.fallbacks == before + fired
    assert_topk_parity(d, i, rd, ri)
    if case == "truncated":
        assert (np_of(i) == np.arange(k)).all() and np.abs(np_of(d)).max() <= 1e-6


def test_tile_topc_lists_are_each_tiles_own():
    # The kernel's contract below the host part: every tile's c best, in
    # (distance, id) order, ids global, rows past count absent.
    rng = np.random.default_rng(9)
    x, q = unit_rows(rng, 256, 16), unit_rows(rng, 3, 16)
    d, i = bfk.tile_topc(T(q), T(x), None, 200, metric=TM.IP, tile_n=64, c=8)
    assert d.shape == i.shape == (3, 4, 8) and i.dtype == torch.int32
    s = 1.0 - q @ x.T
    s[:, 200:] = np.inf
    for t in range(4):
        tile = s[:, 64 * t:64 * (t + 1)]
        order = np.argsort(tile, axis=1, kind="stable")[:, :8]
        want_d = np.take_along_axis(tile, order, 1)
        assert np.abs(np.where(np.isfinite(want_d), np_of(d[:, t]) - want_d, 0)).max() <= 1e-6
        assert np.array_equal(np_of(i[:, t]), np.where(np.isfinite(want_d), order + 64 * t, -1))


def test_topc_wrapper_rejects_what_it_cannot_launch():
    rng = np.random.default_rng(0)
    x, q = T(unit_rows(rng, 128, 8)), T(unit_rows(rng, 2, 8))
    before = bfk.tile_topc.launches
    kw = dict(metric=TM.IP, tile_n=64)
    with pytest.raises(ValueError, match="CUDA"):
        bfk.tile_topc(q.to("meta"), x.to("meta"), None, 128, c=8, **kw)
    with pytest.raises(ValueError):
        bfk.tile_topc(q, x, None, 128, c=65, **kw)  # c above tile_n
    with pytest.raises(ValueError):
        bfk.tile_topc(q, x[:100], None, 100, c=8, **kw)  # N not a multiple of tile_n
    with pytest.raises(ValueError):
        bfk.topk_bigk(q, x, None, 128, 40, metric=TM.IP, tile_n=64, local_c=16)  # 2 x 16 < 40
    ints = torch.ones((4, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="query_norms"):
        bfk.tile_topc(ints, torch.ones((64, 8), dtype=torch.int8), torch.ones(64), 64, c=8,
                      metric=TM.Cosine, tile_n=64)
    assert bfk.tile_topc.launches == before
