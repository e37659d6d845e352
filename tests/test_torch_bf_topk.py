"""The port's group-min engine (kernel K1 and its host part) against the JAX
package's ``pallas_topk_gm`` / ``pallas_topk_gm_exact`` in interpret mode.

On the CPU the engine runs the kernel's plain version
``group_min_scores_ref``; the kernel itself is held against that plain
version on the card by ``test_torch_bf_topk_cuda.py`` and ``chip_smoke.py``.
Tolerances: fp32 on both sides in different summation orders (the JAX
kernel scores in bf16_3x), so distances within 1e-5 and ids equal except at
near-ties.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import TOL, assert_topk_parity, np_of, unit_rows
from vectorsimilarity_tpu.ops.pallas.bf_topk import pallas_topk_gm, pallas_topk_gm_exact
from vectorsimilarity_tpu.types import VecSimMetric as JM
from vectorsimilarity_tpu_torch.ops.kernels import bf_topk as bfk
from vectorsimilarity_tpu_torch.types import VecSimMetric as TM

T = torch.from_numpy
TILE, G = 64, 16  # L = 4 rows per group


def _gm_model(q, x, count, metric, tile_n, g):
    """float64 numpy model of the strided group minima."""
    q64, x64 = q.astype(np.float64), x.astype(np.float64)
    ip = q64 @ x64.T
    if metric == "L2":
        s = (q64 * q64).sum(1)[:, None] - 2 * ip + (x64 * x64).sum(1)[None, :]
    else:
        s = 1.0 - ip
    s[:, count:] = np.inf
    B, N = s.shape
    return s.reshape(B, N // tile_n, tile_n // g, g).min(axis=2).reshape(B, -1)


def _sqn(x, metric):
    return (x * x).sum(1) if metric == "L2" else None


@pytest.mark.parametrize("metric", ["L2", "IP", "Cosine"])
@pytest.mark.parametrize("count", [256, 201, 64])
def test_group_min_ref_matches_float64_model(metric, count):
    rng = np.random.default_rng(count)
    x, q = unit_rows(rng, 256, 24), unit_rows(rng, 5, 24)
    sqn = _sqn(x, metric)
    got = bfk.group_min_scores(T(q), T(x), None if sqn is None else T(sqn), count,
                               metric=TM[metric], tile_n=TILE, group_n=G)
    want = _gm_model(q, x, count, metric, TILE, G)
    assert got.shape == (5, (256 // TILE) * G) and got.dtype == torch.float32
    assert np.array_equal(np.isinf(np_of(got)), np.isinf(want))
    fin = np.isfinite(want)
    assert np.abs(np_of(got)[fin] - want[fin]).max() <= TOL


@pytest.mark.parametrize("metric,count", [("Cosine", 1024), ("L2", 1000), ("IP", 777)])
def test_gm_engine_matches_pallas_gm(metric, count):
    rng = np.random.default_rng(11)
    x, q = unit_rows(rng, 1024, 32), unit_rows(rng, 6, 32)
    sqn = _sqn(x, metric)
    k = 10
    rd, ri, ru = pallas_topk_gm(jnp.asarray(q), jnp.asarray(x),
                                None if sqn is None else jnp.asarray(sqn), jnp.int32(count), k,
                                metric=JM[metric], tile_n=128, group_n=G, interpret=True)
    d, i, u = bfk.topk_gm(T(q), T(x), None if sqn is None else T(sqn), count, k,
                          metric=TM[metric], tile_n=128, group_n=G)
    assert np.array_equal(np_of(u), np_of(ru)) and not np_of(u).any()
    assert_topk_parity(d, i, rd, ri)
    assert int(np_of(i).max()) < count


def test_gm_engine_recovers_hidden_group_members():
    # The 8 nearest rows sit in two groups ({0,16,32,48} and {1,17,33,49}
    # with tile_n=64, G=16): one group minimum hides three true neighbours,
    # which the member rescore must bring back.
    d = 32
    rng = np.random.default_rng(16)
    x = unit_rows(rng, 128, d)
    q = x[0:1].copy()
    for rank, rid in enumerate([0, 16, 32, 48, 1, 17, 33, 49]):
        v = q[0] + (rank + 1) * 1e-3 * rng.standard_normal(d).astype(np.float32)
        x[rid] = v / np.linalg.norm(v)
    x[0] = q[0]
    rd, ri, ru = pallas_topk_gm(jnp.asarray(q), jnp.asarray(x), None, jnp.int32(128), 8,
                                metric=JM.Cosine, tile_n=TILE, group_n=G, interpret=True)
    dd, ii, uu = bfk.topk_gm(T(q), T(x), None, 128, 8, metric=TM.Cosine, tile_n=TILE,
                             group_n=G)
    assert not np_of(uu).any() and not np_of(ru).any()
    assert sorted(np_of(ii)[0].tolist()) == [0, 1, 16, 17, 32, 33, 48, 49]
    assert_topk_parity(dd, ii, rd, ri)


def _all_ties():
    base = np.full((1, 32), 32 ** -0.5, np.float32)
    return np.tile(base, (2, 1)), np.tile(base, (256, 1))


def test_gm_engine_flags_all_ties_uncovered():
    q, x = _all_ties()
    _, _, ru = pallas_topk_gm(jnp.asarray(q), jnp.asarray(x), None, jnp.int32(256), 8,
                              metric=JM.Cosine, tile_n=TILE, group_n=G, interpret=True)
    _, _, u = bfk.topk_gm(T(q), T(x), None, 256, 8, metric=TM.Cosine, tile_n=TILE, group_n=G)
    assert np_of(ru).all() and np_of(u).all()


@pytest.mark.parametrize("case", ["covered", "all_ties"])
def test_gm_exact_matches_pallas_gm_exact(case):
    if case == "covered":
        rng = np.random.default_rng(21)
        x, q = unit_rows(rng, 1024, 32), unit_rows(rng, 4, 32)
        n, k, tile_n = 1024, 10, 128
    else:
        (q, x), n, k, tile_n = _all_ties(), 256, 8, TILE
    rd, ri = pallas_topk_gm_exact(jnp.asarray(q), jnp.asarray(x), None, jnp.int32(n), k,
                                  metric=JM.Cosine, kind="float", tile_n=tile_n, group_n=G,
                                  interpret=True)
    before = bfk.topk_gm_exact.fallbacks
    d, i = bfk.topk_gm_exact(T(q), T(x), None, n, k, metric=TM.Cosine, kind="float",
                             tile_n=tile_n, group_n=G)
    assert bfk.topk_gm_exact.fallbacks == before + (case == "all_ties")
    assert_topk_parity(d, i, rd, ri)
    if case == "all_ties":
        assert (np_of(i) == np.arange(k)).all()
        assert np.abs(np_of(d)).max() <= 1e-6


def test_kernel_wrapper_rejects_what_it_cannot_launch():
    rng = np.random.default_rng(0)
    x, q = T(unit_rows(rng, 128, 8)), T(unit_rows(rng, 2, 8))
    kw = dict(metric=TM.IP, tile_n=TILE, group_n=G)
    before = bfk.group_min_scores.launches
    # The launcher takes CUDA tensors only: no plain path behind it.
    with pytest.raises(ValueError, match="CUDA"):
        bfk._run(bfk.group_min_scores, "bf_topk_gm", x, lambda kern, stream: 0)
    # A device that is neither the CPU nor CUDA reaches the launcher and raises.
    with pytest.raises(ValueError, match="CUDA"):
        bfk.group_min_scores(q.to("meta"), x.to("meta"), None, 128, **kw)
    with pytest.raises(TypeError):
        bfk.group_min_scores(q.double(), x.double(), None, 128, **kw)
    with pytest.raises(ValueError):
        bfk.group_min_scores(q, x[:100], None, 100, **kw)  # N not a multiple of tile_n
    with pytest.raises(ValueError):
        bfk.group_min_scores(q, x.T.contiguous().T, None, 128, **kw)  # not contiguous
    with pytest.raises(ValueError):
        bfk.group_min_scores(q, x, None, 128, metric=TM.L2, tile_n=TILE, group_n=G)
    assert bfk.group_min_scores.launches == before
