"""The sharded flat scan on the card, over the one-card mesh ``[cuda:0] * 4``.

Every test here needs an NVIDIA card and skips elsewhere. The file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/port/test_torch_sharding_cuda.py -q

- ``sharded_topk`` of fp32 and int8 stores at small odd shapes (B = 7 and
  130, a count that leaves the last shard part full, 8,192 rows a shard with
  tiles of 128 so that k = 500 reaches the per-tile top-c engine): at k =
  10, 100 and 500 the tensor-core K1, K3 and K4 each launch once a shard
  (4 launches), the CUDA-core kernels never, no fallback; the answers equal
  the plain exact scan (``streaming_topk``, IEEE fp32 with TF32 off) over
  the whole store: distances within 1e-5, ids equal except at near-ties;
  int8 L2 equal;
- the sharded flat index (``to_sharded``) answers as the unsharded one,
  ad-hoc hybrid queries included, and holds its rows once on the card;
- ``dryrun_multichip`` with no device named runs on the card;
- ``sharded_topk(kind="sq8")`` against the plain ``streaming_topk`` over
  ``scores_sq8``.
"""

import numpy as np
import pytest
import torch

from vectorsimilarity_tpu_torch import config
from vectorsimilarity_tpu_torch import types as T
from vectorsimilarity_tpu_torch.core.hybrid import hybrid_topk
from vectorsimilarity_tpu_torch.dryrun import dryrun_multichip
from vectorsimilarity_tpu_torch.indexes.factory import create_index
from vectorsimilarity_tpu_torch.ops.distances import streaming_topk
from vectorsimilarity_tpu_torch.ops.kernels import bf_topk as bfk
from vectorsimilarity_tpu_torch.parallel.sharding import make_mesh, sharded_topk

pytestmark = pytest.mark.cuda

TOL = 1e-5
S, SHARD_N, TILE = 4, 8192, 128
KS = {10: "gm", 100: "fused", 500: "topc"}
COUNTERS = {"gm": bfk.group_min_scores, "fused": bfk.fused_topk, "topc": bfk.tile_topc}


@pytest.fixture
def card(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(config, "tile_n", TILE)
    return torch.device("cuda:0")


def _rows(dev, lane, n, dim, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    if lane == "s8":
        return torch.randint(-128, 128, (n, dim), generator=gen, device=dev, dtype=torch.int8)
    x = torch.randn((n, dim), generator=gen, device=dev)
    return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)


def _norms(x):
    return x.double().square().sum(1).sqrt().float().clamp(min=1.0)


def _assert_topk(d, i, rd, ri, exact):
    d, i, rd, ri = (t.cpu().numpy() for t in (d, i, rd, ri))
    if exact:
        assert np.array_equal(i, ri) and np.array_equal(d, rd)
        return
    assert np.array_equal(np.isfinite(d), np.isfinite(rd))
    fin = np.isfinite(rd)
    assert np.abs(d[fin].astype(np.float64) - rd[fin]).max() <= TOL
    with np.errstate(invalid="ignore"):
        gap = np.abs(np.diff(rd.astype(np.float64), axis=1)) <= TOL
    tied = np.zeros(d.shape, dtype=bool)
    tied[:, 1:] |= gap
    tied[:, :-1] |= gap
    assert ((i == ri) | tied).all()


@pytest.mark.parametrize("B", (7, 130))
@pytest.mark.parametrize("lane,metric", (("f32", "L2"), ("f32", "Cosine"), ("s8", "Cosine"),
                                         ("s8", "L2")))
def test_sharded_scan_launches_per_shard(card, lane, metric, B):
    metric = T.VecSimMetric[metric]
    dim = 40 if lane == "f32" else 48  # rows of 16-byte multiples: the tensor-core kernels
    n = S * SHARD_N
    count = n - 1001
    x = _rows(card, lane, n, dim, 1)
    q = _rows(card, lane, B, dim, 2)
    aux = qn = None
    if lane == "f32" and metric == T.VecSimMetric.L2:
        aux = x.square().sum(1)
    if lane == "s8" and metric == T.VecSimMetric.Cosine:
        aux, qn = _norms(x), _norms(q)
    kind = "float" if lane == "f32" else "int"
    mesh = make_mesh([card] * S)
    for k, engine in KS.items():
        for w in COUNTERS.values():
            w.launches = w.tc_launches = 0
        bfk.topk_gm_exact.fallbacks = bfk.topk_bigk_exact.fallbacks = 0
        d, i = sharded_topk(q, (x, aux), count, k, metric=metric, kind=kind, mesh=mesh,
                            query_norms=qn)
        torch.cuda.synchronize()
        assert {n_: (w.tc_launches, w.launches) for n_, w in COUNTERS.items()} == {
            n_: ((S, 0) if n_ == engine else (0, 0)) for n_ in COUNTERS}
        assert bfk.topk_gm_exact.fallbacks == bfk.topk_bigk_exact.fallbacks == 0
        rd, ri = streaming_topk(q, (x, aux), count, k, metric=metric, kind=kind, chunk=1 << 14,
                                query_norms=qn)
        # Integer L2 is exact; integer Cosine rounds one fp32 divide.
        _assert_topk(d, i, rd, ri, exact=lane == "s8" and metric == T.VecSimMetric.L2)


def test_sharded_flat_index_on_card(card):
    dim, n = 64, 20_000
    x = _rows(card, "f32", n, dim, 3).cpu().numpy()
    q = _rows(card, "f32", 33, dim, 4).cpu().numpy()

    def params():
        return T.VecSimParams(algo=T.VecSimAlgo.BF, bfParams=T.BFParams(
            type=T.VecSimType.FLOAT32, dim=dim, metric=T.VecSimMetric.Cosine))

    sh, ref = create_index(params()), create_index(params())
    sh.to_sharded(make_mesh([card] * S))
    for idx in (sh, ref):
        idx.add_vector_batch(x, list(range(n)))
        for lab in range(0, n, 7):
            idx.delete_vector(lab)
    for k in KS:
        a, b = sh.topk_query_batch(q, k), ref.topk_query_batch(q, k)
        _assert_topk(*(torch.from_numpy(np.stack(v)) for v in (
            [r.scores for r in a], [r.ids for r in a], [r.scores for r in b],
            [r.ids for r in b])), exact=False)
    # A small filter set takes the ad-hoc policy, scored shard by shard.
    filt = list(range(1, n, 211)) + [0]
    a, b = hybrid_topk(sh, q[0], 10, filt), hybrid_topk(ref, q[0], 10, filt)
    assert sh.last_mode == T.VecSearchMode.HYBRID_ADHOC_BF and len(a.ids) == 10
    _assert_topk(*(torch.from_numpy(v[None]) for v in (a.scores, a.ids, b.scores, b.ids)),
                 exact=False)
    # Both device copies synced at the same capacity: one copy of the rows.
    assert sh.memory_bytes == ref.memory_bytes


def test_dryrun_takes_the_card(card):
    dryrun_multichip(S)  # no device named: the current CUDA device


def test_sharded_sq8_scan(card):
    n, dim, B, k = S * SHARD_N, 96, 130, 10
    gen = torch.Generator(device=card).manual_seed(5)
    codes = torch.randint(0, 256, (n, dim), generator=gen, device=card, dtype=torch.uint8)
    vmin = 0.1 * torch.randn(n, generator=gen, device=card)
    delta = 1e-3 + 1e-2 * torch.rand(n, generator=gen, device=card)
    xsumsq = 1.0 + torch.rand(n, generator=gen, device=card)
    q = torch.randn((B, dim), generator=gen, device=card)
    cols = (codes, vmin, delta, xsumsq)
    for metric in (T.VecSimMetric.L2, T.VecSimMetric.IP):
        d, i = sharded_topk(q, cols, n - 333, k, metric=metric, kind="sq8",
                            mesh=make_mesh([card] * S))
        rd, ri = streaming_topk(q, cols, n - 333, k, metric=metric, kind="sq8", chunk=1 << 14)
        _assert_topk(d, i, rd, ri, exact=False)
