"""The HNSW index on the card against the same index on the CPU.

Every test here needs an NVIDIA card and skips elsewhere. The file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/port/test_torch_hnsw_cuda.py -q

A graph is built on the CPU and carried to the card (``convert``), and both
copies answer the same queries: with the bf16 navigation shadow off, ids
are equal (fp32 distances within 1e-5, at near-ties either order; int8
exactly). Int8 arithmetic is exact on both devices, so an int8 build on the
card gives the CPU's graph row for row; an fp32 build differs at near-ties
only (at least 95% of level-0 rows equal as sets).
"""

import numpy as np
import pytest
import torch

from torch_port_common import TOL, assert_replies_parity, unit_rows
from vectorsimilarity_tpu_torch import config
from vectorsimilarity_tpu_torch.convert import export_hnsw_state, hnsw_from_state
from vectorsimilarity_tpu_torch.indexes.hnsw import HNSWIndex
from vectorsimilarity_tpu_torch.ops import graph_search
from vectorsimilarity_tpu_torch.types import HNSWParams, VecSimMetric, VecSimQueryParams, VecSimType

pytestmark = pytest.mark.cuda

N, D, K = 700, 32, 10
LANES = {"f32": VecSimType.FLOAT32, "s8": VecSimType.INT8}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _rows(rng, n, lane):
    if lane == "s8":
        return rng.integers(-128, 128, size=(n, D)).astype(np.int8)
    return unit_rows(rng, n, D)


def _index(lane, metric, device, multi=False):
    params = HNSWParams(type=LANES[lane], dim=D, metric=VecSimMetric[metric], multi=multi,
                        M=8, efConstruction=48, efRuntime=20)
    return HNSWIndex(params, device=device)


def _links_equal_share(a, b):
    sa, sb = export_hnsw_state(a), export_hnsw_state(b)
    la, lb = sa["arrays"]["links0"], sb["arrays"]["links0"]
    return float(np.mean([set(x[x >= 0]) == set(y[y >= 0]) for x, y in zip(la, lb)]))


@pytest.mark.parametrize("lane", list(LANES))
@pytest.mark.parametrize("metric", ["L2", "IP", "Cosine"])
def test_search_on_card_matches_cpu(card, lane, metric, monkeypatch):
    monkeypatch.setattr(config, "search_nav_bf16", False)
    rng = np.random.default_rng(1)
    x, q = _rows(rng, N, lane), _rows(rng, 33, lane)
    cpu = _index(lane, metric, "cpu")
    cpu.add_vector_batch(x, range(N))
    gpu = hnsw_from_state(export_hnsw_state(cpu), device=card)
    assert gpu.store.device_arrays()["links0"].device == card
    tol = 0 if lane == "s8" else TOL
    for ef in (10, 64, 300):  # 300: the 4-wide beam expansion
        p = VecSimQueryParams()
        p.hnswRuntimeParams.efRuntime = ef
        want, got = cpu.topk_query_batch(q, K, p), gpu.topk_query_batch(q, K, p)
        assert_replies_parity(got, want, tol)
    radius = float(np.median([r.scores[5] for r in want]))
    assert_replies_parity([gpu.range_query(q[0], radius)], [cpu.range_query(q[0], radius)], tol)
    it_c, it_g = cpu.new_batch_iterator(q[1]), gpu.new_batch_iterator(q[1])
    for _ in range(3):
        assert_replies_parity([it_g.get_next_results(20)], [it_c.get_next_results(20)], tol)


@pytest.mark.parametrize("lane,metric", [("s8", "L2"), ("s8", "Cosine"), ("f32", "Cosine")])
def test_build_on_card_matches_cpu(card, lane, metric):
    rng = np.random.default_rng(2)
    x = _rows(rng, N, lane)
    built = {}
    for dev in ("cpu", card):
        idx = _index(lane, metric, dev)
        idx.add_vector_batch(x[:512], range(512))  # one connect batch of 512
        idx.add_vector_batch(x[512:], range(512, N))  # 128 + 32 + 16 + 8 + 4
        built[str(dev)] = idx
    cpu, gpu = built["cpu"], built[str(card)]
    assert (gpu.entry_id, gpu.max_level) == (cpu.entry_id, cpu.max_level)
    share = _links_equal_share(cpu, gpu)
    assert share == 1.0 if lane == "s8" else share >= 0.95, share
    assert gpu.build_dropped() == cpu.build_dropped() == 0


def test_bulk_build_on_card(card):
    """``bulk_build_device`` from rows already on the card, against the same
    bulk build on the CPU (fp32 Cosine: near-ties only), and the searches
    with the navigation shadow on reach the CPU's recall."""
    rng = np.random.default_rng(4)
    x, q = unit_rows(rng, 2000, D), unit_rows(rng, 64, D)
    cpu, gpu = _index("f32", "Cosine", "cpu"), _index("f32", "Cosine", card)
    cpu.bulk_build_device(torch.from_numpy(x), batch=256, scan_batches=3)
    before = graph_search.host_reads
    gpu.bulk_build_device(torch.from_numpy(x).to(card), batch=256, scan_batches=3)
    assert graph_search.host_reads > before
    assert _links_equal_share(cpu, gpu) >= 0.95
    truth = np.argsort(1.0 - q @ x.T, axis=1, kind="stable")[:, :K]

    def recall(idx):
        reps = idx.topk_query_batch(q, K)
        return np.mean([len(set(r.ids.tolist()) & set(t.tolist())) / K
                        for r, t in zip(reps, truth)])

    assert recall(gpu) >= recall(cpu) - 0.02
    d, i = gpu.search_knn_device(torch.from_numpy(q).to(card), K, 64)
    assert d.device == card and i.shape == (64, 64)


def test_multi_value_on_card(card):
    rng = np.random.default_rng(5)
    base = unit_rows(rng, 200, D)
    idx = _index("f32", "Cosine", card, multi=True)
    idx.add_vector_batch(np.concatenate([base, base + 0.01 * unit_rows(rng, 200, D)]),
                         list(range(200)) * 2)
    for r in idx.topk_query_batch(unit_rows(rng, 8, D), K):
        assert len(r) == K == len(set(r.ids.tolist()))
