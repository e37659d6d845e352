"""The HNSW write path and the tiered index on the card against the same
sequences on the CPU.

Every test here needs an NVIDIA card and skips elsewhere. The file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/port/test_torch_tiered_cuda.py -q

A graph built on the CPU is carried to the card (``convert``), and both
copies take the same eager deletes, overwrites (at most 8 labels, and more:
the bulk branch) and ``mark_delete`` + ``delete_tombstoned_bulk``. Int8 L2
arithmetic is exact on both devices, so there the graphs stay equal row for
row and the replies are equal; fp32 Cosine replies (bf16 navigation shadow
off, ef 200 over 600 rows) have equal ids and distances within 1e-5. An
index built by ``bulk_build_device`` on the card (its vectors only on the
card) takes the same writes as its CPU copy. A tiered int8 index on the
card, fed through a stalled job queue, answers from its flat tier with the
group-min kernel K1 (its launch counters rise), then migrates, deletes and
collects its tombstones as the CPU's does.
"""

import threading

import numpy as np
import pytest
import torch

from torch_port_common import TOL, assert_replies_parity, unit_rows
from vectorsimilarity_tpu_torch import config
from vectorsimilarity_tpu_torch import types as T
from vectorsimilarity_tpu_torch.convert import export_hnsw_state, hnsw_from_state
from vectorsimilarity_tpu_torch.indexes.factory import create_index
from vectorsimilarity_tpu_torch.indexes.hnsw import HNSWIndex
from vectorsimilarity_tpu_torch.ops.kernels.bf_topk import group_min_scores
from vectorsimilarity_tpu_torch.utils.thread_pool import JobQueueThreadPool

pytestmark = pytest.mark.cuda

N, D, K = 600, 32, 10
LANES = {"s8": (T.VecSimType.INT8, "L2"), "f32": (T.VecSimType.FLOAT32, "Cosine")}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _rows(rng, n, lane):
    if lane == "s8":
        return rng.integers(-128, 128, size=(n, D)).astype(np.int8)
    return unit_rows(rng, n, D)


def _hnsw_params(lane):
    vtype, metric = LANES[lane]
    return T.HNSWParams(type=vtype, dim=D, metric=T.VecSimMetric[metric], M=8,
                        efConstruction=48, efRuntime=20)


def _query_params(ef=200):
    p = T.VecSimQueryParams()
    p.hnswRuntimeParams.efRuntime = ef
    return p


def _graph(idx):
    st = export_hnsw_state(idx)
    keep = ("label", "level", "upper_row", "links0", "nlinks0", "flags")
    return ({n: st["arrays"][n] for n in keep}, st["upper"]["arrays"],
            (st["entry_id"], st["max_level"], st["count"]), st["labels"])


def _assert_same_graph(a, b):
    ga, gb = _graph(a), _graph(b)
    assert ga[2:] == gb[2:]
    for x, y in zip(ga[:2], gb[:2]):
        for name in x:
            assert np.array_equal(x[name], y[name]), name


def _writes(idx, new):
    """The write sequence; returns what each write returned."""
    entry = int(idx.store.host["label"][idx.entry_id])
    out = [idx.delete_vector(lab) for lab in (5, entry, 77, N - 1)]
    out.append(idx.add_vector_batch(new[:4], [10, 11, 12, 5000]))  # eager overwrite
    out.append(idx.add_vector_batch(new[4:16], list(range(20, 30)) + [6000, 6001]))
    ids = []
    for lab in range(100, 240, 10):
        ids += idx.mark_delete(lab)
    out.append(idx.delete_tombstoned_bulk(ids))
    return out


@pytest.mark.parametrize("lane", list(LANES))
def test_hnsw_writes_on_card_match_cpu(card, lane, monkeypatch):
    monkeypatch.setattr(config, "search_nav_bf16", False)
    rng = np.random.default_rng(1)
    x, new, q = _rows(rng, N, lane), _rows(rng, 16, lane), _rows(rng, 33, lane)
    cpu = HNSWIndex(_hnsw_params(lane), device="cpu")
    cpu.add_vector_batch(x, range(N))
    gpu = hnsw_from_state(export_hnsw_state(cpu), device=card)
    assert _writes(gpu, new) == _writes(cpu, new)
    assert gpu.store.device_arrays()["links0"].device == card
    tol = 0 if lane == "s8" else TOL
    if lane == "s8":
        _assert_same_graph(gpu, cpu)
    assert_replies_parity(gpu.topk_query_batch(q, K, _query_params()),
                          cpu.topk_query_batch(q, K, _query_params()), tol)
    # Each overwritten label's new vector finds its label first.
    labels = [10, 11, 12] + list(range(20, 30))
    mine = gpu.topk_query_batch(np.concatenate([new[:3], new[4:14]]), 1, _query_params())
    assert [int(r.ids[0]) for r in mine] == labels


def test_bulk_built_on_card_takes_writes_like_its_cpu_copy(card, monkeypatch):
    monkeypatch.setattr(config, "search_nav_bf16", False)
    rng = np.random.default_rng(2)
    x, new, q = _rows(rng, N, "f32"), _rows(rng, 16, "f32"), _rows(rng, 33, "f32")
    gpu = HNSWIndex(_hnsw_params("f32"), device=card)
    gpu.bulk_build_device(torch.from_numpy(x).to(card), batch=128, scan_batches=2)
    cpu = hnsw_from_state(export_hnsw_state(gpu), device="cpu")
    gpu.store.host["data"][:] = np.nan  # the card's copy is the only one again
    gpu.store.mark_host_stale("data")
    assert _writes(gpu, new) == _writes(cpu, new)
    assert "data" in gpu.store._host_stale
    assert_replies_parity(gpu.topk_query_batch(q, K, _query_params()),
                          cpu.topk_query_batch(q, K, _query_params()), TOL)
    rows = gpu.store.device_arrays()["data"][: gpu.store.count].cpu().numpy()
    assert np.allclose(rows, cpu.store.device_arrays()["data"][: cpu.store.count].numpy(),
                       atol=1e-6)


def _tiered(device, pool):
    primary = T.VecSimParams(algo=T.VecSimAlgo.HNSWLIB, hnswParams=_hnsw_params("s8"))
    params = T.TieredIndexParams(primaryIndexParams=primary, jobQueue=pool,
                                 submitCb=pool.submit_cb,
                                 tieredHnswParams=T.TieredHNSWParams(swapJobThreshold=20))
    return create_index(T.VecSimParams(algo=T.VecSimAlgo.TIERED, tieredParams=params),
                        device=device)


def test_tiered_ingest_delete_gc_on_card_match_cpu(card):
    rng = np.random.default_rng(3)
    x, q = _rows(rng, 256, "s8"), _rows(rng, 33, "s8")
    runs = {}
    for dev in ("cpu", card):
        pool = JobQueueThreadPool(1)
        gate = threading.Event()
        try:
            idx = _tiered(dev, pool)
            idx.backend.add_vector_batch(x[:128], range(128))
            pool.submit_cb(None, None, [None], [lambda _: gate.wait(60)])  # stall
            for i in range(128, 256):
                idx.add_vector(x[i], i)
            k1 = group_min_scores.launches + group_min_scores.tc_launches
            flat = idx.topk_query_batch(q, K, _query_params())
            k1 = group_min_scores.launches + group_min_scores.tc_launches - k1
            gate.set()
            assert pool.wait_for_quiescence(120)
            assert idx.frontend.index_size == 0 and idx.backend.index_size == 256
            migrated = idx.topk_query_batch(q, K, _query_params())
            for lab in range(0, 200, 10):  # the 20th tombstone runs the GC
                idx.delete_vector(lab)
            assert idx.backend.num_marked_deleted == 0 and idx.backend.index_size == 236
            runs[str(dev)] = (idx, k1, flat, migrated, idx.topk_query_batch(q, K, _query_params()))
        finally:
            gate.set()
            pool.shutdown()
    cpu, gpu = runs["cpu"], runs[str(card)]
    assert gpu[1] > 0 and cpu[1] == 0  # K1 answered the flat tier on the card only
    for got, want in zip(gpu[2:], cpu[2:]):
        assert_replies_parity(got, want, 0)
    _assert_same_graph(gpu[0].backend, cpu[0].backend)
    assert gpu[0].backend.store.device_arrays()["links0"].device == card
