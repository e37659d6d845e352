"""Persistence and the host-orchestrated builds on the card.

Every test here needs an NVIDIA card and skips elsewhere. The file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/port/test_torch_persist_cuda.py -q

- A flat, an HNSW and an SVS (Q4x8) index built on the card are saved
  (``save_index``; HNSW also as a V4 file, SVS also as a folder) and loaded
  back with no ``device``: the stores are on ``cuda:0``, and the replies
  equal the replies before the save (labels equal, distances bit-equal).
- ``load_index`` with no ``device`` raises where there is no CUDA.
- One host-orchestrated build each of HNSW and SVS
  (``config.graph_build_device = False``) runs on the card, keeps its links
  on the host, and answers its own rows.
"""

import numpy as np
import pytest
import torch

from torch_port_common import embedding_rows
from vectorsimilarity_tpu_torch import config
from vectorsimilarity_tpu_torch import types as T
from vectorsimilarity_tpu_torch.indexes.factory import create_index
from vectorsimilarity_tpu_torch.utils import hnsw_file_format as hff
from vectorsimilarity_tpu_torch.utils import svs_file_format as sff
from vectorsimilarity_tpu_torch.utils.serializer import check_integrity, load_index, save_index

pytestmark = pytest.mark.cuda

K = 10
N, DIM = 2048, 64


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _params(algo):
    if algo == "bf":
        return T.VecSimParams(algo=T.VecSimAlgo.BF, bfParams=T.BFParams(
            type=T.VecSimType.FLOAT32, dim=DIM, metric=T.VecSimMetric.Cosine))
    if algo == "hnsw":
        return T.VecSimParams(algo=T.VecSimAlgo.HNSWLIB, hnswParams=T.HNSWParams(
            type=T.VecSimType.FLOAT32, dim=DIM, metric=T.VecSimMetric.Cosine, M=16,
            efConstruction=100, efRuntime=100))
    return T.VecSimParams(algo=T.VecSimAlgo.SVS, svsParams=T.SVSParams(
        type=T.VecSimType.FLOAT32, dim=DIM, metric=T.VecSimMetric.Cosine,
        quantBits=T.VecSimSvsQuantBits.Q4x8, graph_max_degree=32,
        construction_window_size=100, search_window_size=64))


def _same(a, b):
    assert len(a) == len(b)
    for r, s in zip(a, b):
        assert np.array_equal(r.ids, s.ids) and np.array_equal(r.scores, s.scores)


@pytest.mark.parametrize("algo", ["bf", "hnsw", "svs"])
def test_save_and_load_on_the_card(card, tmp_path, algo):
    x = embedding_rows(np.random.default_rng(0), N + 64, DIM)
    data, q = x[:N], x[N:]
    idx = create_index(_params(algo))
    assert idx.store.device.type == "cuda"
    idx.add_vector_batch(data, list(range(N)))
    for lab in (3, 70, 1500):
        idx.delete_vector(lab)
    if algo != "bf":
        idx.mark_delete(9)
    ref = idx.topk_query_batch(q, K)
    path = str(tmp_path / "index.npz")
    save_index(idx, path)
    reloads = [load_index(path)]
    if algo == "hnsw":
        hff.save_hnsw_file(idx, str(tmp_path / "index.v4"))
        reloads.append(hff.load_hnsw_file(str(tmp_path / "index.v4")))
        st = reloads[-1].store
        reloads.append(hff.load_hnsw_file(str(tmp_path / "index.v4"),
                                          idx.store.device_arrays()["data"]))
        assert st.capacity == reloads[-1].store.capacity
    if algo == "svs":
        sff.save_svs_folder(idx, str(tmp_path / "svs"))
        folder = create_index(_params(algo))
        sff.load_svs_folder(folder, str(tmp_path / "svs"))
        reloads.append(folder)
    for back in reloads:
        assert back.store.device == torch.device("cuda", 0)
        assert back.store.device_arrays()["data"].device == torch.device("cuda", 0)
        assert check_integrity(back)
        _same(back.topk_query_batch(q, K), ref)


def test_load_without_cuda_raises(card, tmp_path, monkeypatch):
    idx = create_index(_params("bf"))
    idx.add_vector_batch(embedding_rows(np.random.default_rng(1), 64, DIM), list(range(64)))
    save_index(idx, str(tmp_path / "bf.npz"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_index(str(tmp_path / "bf.npz"))
    assert load_index(str(tmp_path / "bf.npz"), device="cpu").store.device.type == "cpu"


@pytest.mark.parametrize("algo", ["hnsw", "svs"])
def test_host_build_on_the_card(card, monkeypatch, algo):
    x = embedding_rows(np.random.default_rng(2), N, DIM)
    monkeypatch.setattr(config, "graph_build_device", False)
    idx = create_index(_params(algo))
    for off in range(0, N, 512):
        idx.add_vector_batch(x[off:off + 512], list(range(off, off + 512)))
    assert not idx._host_links_stale and check_integrity(idx)
    replies = idx.topk_query_batch(x[:64], K)
    hits = np.mean([int(r.ids[0]) == i for i, r in enumerate(replies)])
    assert hits >= 0.95, hits
