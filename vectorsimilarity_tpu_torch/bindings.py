"""Drop-in class surface matching the reference's pybind11 module.

Counterpart of ``vectorsimilarity_tpu/bindings.py``. The reference exposes
``VecSim`` Python classes for flow tests and ann-benchmarks
(``python_bindings/bindings.cpp:104-240``: ``BFIndex``, ``HNSWIndex``,
``SVSIndex``, ``Tiered_HNSWIndex``, ``BatchIterator`` with ``knn_query`` /
``range_query`` returning (labels, distances) numpy pairs). This module
mirrors that surface one to one, so scripts written against the reference
bindings run unchanged, including the batched ``knn_parallel`` helper (the
reference releases the GIL and spawns threads; here a batch is one device
call). Every class takes ``device=``, passed through to its index: the
current CUDA device by default, the CPU only on request.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .indexes.brute_force import BruteForceIndex as _BF
from .indexes.factory import _with_defaults_hnsw
from .indexes.hnsw import HNSWIndex as _HNSW
from .indexes.svs import SVSIndex as _SVS
from .indexes.tiered import TieredHNSWIndex as _TieredHNSW
from .indexes.tiered_svs import TieredSVSIndex as _TieredSVS
from .types import (
    BFParams,
    HNSWParams,
    QueryReplyOrder,
    SVSParams,
    TieredIndexParams,
    VecSimAlgo,
    VecSimParams,
    VecSimQueryParams,
)
from .utils.hnsw_file_format import load_hnsw_file, save_hnsw_file
from .utils.serializer import check_integrity
from .utils.svs_file_format import load_svs_folder, save_svs_folder
from .utils.thread_pool import JobQueueThreadPool


def _pair(reply) -> tuple[np.ndarray, np.ndarray]:
    """(labels [1, n], distances [1, n]) like the pybind11 helpers."""
    return reply.ids.reshape(1, -1), reply.scores.reshape(1, -1)


class PyVecSimIndex:
    """Base wrapper (bindings.cpp:104-240)."""

    index = None  # type: ignore

    def add_vector(self, vector, label: int) -> int:
        return self.index.add_vector(np.asarray(vector), int(label))

    def delete_vector(self, label: int) -> int:
        return self.index.delete_vector(int(label))

    def knn_query(self, query, k: int, query_params: Optional[VecSimQueryParams] = None):
        return _pair(self.index.topk_query(np.asarray(query).reshape(-1), k, query_params))

    def range_query(self, query, radius: float, query_params=None):
        return _pair(
            self.index.range_query(np.asarray(query).reshape(-1), radius, query_params)
        )

    def knn_parallel(self, queries, k: int, query_params=None, num_threads: int = 0):
        """Batched queries: one device call replaces the reference's thread
        fan-out (bindings.cpp parallel helpers)."""
        replies = self.index.topk_query_batch(np.atleast_2d(np.asarray(queries)), k, query_params)
        n = max((len(r) for r in replies), default=0)
        labels = np.full((len(replies), n), -1, dtype=np.int64)
        dists = np.full((len(replies), n), np.inf)
        for i, r in enumerate(replies):
            labels[i, : len(r)] = r.ids
            dists[i, : len(r)] = r.scores
        return labels, dists

    def index_size(self) -> int:
        return self.index.index_size

    def index_type(self):
        return self.index.basic_info().type

    def info(self):
        return self.index.debug_info()

    def create_batch_iterator(self, query, query_params=None):
        return BatchIterator(self.index, np.asarray(query).reshape(-1), query_params)

    def get_vector(self, label: int):
        return np.vstack(self.index.get_stored_vectors(label))


class BFIndex(PyVecSimIndex):
    def __init__(self, params: BFParams, *, device=None):
        self.index = _BF(params, device=device)


class HNSWIndex(PyVecSimIndex):
    def __init__(self, params: Optional[HNSWParams] = None, location: Optional[str] = None,
                 *, device=None):
        if location is not None:
            self.index = load_hnsw_file(location, device=device)
        else:
            self.index = _HNSW(_with_defaults_hnsw(params), device=device)

    def save_index(self, location: str) -> None:
        save_hnsw_file(self.index, location)

    def check_integrity(self) -> bool:
        return check_integrity(self.index)

    def set_ef(self, ef_runtime: int) -> None:
        self.index.ef_runtime = ef_runtime


class SVSIndex(PyVecSimIndex):
    def __init__(self, params: SVSParams, location: Optional[str] = None, *, device=None):
        self.index = _SVS(params, device=device)
        if location is not None:
            # The reference's loadIndex contract (svs_serializer_impl.h:85-118):
            # create with the same params, then validate and restore.
            load_svs_folder(self.index, location)

    def save_index(self, location: str) -> None:
        save_svs_folder(self.index, location)


class _TieredBase(PyVecSimIndex):
    """Tiered wrapper owning the worker pool, as the pybind11 tiered classes
    embed the mock thread pool (bindings.cpp:486-522)."""

    def __init__(self, make, params: TieredIndexParams, num_threads: int = 4):
        self.pool = JobQueueThreadPool(num_threads)
        params.jobQueue = self.pool
        params.submitCb = self.pool.submit_cb
        self.index = make(params)

    def wait_for_index(self, timeout: float | None = 60) -> bool:
        return self.pool.wait_for_quiescence(timeout)

    def get_curr_bf_size(self) -> int:
        return self.index.frontend.index_size

    def get_hnsw_index_size(self) -> int:
        return self.index.backend.index_size

    def run_gc(self) -> None:
        self.index.run_gc()


class Tiered_HNSWIndex(_TieredBase):
    def __init__(self, hnsw_params: HNSWParams, tiered_params: TieredIndexParams,
                 num_threads: int = 4, *, device=None):
        tiered_params.primaryIndexParams = VecSimParams(
            algo=VecSimAlgo.HNSWLIB, hnswParams=hnsw_params
        )
        super().__init__(lambda p: _TieredHNSW(p, device=device), tiered_params, num_threads)


class Tiered_SVSIndex(_TieredBase):
    def __init__(self, svs_params: SVSParams, tiered_params: TieredIndexParams,
                 num_threads: int = 4, *, device=None):
        tiered_params.primaryIndexParams = VecSimParams(
            algo=VecSimAlgo.SVS, svsParams=svs_params
        )
        super().__init__(lambda p: _TieredSVS(p, device=device), tiered_params, num_threads)


class BatchIterator:
    """bindings.cpp batch iterator wrapper."""

    def __init__(self, index, query, query_params=None):
        self.it = index.new_batch_iterator(query, query_params)

    def has_next(self) -> bool:
        return not self.it.is_depleted()

    def get_next_results(self, n_res: int, order: QueryReplyOrder = QueryReplyOrder.BY_SCORE):
        return _pair(self.it.get_next_results(n_res, order))

    def reset(self) -> None:
        self.it.reset()
