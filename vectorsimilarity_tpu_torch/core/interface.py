"""Abstract index contract — the port's ``VecSimIndexInterface``.

Mirrors the pure-virtual contract at ``vec_sim_interface.h:23-243`` (add,
delete, topK, range, batch iterator, ad-hoc preference, info, GC, shared
locks) plus the class-level host callbacks (timeout / log / write mode,
``vec_sim_interface.h:205-243``). Subclasses implement the algorithm on top
of device-resident stores; everything here is host orchestration.
"""

from __future__ import annotations

import abc
import threading
from typing import Any, Callable, Optional

import numpy as np

from ..types import (
    QueryReplyOrder,
    VecSearchMode,
    VecSimIndexBasicInfo,
    VecSimIndexDebugInfo,
    VecSimIndexStatsInfo,
    VecSimQueryParams,
    VecSimWriteMode,
)
from .results import QueryReply


class VecSimIndexBase(abc.ABC):
    """The index contract. All queries accept numpy blobs and return host results."""

    # -- process-wide host callbacks (reference: static members,
    #    vec_sim_interface.h:205-243) --------------------------------------
    timeout_callback: Callable[[Any], int] = staticmethod(lambda ctx: 0)
    log_callback: Callable[[Any, str, str], None] = staticmethod(lambda ctx, level, msg: None)
    write_mode: VecSimWriteMode = VecSimWriteMode.Async

    @classmethod
    def set_timeout_callback(cls, cb: Callable[[Any], int]) -> None:
        VecSimIndexBase.timeout_callback = staticmethod(cb)

    @classmethod
    def set_log_callback(cls, cb: Callable[[Any, str, str], None]) -> None:
        VecSimIndexBase.log_callback = staticmethod(cb)

    @classmethod
    def set_write_mode(cls, mode: VecSimWriteMode) -> None:
        VecSimIndexBase.write_mode = VecSimWriteMode(mode)

    def __init__(self, log_ctx: Any = None):
        self.log_ctx = log_ctx
        self.last_mode: VecSearchMode = VecSearchMode.EMPTY_MODE
        # Concurrency: a shared/exclusive lock guarding index structure, the
        # host-side analog of the reference's rwlocks. Device work is ordered
        # on the CUDA stream; this protects host bookkeeping.
        self._lock = threading.RLock()

    # -- logging / timeout helpers ----------------------------------------

    def log(self, level: str, msg: str) -> None:
        VecSimIndexBase.log_callback(self.log_ctx, level, msg)

    @staticmethod
    def timed_out(timeout_ctx: Any) -> bool:
        return bool(VecSimIndexBase.timeout_callback(timeout_ctx))

    # -- write ops ---------------------------------------------------------

    @abc.abstractmethod
    def add_vector(self, blob: np.ndarray, label: int) -> int:
        """Insert/overwrite; returns the delta in stored-vector count
        (+1 new, 0 overwrite for single-value; always +1 for multi)."""

    @abc.abstractmethod
    def delete_vector(self, label: int) -> int:
        """Delete all vectors of ``label``; returns how many were deleted."""

    # -- read ops ----------------------------------------------------------

    @abc.abstractmethod
    def topk_query(
        self, query: np.ndarray, k: int, params: Optional[VecSimQueryParams] = None
    ) -> QueryReply:
        ...

    @abc.abstractmethod
    def range_query(
        self,
        query: np.ndarray,
        radius: float,
        params: Optional[VecSimQueryParams] = None,
        order: QueryReplyOrder = QueryReplyOrder.BY_SCORE,
    ) -> QueryReply:
        ...

    @abc.abstractmethod
    def new_batch_iterator(self, query: np.ndarray, params: Optional[VecSimQueryParams] = None):
        ...

    @abc.abstractmethod
    def get_distance_from(self, label: int, blob: np.ndarray) -> float:
        """Min distance from blob to the label's stored vector(s); NaN if absent
        (``VecSimIndex_GetDistanceFrom_Unsafe``)."""

    # -- batched read extension (many queries per device call) --

    def topk_query_batch(
        self, queries: np.ndarray, k: int, params: Optional[VecSimQueryParams] = None
    ) -> list[QueryReply]:
        """Default loops; device-backed indexes override with one batched call."""
        return [self.topk_query(q, k, params) for q in queries]

    # -- size / info -------------------------------------------------------

    @property
    @abc.abstractmethod
    def index_size(self) -> int:
        ...

    @property
    @abc.abstractmethod
    def index_label_count(self) -> int:
        ...

    @abc.abstractmethod
    def basic_info(self) -> VecSimIndexBasicInfo:
        ...

    @abc.abstractmethod
    def stats_info(self) -> VecSimIndexStatsInfo:
        ...

    @abc.abstractmethod
    def debug_info(self) -> VecSimIndexDebugInfo:
        ...

    @abc.abstractmethod
    def prefer_adhoc_search(self, subset_size: int, k: int, initial_check: bool) -> bool:
        ...

    def set_last_search_mode(self, mode: VecSearchMode) -> None:
        self.last_mode = VecSearchMode(mode)

    # -- tiered hooks (no-ops for plain indexes) ---------------------------

    def run_gc(self) -> None:
        pass

    def acquire_shared_locks(self) -> None:
        self._lock.acquire()

    def release_shared_locks(self) -> None:
        self._lock.release()


class TimeoutBudget:
    """Helper translating the reference's timeout-callback polling into a
    host-side budget checked between device calls.

    The reference polls ``VECSIM_TIMEOUT(ctx)`` inside its hot loops
    (``vec_sim_common.h:497``, e.g. ``brute_force.h:265``, ``hnsw.h:1923``)
    and returns partial results. Device scans cannot call back into the
    host, so we check at natural chunk boundaries (per device dispatch /
    per batch-iterator step) — same contract, coarser granularity.
    """

    def __init__(self, timeout_ctx: Any):
        self.ctx = timeout_ctx

    def expired(self) -> bool:
        return bool(VecSimIndexBase.timeout_callback(self.ctx))
