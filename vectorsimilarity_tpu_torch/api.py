"""Function-style API veneer — one-to-one with the reference C API.

Counterpart of ``vectorsimilarity_tpu/api.py``. Every ``extern "C"`` entry
point in ``src/VecSim/vec_sim.h:28-331`` has a function here with the same
name and contract, for the flat, HNSW, SVS and tiered indexes.
``VecSimIndex_New`` puts the index on the current CUDA device unless
``device`` names another. The object-oriented surface (``VecSimIndexBase``
methods) remains the idiomatic way to use the library.
"""

from __future__ import annotations

from typing import Iterable, Optional

import numpy as np

from .core.adhoc import AdhocBfCtx
from .core.interface import VecSimIndexBase
from .core.results import QueryReply
from .indexes.factory import (
    create_index,
    estimate_element_size,
    estimate_initial_size,
)
from .ops.normalize import normalize_blob
from .query_params import resolve_params
from .types import (
    QueryReplyOrder,
    VecSimMetric,
    VecSimParams,
    VecSimQueryParams,
    VecSimType,
    VecsimQueryType,
    VecSimWriteMode,
    type_size,
)
from .utils.info import debug_info_iterator, get_shared_memory
from .utils.thread_pool import SharedSVSThreadPool


def VecSimIndex_New(params: VecSimParams, *, device=None):
    return create_index(params, device=device)


def VecSimIndex_Free(index) -> None:  # GC handles memory; parity no-op
    del index


def VecSimIndex_EstimateInitialSize(params: VecSimParams) -> int:
    return estimate_initial_size(params)


def VecSimIndex_EstimateElementSize(params: VecSimParams) -> int:
    return estimate_element_size(params)


def VecSimIndex_AddVector(index, blob: np.ndarray, label: int) -> int:
    return index.add_vector(blob, label)


def VecSimIndex_DeleteVector(index, label: int) -> int:
    return index.delete_vector(label)


def VecSimIndex_GetDistanceFrom_Unsafe(index, label: int, blob: np.ndarray) -> float:
    return index.get_distance_from(label, blob)


def VecSimIndex_IndexSize(index) -> int:
    return index.index_size


def VecSimIndex_TopKQuery(
    index,
    query_blob: np.ndarray,
    k: int,
    query_params: Optional[VecSimQueryParams] = None,
    order: QueryReplyOrder = QueryReplyOrder.BY_SCORE,
) -> QueryReply:
    reply = index.topk_query(query_blob, k, query_params)
    if order == QueryReplyOrder.BY_ID:
        reply.sort(QueryReplyOrder.BY_ID)
    return reply


def VecSimIndex_RangeQuery(
    index,
    query_blob: np.ndarray,
    radius: float,
    query_params: Optional[VecSimQueryParams] = None,
    order: QueryReplyOrder = QueryReplyOrder.BY_SCORE,
) -> QueryReply:
    if radius < 0:
        raise ValueError("radius must be non-negative")
    return index.range_query(query_blob, radius, query_params, order)


def VecSimIndex_ResolveParams(
    index, raw_params: Iterable[tuple[str, str]], query_type: VecsimQueryType
):
    return resolve_params(index, raw_params, query_type)


def VecSimBatchIterator_New(index, query_blob: np.ndarray, query_params=None):
    return index.new_batch_iterator(query_blob, query_params)


def VecSimBatchIterator_Next(iterator, n: int, order: QueryReplyOrder = QueryReplyOrder.BY_SCORE):
    return iterator.get_next_results(n, order)


def VecSimBatchIterator_HasNext(iterator) -> bool:
    return not iterator.is_depleted()


def VecSimBatchIterator_Reset(iterator) -> None:
    iterator.reset()


def VecSimBatchIterator_Free(iterator) -> None:
    del iterator


def VecSimIndex_BasicInfo(index):
    return index.basic_info()


def VecSimIndex_StatsInfo(index):
    return index.stats_info()


def VecSimIndex_DebugInfo(index):
    return index.debug_info()


def VecSimIndex_DebugInfoIterator(index):
    return debug_info_iterator(index)


def VecSimIndex_PreferAdHocSearch(index, subset_size: int, k: int, initial_check: bool) -> bool:
    return index.prefer_adhoc_search(subset_size, k, initial_check)


def VecSimIndex_AdhocBfCtx_New(index, query_blob: np.ndarray) -> AdhocBfCtx:
    return AdhocBfCtx(index, query_blob)


def VecSimIndex_AdhocBfCtx_GetDistanceFrom(ctx: AdhocBfCtx, label: int) -> float:
    return ctx.get_distance(label)


def VecSimIndex_AdhocBfCtx_GetExactDistances(ctx: AdhocBfCtx, labels) -> np.ndarray:
    return ctx.get_exact_distances(labels)


def VecSimIndex_AdhocBfCtx_Free(ctx) -> None:
    del ctx


def VecSimTieredIndex_GC(index) -> None:
    if index.basic_info().isTiered:
        index.run_gc()


def VecSimTieredIndex_AcquireSharedLocks(index) -> None:
    index.acquire_shared_locks()


def VecSimTieredIndex_ReleaseSharedLocks(index) -> None:
    index.release_shared_locks()


def VecSim_Normalize(blob: np.ndarray, dim: int, vtype: VecSimType) -> np.ndarray:
    return normalize_blob(np.asarray(blob).reshape(-1)[:dim], vtype)


def VecSimParams_GetQueryBlobSize(vtype: VecSimType, dim: int, metric: VecSimMetric) -> int:
    size = type_size(vtype) * dim
    if VecSimMetric(metric) == VecSimMetric.Cosine and VecSimType(vtype) in (
        VecSimType.INT8,
        VecSimType.UINT8,
    ):
        size += 4  # appended fp32 norm
    return size


def VecSim_SetTimeoutCallbackFunction(cb) -> None:
    VecSimIndexBase.set_timeout_callback(cb)


def VecSim_SetLogCallbackFunction(cb) -> None:
    VecSimIndexBase.set_log_callback(cb)


def VecSim_SetWriteMode(mode: VecSimWriteMode) -> None:
    VecSimIndexBase.set_write_mode(mode)


def VecSim_GetSharedMemory() -> int:
    return get_shared_memory()


def VecSim_SetMemoryFunctions(funcs) -> None:
    """The reference plugs Redis' allocator in (vec_sim.h:277-282). Device
    and numpy memory are runtime-managed here; accepted for API parity."""
    del funcs


def VecSim_UpdateThreadPoolSize(new_size: int) -> None:
    """vec_sim.cpp:38-48: size 0 flips writes to in-place, nonzero to async,
    and the shared SVS pool resizes (clamped to 1; deferred until the first
    SVS index attaches, and a shrink waits for scheduled jobs to end)."""
    VecSimIndexBase.set_write_mode(
        VecSimWriteMode.InPlace if new_size == 0 else VecSimWriteMode.Async)
    SharedSVSThreadPool.instance().resize(new_size)


def VecSimDebug_GetElementNeighborsInHNSWGraph(index, label: int):
    """vec_sim_debug.h:37-44 parity."""
    from .indexes.hnsw import HNSWIndex
    from .types import VecSimDebugCommandCode

    if not isinstance(index, HNSWIndex):
        return VecSimDebugCommandCode.BadIndex, None
    if index.multi:
        return VecSimDebugCommandCode.MultiNotSupported, None
    out = index.get_element_neighbors(label)
    if out is None:
        return VecSimDebugCommandCode.LabelNotExists, None
    return VecSimDebugCommandCode.OK, out
