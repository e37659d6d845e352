"""Runtime query-parameter resolver.

Counterpart of ``vectorsimilarity_tpu/query_params.py``, restated (that
package imports jax). Parity with ``VecSimIndex_ResolveParams``
(``vec_sim.cpp:50-343``): string (name, value) raw params ->
``VecSimQueryParams``, validating which params apply to which algorithm and
query type, and rejecting invalid combinations (ad-hoc policy with
BATCH_SIZE / EF_RUNTIME).
"""

from __future__ import annotations

from typing import Iterable, Optional

from .types import (
    BATCH_SIZE_STRING,
    EPSILON_STRING,
    HNSW_EF_RUNTIME_STRING,
    HYBRID_POLICY_STRING,
    SVS_SEARCH_BC_STRING,
    SVS_SEARCH_WS_STRING,
    SVS_USE_SEARCH_HISTORY_STRING,
    VECSIM_POLICY_ADHOC_BF,
    VECSIM_POLICY_BATCHES,
    VecSearchMode,
    VecSimAlgo,
    VecSimOptionMode,
    VecSimQueryParams,
    VecSimResolveCode,
    VecsimQueryType,
)

RawParam = tuple[str, str]


def _positive_int(value: str) -> Optional[int]:
    try:
        v = int(value)
    except (TypeError, ValueError):
        return None
    return v if v > 0 else None


def _positive_float(value: str) -> Optional[float]:
    try:
        v = float(value)
    except (TypeError, ValueError):
        return None
    return v if v > 0 else None


def _option_bool(value: str) -> Optional[VecSimOptionMode]:
    v = str(value).lower()
    if v == "true":
        return VecSimOptionMode.ENABLE
    if v == "false":
        return VecSimOptionMode.DISABLE
    return None


def resolve_params(
    index,
    raw_params: Iterable[RawParam],
    query_type: VecsimQueryType,
) -> tuple[VecSimResolveCode, VecSimQueryParams]:
    """Returns (code, resolved params). Params valid only if code == OK."""
    qparams = VecSimQueryParams()
    info = index.basic_info()
    algo = VecSimAlgo(info.algo)
    query_type = VecsimQueryType(query_type)
    R = VecSimResolveCode

    for name, value in raw_params:
        key = name.upper()
        if key == HNSW_EF_RUNTIME_STRING:
            if algo != VecSimAlgo.HNSWLIB or query_type == VecsimQueryType.RANGE:
                return R.Err_UnknownParam, qparams
            if qparams.hnswRuntimeParams.efRuntime != 0:
                return R.Err_AlreadySet, qparams
            v = _positive_int(value)
            if v is None:
                return R.Err_BadValue, qparams
            qparams.hnswRuntimeParams.efRuntime = v
        elif key == EPSILON_STRING:
            if algo not in (VecSimAlgo.HNSWLIB, VecSimAlgo.SVS):
                return R.Err_UnknownParam, qparams
            if query_type != VecsimQueryType.RANGE:
                return R.Err_InvalidPolicy_NRange, qparams
            current = (
                qparams.hnswRuntimeParams.epsilon
                if algo == VecSimAlgo.HNSWLIB
                else qparams.svsRuntimeParams.epsilon
            )
            if current != 0:
                return R.Err_AlreadySet, qparams
            v = _positive_float(value)
            if v is None:
                return R.Err_BadValue, qparams
            if algo == VecSimAlgo.HNSWLIB:
                qparams.hnswRuntimeParams.epsilon = v
            else:
                qparams.svsRuntimeParams.epsilon = v
        elif key == BATCH_SIZE_STRING:
            if query_type != VecsimQueryType.HYBRID:
                return R.Err_InvalidPolicy_NHybrid, qparams
            if qparams.batchSize != 0:
                return R.Err_AlreadySet, qparams
            v = _positive_int(value)
            if v is None:
                return R.Err_BadValue, qparams
            qparams.batchSize = v
        elif key == HYBRID_POLICY_STRING:
            if query_type != VecsimQueryType.HYBRID:
                return R.Err_InvalidPolicy_NHybrid, qparams
            if qparams.searchMode != VecSearchMode.EMPTY_MODE:
                return R.Err_AlreadySet, qparams
            v = str(value).lower()
            if v == VECSIM_POLICY_BATCHES:
                qparams.searchMode = VecSearchMode.HYBRID_BATCHES
            elif v == VECSIM_POLICY_ADHOC_BF:
                qparams.searchMode = VecSearchMode.HYBRID_ADHOC_BF
            else:
                return R.Err_InvalidPolicy_NExits, qparams
        elif key == SVS_SEARCH_WS_STRING:
            if algo != VecSimAlgo.SVS:
                return R.Err_UnknownParam, qparams
            if qparams.svsRuntimeParams.windowSize != 0:
                return R.Err_AlreadySet, qparams
            v = _positive_int(value)
            if v is None:
                return R.Err_BadValue, qparams
            qparams.svsRuntimeParams.windowSize = v
        elif key == SVS_SEARCH_BC_STRING:
            if algo != VecSimAlgo.SVS:
                return R.Err_UnknownParam, qparams
            if qparams.svsRuntimeParams.bufferCapacity != 0:
                return R.Err_AlreadySet, qparams
            v = _positive_int(value)
            if v is None:
                return R.Err_BadValue, qparams
            qparams.svsRuntimeParams.bufferCapacity = v
        elif key == SVS_USE_SEARCH_HISTORY_STRING:
            if algo != VecSimAlgo.SVS:
                return R.Err_UnknownParam, qparams
            if qparams.svsRuntimeParams.searchHistory != VecSimOptionMode.AUTO:
                return R.Err_AlreadySet, qparams
            v = _option_bool(value)
            if v is None:
                return R.Err_BadValue, qparams
            qparams.svsRuntimeParams.searchHistory = v
        else:
            return R.Err_UnknownParam, qparams

    if qparams.searchMode == VecSearchMode.HYBRID_ADHOC_BF and qparams.batchSize > 0:
        return R.Err_InvalidPolicy_AdHoc_With_BatchSize, qparams
    if (
        qparams.searchMode == VecSearchMode.HYBRID_ADHOC_BF
        and algo == VecSimAlgo.HNSWLIB
        and qparams.hnswRuntimeParams.efRuntime > 0
    ):
        return R.Err_InvalidPolicy_AdHoc_With_EfRuntime, qparams
    if qparams.searchMode != VecSearchMode.EMPTY_MODE:
        index.set_last_search_mode(qparams.searchMode)
    return R.OK, qparams
