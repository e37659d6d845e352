"""Core types, enums, parameter structs and defaults.

Restates ``vectorsimilarity_tpu/types.py`` whole (that package's import pulls
in jax). Enum member values match the reference's C enums
(``src/VecSim/vec_sim_common.h:60-456``) so that serialized data and host
integrations can interoperate; parameter structs are dataclasses with the
same defaults (``vec_sim_common.h:30-57``). The tests hold every member,
value and default here equal to the JAX package's.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Callable, Optional

import numpy as np

# ---------------------------------------------------------------------------
# Constants (reference: vec_sim_common.h:20-57)
# ---------------------------------------------------------------------------

DEFAULT_BLOCK_SIZE = 1024
INVALID_ID = 2**32 - 1  # UINT_MAX
INVALID_LABEL = 2**64 - 1  # SIZE_MAX

HNSW_DEFAULT_M = 16
HNSW_DEFAULT_EF_C = 200
HNSW_DEFAULT_EF_RT = 10
HNSW_DEFAULT_EPSILON = 0.01

SVS_VAMANA_DEFAULT_ALPHA_L2 = 1.2
SVS_VAMANA_DEFAULT_ALPHA_IP = 0.95
SVS_VAMANA_DEFAULT_GRAPH_MAX_DEGREE = 32
SVS_VAMANA_DEFAULT_CONSTRUCTION_WINDOW_SIZE = 200
SVS_VAMANA_DEFAULT_USE_SEARCH_HISTORY = True
SVS_VAMANA_DEFAULT_TRAINING_THRESHOLD = 10 * DEFAULT_BLOCK_SIZE
SVS_VAMANA_DEFAULT_UPDATE_THRESHOLD = 1 * DEFAULT_BLOCK_SIZE
SVS_VAMANA_DEFAULT_SEARCH_WINDOW_SIZE = 10
SVS_VAMANA_DEFAULT_LEANVEC_DIM = 0
SVS_VAMANA_DEFAULT_EPSILON = 0.01

# Hybrid policy strings (vec_sim_common.h:26-28)
VECSIM_POLICY_ADHOC_BF = "adhoc_bf"
VECSIM_POLICY_BATCHES = "batches"

# Query-param names accepted by the resolver (utils/vec_utils.h common strings)
HNSW_EF_RUNTIME_STRING = "EF_RUNTIME"
EPSILON_STRING = "EPSILON"
BATCH_SIZE_STRING = "BATCH_SIZE"
HYBRID_POLICY_STRING = "HYBRID_POLICY"
SVS_SEARCH_WS_STRING = "SEARCH_WS"
SVS_SEARCH_BC_STRING = "SEARCH_BC"
SVS_USE_SEARCH_HISTORY_STRING = "USE_SEARCH_HISTORY"
HNSW_RERANK_STRING = "RERANK"


# ---------------------------------------------------------------------------
# Enums (reference: vec_sim_common.h:60-141)
# ---------------------------------------------------------------------------


class VecSimType(enum.IntEnum):
    """Datatypes for indexing (vec_sim_common.h:62-71)."""

    FLOAT32 = 0
    FLOAT64 = 1
    BFLOAT16 = 2
    FLOAT16 = 3
    INT8 = 4
    UINT8 = 5
    INT32 = 6
    INT64 = 7


class VecSimAlgo(enum.IntEnum):
    """Algorithm type (vec_sim_common.h:74)."""

    BF = 0
    HNSWLIB = 1
    TIERED = 2
    SVS = 3


class VecSimMetric(enum.IntEnum):
    """Distance metric (vec_sim_common.h:89)."""

    L2 = 0
    IP = 1
    Cosine = 2


class VecSimOptionMode(enum.IntEnum):
    AUTO = 0
    ENABLE = 1
    DISABLE = 2


class VecSimBool(enum.IntEnum):
    TRUE = 1
    FALSE = 0
    UNSET = -1


class VecSimWriteMode(enum.IntEnum):
    """Write async/sync mode (vec_sim_common.h:130)."""

    Async = 0
    InPlace = 1


class VecSimSvsQuantBits(enum.IntEnum):
    """SVS quantization level (vec_sim_common.h:170-179)."""

    NONE = 0
    Scalar = 1
    Q4 = 4
    Q8 = 8
    Q4x4 = 4 | (4 << 8)
    Q4x8 = 4 | (8 << 8)
    Q4x8_LeanVec = 4 | (8 << 8) | (1 << 16)
    Q8x8_LeanVec = 8 | (8 << 8) | (1 << 16)


class VecSearchMode(enum.IntEnum):
    """Search mode of the last executed query (vec_sim_common.h:305-318)."""

    EMPTY_MODE = 0
    STANDARD_KNN = 1
    HYBRID_ADHOC_BF = 2
    HYBRID_BATCHES = 3
    HYBRID_BATCHES_TO_ADHOC_BF = 4
    RANGE_QUERY = 5


class VecsimQueryType(enum.IntEnum):
    """Query type for parameter resolution (vec_sim_common.h:320-325)."""

    NONE = 0
    KNN = 1
    HYBRID = 2
    RANGE = 3


class VecSimResolveCode(enum.IntEnum):
    """Return codes of resolve_params (vec_sim_common.h:106-118)."""

    OK = 0
    Err_NullParam = 1
    Err_AlreadySet = 2
    Err_UnknownParam = 3
    Err_BadValue = 4
    Err_InvalidPolicy_NExits = 5
    Err_InvalidPolicy_NHybrid = 6
    Err_InvalidPolicy_NRange = 7
    Err_InvalidPolicy_AdHoc_With_BatchSize = 8
    Err_InvalidPolicy_AdHoc_With_EfRuntime = 9


class VecSimDebugCommandCode(enum.IntEnum):
    OK = 0
    BadIndex = 1
    LabelNotExists = 2
    MultiNotSupported = 3


class VecSimQueryReplyCode(enum.IntEnum):
    """Query reply status (query_result_definitions.h)."""

    OK = 0
    TimedOut = 1
    Err = 2


class QueryReplyOrder(enum.IntEnum):
    """Result ordering for topk/range replies (query_results.h)."""

    BY_SCORE = 0
    BY_ID = 1
    BY_SCORE_THEN_ID = 2


# ---------------------------------------------------------------------------
# numpy dtype mapping
# ---------------------------------------------------------------------------

try:  # ml_dtypes is optional; without it bfloat16 host mirrors widen to fp32
    import ml_dtypes

    _BFLOAT16 = np.dtype(ml_dtypes.bfloat16)
except ImportError:  # pragma: no cover
    _BFLOAT16 = np.dtype(np.float32)

_NUMPY_DTYPES = {
    VecSimType.FLOAT32: np.dtype(np.float32),
    VecSimType.FLOAT64: np.dtype(np.float64),
    VecSimType.BFLOAT16: _BFLOAT16,
    VecSimType.FLOAT16: np.dtype(np.float16),
    VecSimType.INT8: np.dtype(np.int8),
    VecSimType.UINT8: np.dtype(np.uint8),
    VecSimType.INT32: np.dtype(np.int32),
    VecSimType.INT64: np.dtype(np.int64),
}


def numpy_dtype(t: VecSimType) -> np.dtype:
    """numpy dtype holding one element of VecSimType ``t``."""
    return _NUMPY_DTYPES[VecSimType(t)]


def type_size(t: VecSimType) -> int:
    """sizeof(t) — reference VecSimType_sizeof."""
    return numpy_dtype(t).itemsize


def is_integer_type(t: VecSimType) -> bool:
    return t in (VecSimType.INT8, VecSimType.UINT8, VecSimType.INT32, VecSimType.INT64)


# ---------------------------------------------------------------------------
# Parameter structs (reference: vec_sim_common.h:148-254)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class BFParams:
    """Brute-force (flat) index params (vec_sim_common.h:163-170)."""

    type: VecSimType = VecSimType.FLOAT32
    dim: int = 0
    metric: VecSimMetric = VecSimMetric.L2
    multi: bool = False
    initialCapacity: int = 0  # deprecated, kept for API parity
    blockSize: int = 0  # 0 -> DEFAULT_BLOCK_SIZE


@dataclasses.dataclass
class HNSWParams:
    """HNSW index params (vec_sim_common.h:150-161)."""

    type: VecSimType = VecSimType.FLOAT32
    dim: int = 0
    metric: VecSimMetric = VecSimMetric.L2
    multi: bool = False
    initialCapacity: int = 0  # deprecated
    blockSize: int = 0
    M: int = 0  # 0 -> HNSW_DEFAULT_M
    efConstruction: int = 0  # 0 -> HNSW_DEFAULT_EF_C
    efRuntime: int = 0  # 0 -> HNSW_DEFAULT_EF_RT
    epsilon: float = 0.0  # 0 -> HNSW_DEFAULT_EPSILON


@dataclasses.dataclass
class SVSParams:
    """SVS-Vamana index params (vec_sim_common.h:181-210)."""

    type: VecSimType = VecSimType.FLOAT32
    dim: int = 0
    metric: VecSimMetric = VecSimMetric.L2
    multi: bool = False
    blockSize: int = 0
    quantBits: VecSimSvsQuantBits = VecSimSvsQuantBits.NONE
    alpha: float = 0.0  # 0 -> metric-dependent default
    graph_max_degree: int = 0
    construction_window_size: int = 0
    max_candidate_pool_size: int = 0
    prune_to: int = 0
    use_search_history: VecSimOptionMode = VecSimOptionMode.AUTO
    num_threads: int = 0  # deprecated/ignored (reference deprecates it too)
    search_window_size: int = 0
    search_buffer_capacity: int = 0
    leanvec_dim: int = 0
    epsilon: float = 0.0


@dataclasses.dataclass
class TieredHNSWParams:
    """vec_sim_common.h:213-216."""

    swapJobThreshold: int = 0


@dataclasses.dataclass
class TieredSVSParams:
    """vec_sim_common.h:225-233."""

    trainingTriggerThreshold: int = 0
    updateTriggerThreshold: int = 0
    updateJobWaitTime: int = 0


@dataclasses.dataclass
class TieredIndexParams:
    """vec_sim_common.h:236-247.

    ``jobQueue``/``jobQueueCtx``/``submitCb`` keep the reference's
    inversion-of-control contract: the host owns the worker threads; the index
    only submits jobs through ``submitCb(job_queue, ctx, jobs, callbacks)``.
    """

    jobQueue: Any = None
    jobQueueCtx: Any = None
    submitCb: Optional[Callable] = None
    flatBufferLimit: int = 0
    primaryIndexParams: Optional["VecSimParams"] = None
    tieredHnswParams: TieredHNSWParams = dataclasses.field(default_factory=TieredHNSWParams)
    tieredSVSParams: TieredSVSParams = dataclasses.field(default_factory=TieredSVSParams)


@dataclasses.dataclass
class VecSimParams:
    """Top-level index creation params (vec_sim_common.h:256-260)."""

    algo: VecSimAlgo = VecSimAlgo.BF
    bfParams: Optional[BFParams] = None
    hnswParams: Optional[HNSWParams] = None
    svsParams: Optional[SVSParams] = None
    tieredParams: Optional[TieredIndexParams] = None
    logCtx: Any = None

    @property
    def algo_params(self):
        if self.algo == VecSimAlgo.BF:
            return self.bfParams
        if self.algo == VecSimAlgo.HNSWLIB:
            return self.hnswParams
        if self.algo == VecSimAlgo.SVS:
            return self.svsParams
        if self.algo == VecSimAlgo.TIERED:
            return self.tieredParams
        raise ValueError(f"unknown algo {self.algo}")


# ---------------------------------------------------------------------------
# Runtime query params (reference: vec_sim_common.h:283-303, 327-340)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class HNSWRuntimeParams:
    efRuntime: int = 0
    epsilon: float = 0.0


@dataclasses.dataclass
class SVSRuntimeParams:
    windowSize: int = 0
    bufferCapacity: int = 0
    searchHistory: VecSimOptionMode = VecSimOptionMode.AUTO
    epsilon: float = 0.0


@dataclasses.dataclass
class VecSimQueryParams:
    """Resolved runtime query params (vec_sim_common.h:330-340)."""

    hnswRuntimeParams: HNSWRuntimeParams = dataclasses.field(default_factory=HNSWRuntimeParams)
    svsRuntimeParams: SVSRuntimeParams = dataclasses.field(default_factory=SVSRuntimeParams)
    batchSize: int = 0
    searchMode: VecSearchMode = VecSearchMode.EMPTY_MODE
    timeoutCtx: Any = None


# ---------------------------------------------------------------------------
# Info structs (reference: vec_sim_common.h:342-456)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class VecSimIndexBasicInfo:
    algo: VecSimAlgo = VecSimAlgo.BF
    metric: VecSimMetric = VecSimMetric.L2
    type: VecSimType = VecSimType.FLOAT32
    isMulti: bool = False
    isTiered: bool = False
    isDisk: bool = False
    blockSize: int = DEFAULT_BLOCK_SIZE
    dim: int = 0


@dataclasses.dataclass
class VecSimIndexStatsInfo:
    memory: int = 0
    numberOfMarkedDeleted: int = 0
    directHNSWInsertions: int = 0
    flatBufferSize: int = 0


@dataclasses.dataclass
class CommonInfo:
    basicInfo: VecSimIndexBasicInfo = dataclasses.field(default_factory=VecSimIndexBasicInfo)
    indexSize: int = 0
    indexLabelCount: int = 0
    memory: int = 0
    lastMode: VecSearchMode = VecSearchMode.EMPTY_MODE


@dataclasses.dataclass
class HnswInfo:
    M: int = 0
    efConstruction: int = 0
    efRuntime: int = 0
    epsilon: float = 0.0
    max_level: int = 0
    entrypoint: int = INVALID_LABEL
    visitedNodesPoolSize: int = 0
    numberOfMarkedDeletedNodes: int = 0


@dataclasses.dataclass
class BfInfo:
    pass


@dataclasses.dataclass
class SvsInfo:
    quantBits: VecSimSvsQuantBits = VecSimSvsQuantBits.NONE
    alpha: float = 0.0
    graphMaxDegree: int = 0
    constructionWindowSize: int = 0
    maxCandidatePoolSize: int = 0
    pruneTo: int = 0
    useSearchHistory: bool = True
    numberOfMarkedDeletedNodes: int = 0
    searchWindowSize: int = 0
    searchBufferCapacity: int = 0
    leanvecDim: int = 0
    epsilon: float = 0.0


@dataclasses.dataclass
class TieredInfo:
    backendInfo: Any = None
    backendCommonInfo: CommonInfo = dataclasses.field(default_factory=CommonInfo)
    frontendCommonInfo: CommonInfo = dataclasses.field(default_factory=CommonInfo)
    bfInfo: BfInfo = dataclasses.field(default_factory=BfInfo)
    management_layer_memory: int = 0
    backgroundIndexing: bool = False
    bufferLimit: int = 0
    specificTieredBackendInfo: Any = None


@dataclasses.dataclass
class VecSimIndexDebugInfo:
    commonInfo: CommonInfo = dataclasses.field(default_factory=CommonInfo)
    bfInfo: Optional[BfInfo] = None
    hnswInfo: Optional[HnswInfo] = None
    svsInfo: Optional[SvsInfo] = None
    tieredInfo: Optional[TieredInfo] = None


def round_up_initial_capacity(initial_capacity: int, block_size: int) -> int:
    """Round up to the nearest multiple of blockSize (vec_sim_common.h:498-501)."""
    if initial_capacity % block_size:
        return initial_capacity + block_size - initial_capacity % block_size
    return initial_capacity
