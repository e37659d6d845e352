"""vectorsimilarity_tpu_torch — the PyTorch/CUDA port of ``vectorsimilarity_tpu``.

A second package beside the JAX one, ported slice by slice (ROADMAP.md).
The flat (brute-force) index: add / delete / overwrite, exact k-NN (batched
and device-resident), range queries, batch iterators and timeouts; L2 / IP /
Cosine. fp32, bf16, fp16, int8 and uint8 stores answer k-NN through three
hand-written kernels (``csrc/``: group-min for k <= 32, fused top-k for k <=
128, per-tile top-c for k <= 2048), fp64 stores through the exact streaming
scan. The HNSW index, built and searched on the device (``ops/graph_build.py``,
``ops/graph_search.py``): inserts, bulk builds, overwrites, deletes with
graph repair, tombstones and their bulk removal, k-NN, range queries and
batch iterators. SVS-Vamana (``indexes/svs.py``): the single-level graph
built and searched on the device, in every ``quantBits`` mode (SQ8, LVQ
4-bit, two-level LVQ and LeanVec, ``ops/quantize.py``), with deletes and
tombstones. The tiered HNSW and tiered SVS indexes (a flat frontend and a
graph backend with a job queue, ``utils/thread_pool.py``, which also holds
the shared SVS worker pool). The query surface of all:
``api`` (the C API's entry points), ``query_params``, hybrid (filtered)
queries and the ad-hoc scoring context. Persistence
(``utils/serializer.py``: the "vstpu-v1" file; ``utils/hnsw_file_format.py``:
the reference's HNSW V3/V4 files; ``utils/svs_file_format.py``: SVS
folders), the host-orchestrated graph builds (``config.graph_build_device =
False``) and the reference's pybind11 class surface (``bindings``).
Multi-device scale-out (``parallel/``): a mesh is an ordered list of torch
devices (``make_mesh``); the flat index row-shards its store over it
(``BruteForceIndex.to_sharded``: each shard scanned on its device by the same
kernels, one merge), the graph indexes cut query batches over it
(``to_query_sharded``), and ``ShardedHNSW`` / ``ShardedVamana`` partition the
dataset into one subgraph per device. Stores live on the current CUDA
device unless the caller passes ``device="cpu"``. The package imports torch
and never jax.
"""

from .types import (  # noqa: F401
    DEFAULT_BLOCK_SIZE,
    BFParams,
    HNSWParams,
    HNSWRuntimeParams,
    QueryReplyOrder,
    SVSParams,
    SVSRuntimeParams,
    TieredHNSWParams,
    TieredIndexParams,
    TieredSVSParams,
    VecSearchMode,
    VecSimAlgo,
    VecSimBool,
    VecSimIndexBasicInfo,
    VecSimIndexDebugInfo,
    VecSimIndexStatsInfo,
    VecSimMetric,
    VecSimOptionMode,
    VecSimParams,
    VecSimQueryParams,
    VecSimQueryReplyCode,
    VecSimResolveCode,
    VecSimSvsQuantBits,
    VecSimType,
    VecSimWriteMode,
    VecsimQueryType,
)
from .core.interface import VecSimIndexBase  # noqa: F401
from .core.results import QueryReply, filter_results_by_id, merge_replies  # noqa: F401
from .indexes.factory import (  # noqa: F401
    create_index,
    estimate_element_size,
    estimate_initial_size,
)
from .ops.normalize import normalize_blob as normalize  # noqa: F401
from .parallel.sharded_graph import ShardedHNSW, ShardedVamana  # noqa: F401
from .parallel.sharding import make_mesh  # noqa: F401
from .query_params import resolve_params  # noqa: F401

__version__ = "0.1.0"


def set_timeout_callback(cb) -> None:
    """``VecSim_SetTimeoutCallbackFunction`` parity."""
    VecSimIndexBase.set_timeout_callback(cb)


def set_log_callback(cb) -> None:
    """``VecSim_SetLogCallbackFunction`` parity."""
    VecSimIndexBase.set_log_callback(cb)


def set_write_mode(mode) -> None:
    """``VecSim_SetWriteMode`` parity."""
    VecSimIndexBase.set_write_mode(mode)
