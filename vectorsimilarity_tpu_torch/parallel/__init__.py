"""Multi-device scale-out: a mesh of torch devices, the row-sharded flat
scan, query-parallel graph serving and the data-sharded graph indexes."""

from .sharded_batch_iterator import ShardedBatchIterator  # noqa: F401
from .sharded_graph import ShardedHNSW, ShardedVamana  # noqa: F401
from .sharding import (  # noqa: F401
    AXIS,
    Mesh,
    ShardedFlatStore,
    ShardedRows,
    make_mesh,
    query_parallel_search,
    replicate,
    shard_rows,
    sharded_topk,
)
