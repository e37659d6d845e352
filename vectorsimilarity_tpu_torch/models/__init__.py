"""Index model families.

Counterpart of ``vectorsimilarity_tpu/models/__init__.py``. The algorithm
implementations live in ``..indexes``; this package re-exports them under
the conventional ``models`` namespace:

  - :class:`BruteForceIndex` — exact flat scan (single & multi-value)
  - :class:`HNSWIndex` — multi-level proximity graph
  - :class:`SVSIndex` — single-level Vamana graph (optional quantization)
  - :class:`TieredHNSWIndex` / :class:`TieredSVSIndex` — flat frontend +
    graph backend with async ingestion
"""

from ..indexes.brute_force import BruteForceIndex  # noqa: F401
from ..indexes.hnsw import HNSWIndex  # noqa: F401
from ..indexes.svs import SVSIndex  # noqa: F401
from ..indexes.tiered import TieredHNSWIndex  # noqa: F401
from ..indexes.tiered_svs import TieredSVSIndex  # noqa: F401
