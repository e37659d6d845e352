"""HNSW batch iterator — resumable frontier semantics.

Counterpart of ``vectorsimilarity_tpu/indexes/hnsw_batch_iterator.py``.
Reference: ``hnsw_batch_iterator.h:21-267`` persists the beam frontier and
spillover heap across calls. The iterator carries the device beam state
``(beam, expanded-flags, visited bitmap)`` across refills via
``HNSWIndex.search_resumable``: when the served cache runs dry the beam
RESUMES at a doubled ef with the carried visited set, so deep paging expands
every node once (the reference's persisted candidate heap + spillover,
``hnsw_batch_iterator.h:94,206-249``). Index mutations invalidate the carried
state (detected by a store snapshot) and fall back to a fresh search — the
same contract as the reference, which also assumes a stable index per
iterator.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.interface import TimeoutBudget
from ..core.results import QueryReply, make_reply
from ..types import QueryReplyOrder, VecSimQueryParams, VecSimQueryReplyCode


class HNSWBatchIterator:
    def __init__(self, index, query: np.ndarray, params: Optional[VecSimQueryParams] = None):
        self.index = index
        self.query = np.array(query, copy=True)
        self.params = params
        base_ef = index.ef_runtime
        if params is not None and params.hnswRuntimeParams.efRuntime:
            base_ef = params.hnswRuntimeParams.efRuntime
        self._base_ef = max(base_ef, 32)
        self.reset()

    def reset(self) -> None:
        self._returned: set[int] = set()
        self._pending: list[tuple[float, int]] = []  # scored, not yet served
        self._seen: set[int] = set()  # returned ∪ pending labels
        self._ef = self._base_ef
        self._exhausted = False
        self._state = None  # carried device beam state (frontier + visited)
        self._snapshot = None  # (count, capacity, max_level) the state is valid for

    def is_depleted(self) -> bool:
        if self._pending:
            return False
        if self.index.index_size == 0:
            return True
        return self._exhausted

    def _search_more(self) -> None:
        """One search pass at the current ef; stash fresh labels in order.

        Resumes the carried beam state when the index is unchanged —
        otherwise (mutation between batches) restarts a fresh search at the
        current ef, keeping the already-served label set."""
        idx = self.index
        snap = (idx.store.count, idx.store.capacity, idx.max_level)
        if snap != self._snapshot:
            self._state = None
            self._snapshot = snap
        ef = min(self._ef, max(idx.index_size, 1))
        if ef >= idx.index_size:
            # Terminal full-width pass runs FRESH: a resumed beam cannot
            # recover nodes that were scored-then-evicted in an earlier
            # narrower pass (their visited bits suppress re-scoring) — the
            # reference keeps those in its spillover heap
            # (hnsw_batch_iterator.h:206-249); a fresh index-wide beam
            # reaches every connected node, restoring the same completeness
            # guarantee at depletion.
            self._state = None
        dists, ids, self._state = idx.search_resumable(
            self.query, min(ef, idx.index_size), ef, self._state
        )
        row_i, row_d = ids[0], dists[0]
        valid = (row_i >= 0) & np.isfinite(row_d)
        row_i, row_d = row_i[valid], row_d[valid]
        flags = idx.store.host["flags"]
        live = (flags[row_i] & 1) == 0
        row_i, row_d = row_i[live], row_d[live]
        labels = idx.store.host["label"][row_i]
        for lab, d in zip(labels, row_d):
            lab = int(lab)
            if lab not in self._seen:
                self._seen.add(lab)
                self._pending.append((float(d), lab))
        if ef >= idx.index_size or len(self._seen) >= idx.index_label_count:
            self._exhausted = True
        self._ef = ef * 2

    def get_next_results(
        self, n: int, order: QueryReplyOrder = QueryReplyOrder.BY_SCORE
    ) -> QueryReply:
        budget = TimeoutBudget(self.params.timeoutCtx if self.params else None)
        if budget.expired():
            return make_reply([], [], VecSimQueryReplyCode.TimedOut)
        if self.index.index_size == 0:
            self._exhausted = True
            return make_reply([], [])
        self._ef = max(self._ef, n)
        while len(self._pending) < n and not self._exhausted:
            self._search_more()
            if budget.expired():
                break
        serve, self._pending = self._pending[:n], self._pending[n:]
        self._returned.update(lab for _, lab in serve)
        return make_reply([lab for _, lab in serve], [d for d, _ in serve]).sort(order)
