"""SVS batch iterator — resumable frontier semantics.

Counterpart of ``vectorsimilarity_tpu/indexes/svs_batch_iterator.py``.
Reference: ``svs_batch_iterator.h:23-60`` wraps ``svs::vamana::iterator``,
which resumes its internal search schedule between batches. Same design as
``HNSWBatchIterator``: the device beam state ``(beam, expanded-flags,
visited bitmap)`` carries across refills via ``SVSIndex.search_resumable``,
so deep paging expands every node once; when the window reaches the index
size a fresh terminal pass restores completeness (scored-then-evicted nodes
are suppressed by their visited bits in a resumed beam). Index mutations
invalidate the carried state (store snapshot) and fall back to a fresh
search with the served-label set kept.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.interface import TimeoutBudget
from ..core.results import QueryReply, make_reply
from ..types import QueryReplyOrder, VecSimQueryParams, VecSimQueryReplyCode


class SVSBatchIterator:
    def __init__(self, index, query: np.ndarray, params: Optional[VecSimQueryParams] = None):
        self.index = index
        self.query = np.array(query, copy=True)
        self.params = params
        ws = index.ws
        if params is not None and params.svsRuntimeParams.windowSize:
            ws = params.svsRuntimeParams.windowSize
        self._base_ws = max(ws, 32)
        self.reset()

    def reset(self) -> None:
        self._pending: list[tuple[float, int]] = []
        self._seen: set[int] = set()
        self._ws = self._base_ws
        self._exhausted = False
        self._state = None  # carried device beam state (frontier + visited)
        self._snapshot = None  # (count, capacity, entry) the state is valid for

    def is_depleted(self) -> bool:
        if self._pending:
            return False
        return self._exhausted or self.index.index_size == 0

    def _search_more(self) -> None:
        idx = self.index
        snap = (idx.store.count, idx.store.capacity, idx.entry_id)
        if snap != self._snapshot:
            self._state = None
            self._snapshot = snap
        ws = min(self._ws, max(idx.index_size, 1))
        if ws >= idx.index_size:
            # Terminal full-width pass runs FRESH (see module docstring).
            self._state = None
        dists, ids, self._state = idx.search_resumable(
            self.query, min(ws, idx.index_size), ws, self._state
        )
        if idx.res_bits:
            dists, ids = idx._refine(np.atleast_2d(self.query), dists, ids)
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
        if ws >= idx.index_size or len(self._seen) >= idx.index_label_count:
            self._exhausted = True
        self._ws = ws * 2

    def get_next_results(
        self, n: int, order: QueryReplyOrder = QueryReplyOrder.BY_SCORE
    ) -> QueryReply:
        budget = TimeoutBudget(self.params.timeoutCtx if self.params else None)
        if budget.expired():
            return make_reply([], [], VecSimQueryReplyCode.TimedOut)
        if self.index.index_size == 0:
            self._exhausted = True
            return make_reply([], [])
        self._ws = max(self._ws, n)
        while len(self._pending) < n and not self._exhausted:
            self._search_more()
            if budget.expired():
                break
        serve, self._pending = self._pending[:n], self._pending[n:]
        return make_reply([lab for _, lab in serve], [d for d, _ in serve]).sort(order)
