"""BF batch iterator — compute-all-scores-once, serve in sorted batches.

Reference: ``bf_batch_iterator.h:24-215``. The first ``get_next_results``
computes ALL scores (one device scan); subsequent calls serve slices of the
score-sorted order. The reference chooses between heap-search and
nth_element-select per batch; with the full score vector on host a single
argsort covers both regimes. Multi-value dedup (best score per label,
``bfm_batch_iterator.h``) happens on device via slot scatter-min before the
sort.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.results import QueryReply, make_reply
from ..core.interface import TimeoutBudget
from ..types import QueryReplyOrder, VecSimQueryParams, VecSimQueryReplyCode


class BFBatchIterator:
    def __init__(self, index, query: np.ndarray, params: Optional[VecSimQueryParams] = None):
        self.index = index
        self.query = np.array(query, copy=True)
        self.params = params
        self._labels: Optional[np.ndarray] = None
        self._scores: Optional[np.ndarray] = None
        self._order: Optional[np.ndarray] = None
        self._served = 0

    def _materialize(self) -> None:
        if self._scores is not None:
            return
        labels, scores = self.index.compute_all_scores(self.query, self.params)
        order = np.argsort(scores, kind="stable")
        self._labels, self._scores, self._order = labels, scores, order

    def get_next_results(
        self, n: int, order: QueryReplyOrder = QueryReplyOrder.BY_SCORE
    ) -> QueryReply:
        budget = TimeoutBudget(self.params.timeoutCtx if self.params else None)
        if budget.expired():
            return make_reply([], [], VecSimQueryReplyCode.TimedOut)
        self._materialize()
        sel = self._order[self._served : self._served + n]
        self._served += len(sel)
        return make_reply(self._labels[sel], self._scores[sel]).sort(order)

    def is_depleted(self) -> bool:
        if self._scores is None:
            return self.index.index_size == 0
        return self._served >= len(self._order)

    def reset(self) -> None:
        self._labels = self._scores = self._order = None
        self._served = 0
