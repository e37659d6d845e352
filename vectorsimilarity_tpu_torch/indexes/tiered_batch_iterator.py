"""Tiered batch iterator — merges flat + backend iterators with label dedup.

Counterpart of ``vectorsimilarity_tpu/indexes/tiered_batch_iterator.py``.
Reference: ``TieredHNSW_BatchIterator`` (``hnsw_tiered.h:930-1110``): holds
one iterator per tier, serves score-merged batches, and filters labels
already returned by either tier.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.results import QueryReply, make_reply
from ..types import QueryReplyOrder, VecSimQueryParams


class TieredBatchIterator:
    def __init__(self, index, query: np.ndarray, params: Optional[VecSimQueryParams] = None):
        self.index = index
        self.query = np.array(query, copy=True)
        self.params = params
        self.reset()

    def reset(self) -> None:
        self._flat_it = self.index.frontend.new_batch_iterator(self.query, self.params)
        self._main_it = self.index.backend.new_batch_iterator(self.query, self.params)
        self._returned: set[int] = set()
        # Per-tier lookahead buffers of (score, label) not yet emitted.
        self._flat_buf: list[tuple[float, int]] = []
        self._main_buf: list[tuple[float, int]] = []

    def _refill(self, buf: list, it, n: int) -> None:
        while len(buf) < n and not it.is_depleted():
            rep = it.get_next_results(max(n, 16), QueryReplyOrder.BY_SCORE)
            if len(rep) == 0:
                break
            buf.extend(
                (float(s), int(l))
                for l, s in zip(rep.ids, rep.scores)
                if int(l) not in self._returned
            )

    def get_next_results(
        self, n: int, order: QueryReplyOrder = QueryReplyOrder.BY_SCORE
    ) -> QueryReply:
        self._refill(self._flat_buf, self._flat_it, n)
        self._refill(self._main_buf, self._main_it, n)
        out_labels: list[int] = []
        out_scores: list[float] = []
        while len(out_labels) < n and (self._flat_buf or self._main_buf):
            src = None
            if not self._main_buf:
                src = self._flat_buf
            elif not self._flat_buf:
                src = self._main_buf
            else:
                src = self._flat_buf if self._flat_buf[0] <= self._main_buf[0] else self._main_buf
            score, label = src.pop(0)
            if label in self._returned:
                continue
            self._returned.add(label)
            out_labels.append(label)
            out_scores.append(score)
            if not self._flat_buf:
                self._refill(self._flat_buf, self._flat_it, n)
            if not self._main_buf:
                self._refill(self._main_buf, self._main_it, n)
        return make_reply(out_labels, out_scores).sort(order)

    def is_depleted(self) -> bool:
        return (
            not self._flat_buf
            and not self._main_buf
            and self._flat_it.is_depleted()
            and self._main_it.is_depleted()
        )
