"""Batch iterator over a data-sharded graph index.

Counterpart of ``vectorsimilarity_tpu/parallel/sharded_batch_iterator.py``.
Reference semantics: ``VecSimBatchIterator`` pages through an index's
results best-first without repeats (batch_iterator.h). A data-sharded graph
is S independent subgraphs over disjoint label sets, so the sharded iterator
is a k-way merge of the per-shard resumable iterators: each shard's own
iterator carries its beam state across refills, and the merge pops the
globally best-scored head. A label routes to exactly one shard, so no
cross-shard dedup is needed; tombstones and multi-value duplicates are
filtered by the per-shard iterators.

Score streams of graph iterators are approximately ordered (a deeper refill
can surface a closer node late, the same approximation as the reference's
ef-bounded pages); the merge keeps whatever order the shard streams give.

Unlike the JAX package's ``_refill``, which asks again for as long as a
shard's iterator is not depleted, a refill here stops on a reply that adds
nothing: an iterator that reports more results but returns none would
otherwise spin forever.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..core.interface import TimeoutBudget
from ..core.results import make_reply
from ..types import QueryReplyOrder, VecSimQueryParams, VecSimQueryReplyCode


class ShardedBatchIterator:
    def __init__(self, index, query: np.ndarray, params: Optional[VecSimQueryParams] = None):
        self.index = index
        self.query = np.array(query, copy=True)
        self.params = params
        self.reset()

    def reset(self) -> None:
        self._iters = [
            s.new_batch_iterator(self.query, self.params)
            for s in self.index.shards
            if s.index_size > 0
        ]
        # Per-shard lookahead buffer: (score, label) lists, head first.
        self._buf: list[list[tuple[float, int]]] = [[] for _ in self._iters]
        self._dry = [False] * len(self._iters)  # a refill returned nothing

    def _refill(self, i: int, n: int, budget) -> None:
        it = self._iters[i]
        while not self._buf[i] and not self._dry[i] and not it.is_depleted():
            rep = it.get_next_results(max(n, 8), QueryReplyOrder.BY_SCORE)
            self._buf[i].extend((float(d), int(l)) for l, d in zip(rep.ids, rep.scores))
            if not len(rep.ids):
                self._dry[i] = True
            if rep.code != VecSimQueryReplyCode.OK or budget.expired():
                break

    def _exhausted(self, i: int) -> bool:
        return not self._buf[i] and (self._dry[i] or self._iters[i].is_depleted())

    def is_depleted(self) -> bool:
        return all(self._exhausted(i) for i in range(len(self._iters)))

    def get_next_results(self, n: int, order: QueryReplyOrder = QueryReplyOrder.BY_SCORE):
        budget = TimeoutBudget(self.params.timeoutCtx if self.params else None)
        if budget.expired():
            return make_reply([], [], VecSimQueryReplyCode.TimedOut)
        out: list[tuple[float, int]] = []
        while len(out) < n:
            for i in range(len(self._iters)):
                if not self._buf[i]:
                    self._refill(i, n - len(out), budget)
            heads = [(b[0][0], i) for i, b in enumerate(self._buf) if b]
            if not heads:
                break
            _, i = min(heads)
            out.append(self._buf[i].pop(0))
            if budget.expired():
                break
        code = VecSimQueryReplyCode.TimedOut if budget.expired() else VecSimQueryReplyCode.OK
        return make_reply([l for _, l in out], [d for d, _ in out], code).sort(order)
