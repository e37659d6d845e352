"""Query replies and result-list utilities.

Mirrors ``VecSimQueryReply`` (``query_result_definitions.h:25-39``) and the
merge/filter helpers the tiered index uses
(``utils/query_result_utils.h:45-123``). Results are (label, score) pairs;
scores are float distances per the conventions in ``ops/distances.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..types import QueryReplyOrder, VecSimQueryReplyCode


@dataclasses.dataclass
class QueryReply:
    """ids: label array (int64), scores: distance array (float64)."""

    ids: np.ndarray = dataclasses.field(default_factory=lambda: np.empty(0, dtype=np.int64))
    scores: np.ndarray = dataclasses.field(default_factory=lambda: np.empty(0, dtype=np.float64))
    code: VecSimQueryReplyCode = VecSimQueryReplyCode.OK

    def __len__(self) -> int:
        return len(self.ids)

    def results(self) -> list[tuple[int, float]]:
        return list(zip(self.ids.tolist(), self.scores.tolist()))

    def sort(self, order: QueryReplyOrder) -> "QueryReply":
        order = QueryReplyOrder(order)
        if order == QueryReplyOrder.BY_ID:
            perm = np.argsort(self.ids, kind="stable")
        elif order == QueryReplyOrder.BY_SCORE:
            perm = np.argsort(self.scores, kind="stable")
        else:  # BY_SCORE_THEN_ID
            perm = np.lexsort((self.ids, self.scores))
        self.ids = self.ids[perm]
        self.scores = self.scores[perm]
        return self


def make_reply(ids, scores, code=VecSimQueryReplyCode.OK) -> QueryReply:
    return QueryReply(
        ids=np.asarray(ids, dtype=np.int64),
        scores=np.asarray(scores, dtype=np.float64),
        code=VecSimQueryReplyCode(code),
    )


def merge_replies(a: QueryReply, b: QueryReply, k: int, with_set: bool) -> QueryReply:
    """Merge two score-sorted replies keeping up to k best.

    ``with_set=True`` dedups labels across the two lists, keeping the better
    (first-encountered, i.e. lower) score — the tiered index path for indexes
    where the same label may appear in both tiers
    (``utils/query_result_utils.h:45-123`` ``merge_result_lists<withSet>``).
    """
    code = a.code if a.code != VecSimQueryReplyCode.OK else b.code
    ids = np.concatenate([a.ids, b.ids])
    scores = np.concatenate([a.scores, b.scores])
    perm = np.lexsort((ids, scores))
    ids, scores = ids[perm], scores[perm]
    if with_set:
        _, first = np.unique(ids, return_index=True)
        keep = np.zeros(len(ids), dtype=bool)
        keep[first] = True
        ids, scores = ids[keep], scores[keep]
        perm = np.argsort(scores, kind="stable")
        ids, scores = ids[perm], scores[perm]
    return QueryReply(ids=ids[:k], scores=scores[:k], code=code)


def filter_results_by_id(reply: QueryReply) -> QueryReply:
    """Dedup same-label entries keeping the best score, sort by id.

    (``utils/vec_utils.h:102-126`` ``filter_results_by_id``.)
    """
    perm = np.lexsort((reply.scores, reply.ids))
    ids, scores = reply.ids[perm], reply.scores[perm]
    keep = np.ones(len(ids), dtype=bool)
    keep[1:] = ids[1:] != ids[:-1]
    return QueryReply(ids=ids[keep], scores=scores[keep], code=reply.code)
