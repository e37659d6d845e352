"""Hybrid (filtered) query engine: ad-hoc-BF vs batches policy.

Counterpart of ``vectorsimilarity_tpu/core/hybrid.py``, for the flat and the
HNSW index. The reference provides the *pieces* of hybrid search — the
``preferAdHocSearch`` decision trees (brute_force.h:380-451,
hnsw.h:2179-2313), batch iterators, and the ad-hoc scoring context — while
RediSearch owns the driving loop (SURVEY §3.5). This module ships that loop
so the capability is usable standalone: given a filter (a set of allowed
labels), return the top-k best-scoring labels that pass it, choosing between

  - AD-HOC: score every passing label directly (one batched device call via
    ``AdhocBfCtx``), or
  - BATCHES: pull score-ordered batches from the index and keep passers,
    re-checking the policy as batches are consumed and switching to ad-hoc
    when the tree flips (HYBRID_BATCHES_TO_ADHOC_BF mode).
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np

from ..types import QueryReplyOrder, VecSearchMode, VecSimQueryParams
from .adhoc import AdhocBfCtx
from .results import QueryReply, make_reply


def hybrid_topk(
    index,
    query: np.ndarray,
    k: int,
    filter_labels: Iterable[int] | Callable[[int], bool],
    params: Optional[VecSimQueryParams] = None,
    batch_size: int = 0,
) -> QueryReply:
    """Top-k among labels passing the filter.

    ``filter_labels``: a collection of allowed labels (preferred — enables
    the subset-size heuristic and batched ad-hoc scoring) or a predicate.
    ``params.searchMode`` forces a policy (resolver HYBRID_POLICY);
    ``params.batchSize``/``batch_size`` sizes the batches.
    """
    as_set = None
    if not callable(filter_labels):
        as_set = set(int(x) for x in filter_labels)
        predicate = as_set.__contains__
        subset_size = len(as_set)
    else:
        predicate = filter_labels
        subset_size = index.index_label_count  # unknown selectivity: worst case

    forced = params.searchMode if params is not None else VecSearchMode.EMPTY_MODE
    if forced == VecSearchMode.HYBRID_ADHOC_BF:
        adhoc = True
    elif forced == VecSearchMode.HYBRID_BATCHES:
        adhoc = False
    else:
        adhoc = index.prefer_adhoc_search(subset_size, k, initial_check=True)

    if adhoc and as_set is not None:
        return _adhoc(index, query, k, sorted(as_set))

    return _batches(index, query, k, predicate, subset_size, params, batch_size,
                    allow_switch=forced == VecSearchMode.EMPTY_MODE, as_set=as_set)


def _adhoc(index, query, k, labels: list[int]) -> QueryReply:
    ctx = AdhocBfCtx(index, query)
    dists = ctx.get_exact_distances(labels)
    ok = ~np.isnan(dists)
    labels = np.asarray(labels, dtype=np.int64)[ok]
    dists = dists[ok]
    order = np.argsort(dists, kind="stable")[:k]
    index.set_last_search_mode(VecSearchMode.HYBRID_ADHOC_BF)
    return make_reply(labels[order], dists[order])


def _batches(index, query, k, predicate, subset_size, params, batch_size,
             allow_switch, as_set) -> QueryReply:
    it = index.new_batch_iterator(query, params)
    n = batch_size or (params.batchSize if params is not None else 0) or max(2 * k, 32)
    got_labels: list[int] = []
    got_scores: list[float] = []
    index.set_last_search_mode(VecSearchMode.HYBRID_BATCHES)
    while len(got_labels) < k and not it.is_depleted():
        rep = it.get_next_results(n)
        if len(rep) == 0:
            break
        for lab, sc in zip(rep.ids, rep.scores):
            if predicate(int(lab)):
                got_labels.append(int(lab))
                got_scores.append(float(sc))
                if len(got_labels) >= k:
                    break
        if len(got_labels) >= k:
            break
        # Re-evaluate the policy with the remaining work (the reference's
        # HYBRID_BATCHES_TO_ADHOC_BF dynamic switch).
        if allow_switch and as_set is not None:
            remaining = [l for l in as_set if l not in got_labels]
            if index.prefer_adhoc_search(len(remaining), k - len(got_labels),
                                         initial_check=False):
                tail = _adhoc(index, query, k - len(got_labels), sorted(remaining))
                got_labels.extend(int(x) for x in tail.ids)
                got_scores.extend(float(x) for x in tail.scores)
                index.set_last_search_mode(VecSearchMode.HYBRID_BATCHES_TO_ADHOC_BF)
                break
        n *= 2  # widen batches as selectivity proves low
    reply = make_reply(got_labels, got_scores)
    return reply.sort(QueryReplyOrder.BY_SCORE)
