"""Brute-force (Flat) index — counterpart of ``vectorsimilarity_tpu/indexes/brute_force.py``.

The reference's per-vector distance loop + bounded heap
(``brute_force.h:242-291``) becomes one of three kernel engines of
``ops/kernels/bf_topk.py``, chosen by k as the JAX index chooses (group-min
for k <= 32, fused for k <= 128, per-tile top-c for k <= 2048; fp32, bf16,
fp16, int8 and uint8 stores), and the exact streaming scan
(``ops.distances.streaming_topk``) for fp64 stores and every k beyond.
Multi-value "best score per label"
(``brute_force_multi.h:17-277``) becomes a scatter-min over dense label
slots (``ops.topk``). Swap-with-last deletion, id/label maps, the
ad-hoc-vs-batches decision tree (``brute_force.h:380-451``) and the
compute-all-scores-once batch iterator (``bf_batch_iterator.h``) keep the
reference's semantics. ``to_sharded(mesh)`` row-shards the store over a mesh
of devices: each shard is scanned on its device by the same engines and the
candidates merge on the first (``parallel.sharding.sharded_topk``).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .. import config
from ..core.abstract_index import DeviceVectorIndex, pow2_bucket
from ..core.interface import TimeoutBudget
from ..core.results import QueryReply, make_reply
from ..ops.distances import full_scores, streaming_topk
from ..ops.kernels.bf_topk import topk_bigk_exact, topk_fused, topk_gm_exact
from ..ops.topk import slot_min_scores, topk_by_slot
from ..types import (
    BFParams,
    BfInfo,
    CommonInfo,
    QueryReplyOrder,
    VecSearchMode,
    VecSimAlgo,
    VecSimIndexDebugInfo,
    VecSimIndexStatsInfo,
    VecSimQueryParams,
    VecSimQueryReplyCode,
)

# Streaming-scan row chunk, capped at the store capacity so small stores are
# not padded up to it.
_SCAN_CHUNK = 1 << 18


def engine_topk(qd: torch.Tensor, data: torch.Tensor, aux: Optional[torch.Tensor], count: int,
                k: int, *, metric, kind: str, query_norms: Optional[torch.Tensor] = None):
    """Top-k of device queries over rows [0, count) of ``data`` (its length is
    the capacity the gates see), by the engine the JAX index picks for this
    k and store: group-min (K1), fused (K3), per-tile top-c (K4), else the
    streaming scan. The fused and big-k gates see k rounded up to a power of
    two, as there. Returns device (dists [B, k], row ids [B, k])."""
    cap = data.shape[0]
    tile_n = min(config.tile_n, cap)
    kpad = min(pow2_bucket(k), cap)
    chunk = max(min(_SCAN_CHUNK, cap), k)
    if config.gm_enabled(kind, k, cap, data.dtype):
        return topk_gm_exact(
            qd, data, aux, count, k, metric=metric, kind=kind, tile_n=tile_n,
            group_n=config.gm_group_n, slack=config.gm_slack, chunk=chunk,
            query_norms=query_norms,
        )
    if config.fused_enabled(kind, kpad, cap, data.dtype):
        return topk_fused(qd, data, aux, count, k, metric=metric, query_norms=query_norms)
    if config.bigk_enabled(kind, kpad, cap, data.dtype):
        return topk_bigk_exact(
            qd, data, aux, count, k, metric=metric, kind=kind, tile_n=tile_n,
            local_c=config.local_c, chunk=chunk, query_norms=query_norms,
        )
    return streaming_topk(qd, (data, aux), count, k, metric=metric, kind=kind, chunk=chunk,
                          query_norms=query_norms)


class BruteForceIndex(DeviceVectorIndex):
    """Flat index over a block store on ``device`` (single- or multi-value):
    the current CUDA device by default, the CPU only on request."""

    def __init__(self, params: BFParams, log_ctx: Any = None, *, device=None):
        super().__init__(
            vtype=params.type,
            dim=params.dim,
            metric=params.metric,
            multi=params.multi,
            block_size=params.blockSize,
            device=device,
            log_ctx=log_ctx,
            initial_capacity=params.initialCapacity,
        )
        self.params = params
        self.mesh = None  # the row-sharded mode's mesh (to_sharded)

    def to_sharded(self, mesh) -> "BruteForceIndex":
        """Row-shard the store over ``mesh`` (``parallel.sharding.make_mesh``):
        shard s's rows live on the mesh's device s, and top-k queries scan
        every shard on its device with this index's engines and merge the
        candidates on the first (``parallel.sharding.sharded_topk``). add /
        delete keep full swap-with-last semantics: row writes land in the
        shard that owns the row, and capacity growth re-shards.
        Single-value only (the per-label slot scatter-min is not sharded)."""
        if self.multi:
            raise ValueError("sharded mode supports single-value indexes")
        with self._lock:
            self.mesh = mesh
            self.store.set_sharding(mesh)
        return self

    # ------------------------------------------------------------------
    # Write path
    # ------------------------------------------------------------------

    def add_vector(self, blob: np.ndarray, label: int) -> int:
        with self._lock:
            rows = self.preprocess_storage(blob)
            rows["label"] = np.asarray([label], dtype=np.int64)
            if self.multi:
                # Multi: always a fresh row.
                idx = int(self.store.append(rows)[0])
                slot = self.labels.add(label, idx)
                self.store.host["slot"][idx] = slot
                self.store.mark_dirty(idx, "slot")  # slot written after append
                return 1
            existing = self.labels.ids_of(label)
            if existing:
                # Overwrite in place (brute_force_single.h:135 update path).
                idx = existing[0]
                self.store.set_row(idx, {k: v[0] for k, v in rows.items()})
                return 0
            idx = int(self.store.append(rows)[0])
            self.labels.add(label, idx)
            return 1

    def add_vector_batch(self, vecs: np.ndarray, labels) -> int:
        """Bulk insert: fresh single-value labels append in ONE store batch;
        overwrites and multi-value fall back to per-vector semantics."""
        vecs = np.atleast_2d(np.asarray(vecs))
        labels = [int(l) for l in labels]
        with self._lock:
            fresh = (
                not self.multi
                and len(set(labels)) == len(labels)
                and not any(l in self.labels for l in labels)
            )
            if fresh:
                rows = self.preprocess_storage(vecs)
                rows["label"] = np.asarray(labels, dtype=np.int64)
                ids = self.store.append(rows)
                for l, i in zip(labels, ids):
                    self.labels.add(l, int(i))
                return len(labels)
        return sum(self.add_vector(v, l) for v, l in zip(vecs, labels))

    def delete_vector(self, label: int) -> int:
        with self._lock:
            ids = self.labels.remove_label(label)
            if not ids:
                return 0
            for idx in ids:  # descending for multi
                self._swap_delete_row(idx)
            self.store.maybe_shrink()
            return len(ids)

    def _swap_delete_row(self, idx: int) -> None:
        last = self.store.count - 1
        moved_label = int(self.store.host["label"][last])
        self.store.swap_delete(idx)
        if idx != last:
            # The row that moved into `idx` belongs to `moved_label`.
            if self.multi:
                self.labels.on_swap(moved_label, last, idx)
            else:
                self.labels.on_swap(moved_label, idx)

    # ------------------------------------------------------------------
    # Read path
    # ------------------------------------------------------------------

    def _empty_reply(self, code=VecSimQueryReplyCode.OK) -> QueryReply:
        return make_reply([], [], code)

    def topk_query(
        self, query: np.ndarray, k: int, params: Optional[VecSimQueryParams] = None
    ) -> QueryReply:
        replies = self.topk_query_batch(np.asarray(query).reshape(1, -1), k, params)
        return replies[0]

    def topk_query_batch(
        self, queries: np.ndarray, k: int, params: Optional[VecSimQueryParams] = None
    ) -> list[QueryReply]:
        self.last_mode = VecSearchMode.STANDARD_KNN
        budget = TimeoutBudget(params.timeoutCtx if params else None)
        if budget.expired():
            return [self._empty_reply(VecSimQueryReplyCode.TimedOut) for _ in range(len(queries))]
        count = self.store.count
        nq = len(queries)
        if count == 0 or k <= 0:
            return [self._empty_reply() for _ in range(nq)]
        q, qnorms = self.preprocess_queries(queries)
        with self._lock:
            if self.multi:
                out = self._topk_multi(q, qnorms, k, nq, budget)
            else:
                out = self._topk_single(q, qnorms, k, nq, budget)
        if budget.expired():
            for r in out:
                r.code = VecSimQueryReplyCode.TimedOut
        return out

    def _search(self, qd: torch.Tensor, qn, dev: dict, k: int):
        """Top-k of a preprocessed device batch over the synced store: the
        sharded scan in the row-sharded mode, else ``engine_topk``. Returns
        device (dists [B, k], row ids [B, k])."""
        data, aux = self.store_tuple(dev)
        if self.mesh is not None:
            from ..parallel.sharding import sharded_topk

            return sharded_topk(qd, (data, aux), self.store.count, k, metric=self.metric,
                                kind=self.store_kind, mesh=self.mesh, query_norms=qn)
        return engine_topk(qd, data, aux, self.store.count, k, metric=self.metric,
                           kind=self.store_kind, query_norms=qn)

    def search_knn_device(self, qd: torch.Tensor, k: int, *, qn=None):
        """Device-tensor top-k for device-resident query pipelines: ``qd``
        [B, dim] must be on the store's device (in the row-sharded mode, any
        device) and already preprocessed (normalized for float cosine;
        ``qn`` = query norms for int cosine). Returns DEVICE (dists [B, k'],
        ids [B, k']) with row ids, not labels, where k' = min(k, count); in
        the row-sharded mode on the mesh's first device."""
        with self._lock:
            k = min(k, max(self.store.count, 1))
            return self._search(qd, qn, self.store.device_arrays(), k)

    def _topk_single(self, q, qnorms, k: int, nq: int, budget=None) -> list[QueryReply]:
        kk = min(k, self.store.count)
        dev = self.store.device_arrays()
        qd, qn = self.to_device(q), self.to_device(qnorms)
        if budget is not None and budget.ctx is not None and self.mesh is None:
            # Segmented scan with a timeout poll between segments — the
            # in-flight analog of the reference's per-vector VECSIM_TIMEOUT
            # check (brute_force.h:265). Stops with partial results (a
            # scanned prefix) once the callback fires.
            dists, ids = self._topk_single_segmented(qd, qn, dev, kk, budget)
        else:
            dists, ids = self._search(qd, qn, dev, kk)
        dists = dists.cpu().numpy()
        ids = ids.cpu().numpy()
        id_to_label = self.store.host["label"]
        out = []
        for b in range(nq):
            valid = ids[b] >= 0
            out.append(make_reply(id_to_label[ids[b][valid]], dists[b][valid]))
        return out

    def _topk_single_segmented(self, qd, qn, dev, k, budget):
        # The poll granularity bounds rows per segment: a chunk larger than
        # timeout_poll_rows would scan past the budget before the callback
        # can fire (the prefix contract of partial results).
        poll = max(config.timeout_poll_rows, 1)
        kpad = min(pow2_bucket(k), self.store.capacity)  # the JAX package's chunk floor
        chunk = max(min(_SCAN_CHUNK, self.store.capacity, poll), kpad)
        n_chunks = max(1, -(-self.store.capacity // chunk))
        seg = max(1, poll // chunk)
        best = None
        store = self.store_tuple(dev)
        for s0 in range(0, n_chunks, seg):
            best = streaming_topk(
                qd, store, self.store.count, k, metric=self.metric,
                kind=self.store_kind, chunk=chunk, query_norms=qn,
                seg_chunks=seg, start_chunk=s0, best_init=best,
            )
            # Let the segment finish before polling: the host would
            # otherwise race ahead of the device.
            best[0][:1, :1].cpu()
            if budget.expired():
                break
        return best

    def _topk_multi(self, q, qnorms, k: int, nq: int, budget=None) -> list[QueryReply]:
        slot_cap = pow2_bucket(max(self.labels.num_slots, 1))
        dev = self.store.device_arrays()
        kk = min(k, len(self.labels))
        kpad = min(pow2_bucket(max(kk, 1)), slot_cap)
        # The [B, N] score matrix is materialized for the slot scatter-min;
        # chunk the query batch so memory stays bounded on big stores.
        q_chunk = max(1, (1 << 25) // max(self.store.capacity, 1))  # ~128MB f32
        d_parts, s_parts = [], []
        for s in range(0, nq, q_chunk):
            scores = full_scores(
                self.to_device(q[s : s + q_chunk]),
                self.store_tuple(dev),
                self.store.count,
                metric=self.metric,
                kind=self.store_kind,
                query_norms=None if qnorms is None else self.to_device(qnorms[s : s + q_chunk]),
            )
            dd, ss = topk_by_slot(scores, dev["slot"], slot_cap, kpad)
            d_parts.append(dd.cpu().numpy())
            s_parts.append(ss.cpu().numpy())
            if budget is not None and budget.expired():
                # Partial results: queries not yet scored get empty rows.
                pad = nq - len(np.concatenate(d_parts))
                if pad > 0:
                    d_parts.append(np.full((pad, kpad), np.inf, np.float32))
                    s_parts.append(np.full((pad, kpad), -1, np.int64))
                break
        dists = np.concatenate(d_parts)[:nq]
        slot_ids = np.concatenate(s_parts)[:nq]
        out = []
        for b in range(nq):
            valid = np.isfinite(dists[b])
            labels = [self.labels.label_of_slot(int(s)) for s in slot_ids[b][valid][:kk]]
            out.append(make_reply(labels, dists[b][valid][:kk]))
        return out

    def _scores_one(self, query: np.ndarray):
        """(scores [1, N] on the device, synced device tensors) of one query.
        In the row-sharded mode each shard scores its rows on its device and
        the scores are gathered on the mesh's first device."""
        q, qnorms = self.preprocess_queries(np.asarray(query).reshape(1, -1))
        dev = self.store.device_arrays()
        qd, qn = self.to_device(q), self.to_device(qnorms)
        if self.mesh is None:
            return full_scores(qd, self.store_tuple(dev), self.store.count, metric=self.metric,
                               kind=self.store_kind, query_norms=qn), dev
        parts, cols = [], self.store_tuple(dev)
        shard_n = cols[0].shard_n
        for s, d in enumerate(self.mesh.devices):
            live = max(0, min(self.store.count - s * shard_n, shard_n))
            sc = full_scores(qd.to(d), tuple(None if c is None else c.shard(s) for c in cols), live,
                             metric=self.metric, kind=self.store_kind,
                             query_norms=None if qn is None else qn.to(d))
            parts.append(sc.to(self.mesh.devices[0]))
        return torch.cat(parts, dim=1), dev

    def range_query(
        self,
        query: np.ndarray,
        radius: float,
        params: Optional[VecSimQueryParams] = None,
        order: QueryReplyOrder = QueryReplyOrder.BY_SCORE,
    ) -> QueryReply:
        self.last_mode = VecSearchMode.RANGE_QUERY
        budget = TimeoutBudget(params.timeoutCtx if params else None)
        if budget.expired():
            return self._empty_reply(VecSimQueryReplyCode.TimedOut)
        if self.store.count == 0:
            return self._empty_reply()
        scores, dev = self._scores_one(query)
        if self.multi:
            slot_cap = pow2_bucket(max(self.labels.num_slots, 1))
            per_slot = slot_min_scores(scores, dev["slot"], slot_cap)[0].cpu().numpy()
            hit = np.where(per_slot <= radius)[0]
            labels = np.asarray([self.labels.label_of_slot(int(s)) for s in hit], dtype=np.int64)
            reply = make_reply(labels, per_slot[hit])
        else:
            s = scores[0, : self.store.count].cpu().numpy()
            hit = np.where(s <= radius)[0]
            reply = make_reply(self.store.host["label"][hit], s[hit])
        if budget.expired():
            reply.code = VecSimQueryReplyCode.TimedOut
        return reply.sort(order)

    def get_distance_from(self, label: int, blob: np.ndarray) -> float:
        ids = self.labels.ids_of(label)
        if not ids:
            return float("nan")
        q, qnorms = self.preprocess_queries(np.asarray(blob).reshape(1, -1))
        qn = None if qnorms is None else qnorms[0]
        return min(self.host_distance(i, q[0], qn) for i in ids)

    def new_batch_iterator(self, query: np.ndarray, params: Optional[VecSimQueryParams] = None):
        from .bf_batch_iterator import BFBatchIterator

        return BFBatchIterator(self, query, params)

    def compute_all_scores(self, query: np.ndarray, params=None):
        """All (label, score) pairs — backing for the batch iterator.

        Single: returns (labels[count], scores[count]).
        Multi: returns per-label (labels[L], min-scores[L]).
        (``bf_batch_iterator.h:176-199`` computes all scores on first batch.)
        """
        scores, dev = self._scores_one(query)
        if self.multi:
            slot_cap = pow2_bucket(max(self.labels.num_slots, 1))
            per_slot = slot_min_scores(scores, dev["slot"], slot_cap)[0].cpu().numpy()
            live = np.where(np.isfinite(per_slot))[0]
            labels = np.asarray(
                [self.labels.label_of_slot(int(s)) for s in live], dtype=np.int64
            )
            return labels, per_slot[live]
        s = scores[0, : self.store.count].cpu().numpy()
        return self.store.host["label"][: self.store.count].copy(), s

    # ------------------------------------------------------------------
    # Hybrid-policy heuristic (brute_force.h:380-451, sklearn decision tree)
    # ------------------------------------------------------------------

    def prefer_adhoc_search(self, subset_size: int, k: int, initial_check: bool = False) -> bool:
        index_size = self.index_size
        subset_size = min(subset_size, index_size)
        d = self.dim
        r = 0.0 if index_size == 0 else subset_size / max(self.index_label_count, 1)
        if index_size <= 5500:
            res = True
        elif d <= 300:
            if r <= 0.15:
                res = True
            elif r <= 0.35:
                res = d > 75 and index_size <= 550000
            else:
                res = False
        else:
            if r <= 0.55:
                res = True
            elif d <= 750:
                res = False
            else:
                res = r <= 0.75
        self.last_mode = (
            (VecSearchMode.HYBRID_ADHOC_BF if initial_check else VecSearchMode.HYBRID_BATCHES_TO_ADHOC_BF)
            if res
            else VecSearchMode.HYBRID_BATCHES
        )
        return res

    # ------------------------------------------------------------------
    # Info
    # ------------------------------------------------------------------

    def basic_info(self):
        return self._basic_info(VecSimAlgo.BF)

    def stats_info(self) -> VecSimIndexStatsInfo:
        return VecSimIndexStatsInfo(memory=self.memory_bytes)

    def debug_info(self) -> VecSimIndexDebugInfo:
        return VecSimIndexDebugInfo(
            commonInfo=CommonInfo(
                basicInfo=self.basic_info(),
                indexSize=self.index_size,
                indexLabelCount=self.index_label_count,
                memory=self.memory_bytes,
                lastMode=self.last_mode,
            ),
            bfInfo=BfInfo(),
        )
