"""Tiered index: a flat frontend (fast writes) and an HNSW or SVS backend
(fast reads), with host-side asynchronous ingestion.

Counterpart of ``vectorsimilarity_tpu/indexes/tiered.py`` (reference:
``vec_sim_tiered_index.h:26-444`` + ``algorithms/hnsw/hnsw_tiered.h``). The
inversion-of-control contract is kept: the index owns no threads; it submits
``AsyncJob``s through the caller's
``submitCb(job_queue, job_queue_ctx, jobs, callbacks)``
(``vec_sim_common.h:131-141``) and the caller decides when and where they
run (``utils/thread_pool.py`` has a pool). Without a ``submitCb`` every job
runs at once, inline.

Write path (``hnsw_tiered.h:719-818``): a vector lands in the flat buffer
and an insert job is queued; one executed job migrates every pending vector,
up to ``config.tiered_migrate_batch``, in one backend batch. Overwrites
invalidate pending jobs; deletes invalidate jobs, tombstone the backend
(``mark_delete``) and count swap work, applied in one bulk pass once
``swapJobThreshold`` is reached (``executeReadySwapJobs``,
``hnsw_tiered.h:332-362``) or by ``run_gc``. The backend build of a
migration runs outside ``_glock`` (lock order ``_migrate_lock`` ->
``_glock``); a delete or overwrite of a label whose copies are mid-migration
is journaled in ``_superseded`` and applied when the migration completes.
Reads query both tiers and merge with per-label dedup (``topKQueryImp``,
``vec_sim_tiered_index.h:169-219``).

Both tiers keep their stores on one device: the current CUDA device by
default, the CPU only on request. A job enters that device on the worker
thread that runs it.

The tiered SVS index (``tiered_svs.py``) keeps this class's frontend, reads,
deletes and GC, and replaces the backend (``_make_backend``) and the write
path (batch migrations at thresholds).
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Optional

import numpy as np
import torch

from .. import config
from ..core.interface import VecSimIndexBase
from ..core.results import QueryReply, merge_replies
from ..core.store import FieldSpec
from ..types import (
    DEFAULT_BLOCK_SIZE,
    BFParams,
    CommonInfo,
    QueryReplyOrder,
    TieredIndexParams,
    TieredInfo,
    VecSimAlgo,
    VecSimIndexBasicInfo,
    VecSimIndexDebugInfo,
    VecSimIndexStatsInfo,
    VecSimQueryParams,
    VecSimQueryReplyCode,
    VecSimWriteMode,
)
from .brute_force import BruteForceIndex
from .factory import _with_defaults_hnsw
from .hnsw import HNSWIndex

# Job types (vec_sim_common.h:271-282). Tiered HNSW's GC runs inline, at the
# swap-job threshold or by run_gc, so its insert jobs are the only ones it
# submits; tiered SVS submits batch updates.
HNSW_INSERT_VECTOR_JOB = 0
SVS_BATCH_UPDATE_JOB = 5
SVS_GC_JOB = 6

DEFAULT_PENDING_SWAP_JOBS_THRESHOLD = 1024
MAX_PENDING_SWAP_JOBS_THRESHOLD = 100_000


class AsyncJob:
    """A unit of background work (vec_sim_tiered_index.h:26-77)."""

    __slots__ = ("job_type", "index", "is_valid", "payload")

    def __init__(self, job_type: int, index, payload=None):
        self.job_type = job_type
        self.index = index
        self.is_valid = True
        self.payload = payload

    def execute(self) -> None:
        if self.is_valid:
            self.index._execute_job(self)


class TieredHNSWIndex(VecSimIndexBase):
    """BF frontend + HNSW backend with asynchronous insert and delete jobs."""

    def __init__(self, params: TieredIndexParams, log_ctx: Any = None, *, device=None):
        super().__init__(log_ctx)
        primary = params.primaryIndexParams
        self.backend, hp = self._make_backend(primary, device)
        self.device = self.backend.device
        self.frontend = BruteForceIndex(
            BFParams(
                type=hp.type,
                dim=hp.dim,
                metric=hp.metric,
                multi=hp.multi,
                blockSize=hp.blockSize or DEFAULT_BLOCK_SIZE,
            ),
            primary.logCtx,
            device=self.device,
        )
        self.params = params
        self.flat_buffer_limit = params.flatBufferLimit or (1 << 30)
        thr = params.tieredHnswParams.swapJobThreshold or DEFAULT_PENDING_SWAP_JOBS_THRESHOLD
        self.swap_job_threshold = min(thr, MAX_PENDING_SWAP_JOBS_THRESHOLD)
        self._submit_cb = params.submitCb
        self._job_queue = params.jobQueue
        self._job_queue_ctx = params.jobQueueCtx
        # label -> pending insert jobs (invalidation, hnsw_tiered.h:514-521)
        self._insert_jobs: dict[int, list[AsyncJob]] = {}
        self._pending_swaps = 0  # tombstoned nodes awaiting removal
        self.direct_hnsw_insertions = 0
        self.migrations = 0  # backend batches migrated from the flat tier
        self._glock = threading.RLock()
        # Migration journal (the svs_tiered.h:644-770 idea): the backend
        # build runs OUTSIDE _glock, so reads and writes are not stalled
        # behind it; deletes and overwrites that hit a label while its copies
        # are mid-copy are recorded in _superseded and applied when the
        # migration completes.
        self._migrate_lock = threading.Lock()  # one migration at a time
        self._inflight: dict[int, int] = {}  # label -> copies mid-migration
        self._superseded: set[int] = set()
        self._op_counter = 0
        if self.frontend.multi:
            # Per-row insert-op id: a migration removes EXACTLY the flat row
            # its job inserted (duplicate blobs are indistinguishable by
            # content; rows move under swap-with-last).
            self.frontend.store.add_field("opid", FieldSpec((), np.int64, fill=-1))

    def _make_backend(self, primary, device):
        """(backend index, its params) of ``primary``."""
        hp = _with_defaults_hnsw(primary.hnswParams)
        return HNSWIndex(hp, primary.logCtx, device=device), hp

    def _on_device(self):
        """The index's CUDA device as the current one (a worker thread
        starts on device 0); nothing on the CPU."""
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    # ------------------------------------------------------------------
    # Job submission / execution
    # ------------------------------------------------------------------

    def _submit(self, jobs: list[AsyncJob]) -> None:
        if self._submit_cb is None:
            # No host queue: run synchronously (read-your-writes trivially).
            for j in jobs:
                j.execute()
            return
        self._submit_cb(self._job_queue, self._job_queue_ctx, jobs, [AsyncJob.execute] * len(jobs))

    def _execute_job(self, job: AsyncJob) -> None:
        with self._on_device():
            self._execute_insert_job(job)

    def _execute_insert_job(self, job: AsyncJob) -> None:
        with self._migrate_lock:
            with self._glock:
                if not job.is_valid:
                    return
                # Coalesce: this job and the other pending valid insert jobs
                # migrate in ONE backend batch (the reference moves one
                # vector per job, hnsw_tiered.h:547-606). The jobs taken
                # become no-ops via is_valid.
                batch = [job]
                cap = max(min(config.tiered_migrate_batch, config.build_batch), 1)
                for jobs in self._insert_jobs.values():
                    for j in jobs:
                        if j.is_valid and j is not job:
                            batch.append(j)
                            if len(batch) >= cap:
                                break
                    if len(batch) >= cap:
                        break
                for j in batch:
                    label = j.payload[0]
                    jobs = self._insert_jobs.get(label)
                    if jobs and j in jobs:
                        jobs.remove(j)
                        if not jobs:
                            del self._insert_jobs[label]
                    j.is_valid = False
                    self._inflight[label] = self._inflight.get(label, 0) + 1
                labels = [j.payload[0] for j in batch]
                blobs = np.stack([j.payload[1].reshape(-1) for j in batch])
            # The graph build runs OUTSIDE the global lock (the reference
            # worker holds only mainIndexGuard here, hnsw_tiered.h:444-511):
            # queries go on and see these vectors in the flat tier until the
            # completion step below; the backend's own lock orders the build
            # against its searches.
            self.backend.add_vector_batch(blobs, labels)
            with self._glock:
                self.migrations += 1
                for j in batch:
                    self._remove_one_from_flat(j.payload[0], j.payload[2])
                for label in labels:
                    left = self._inflight[label] - 1
                    if left:
                        self._inflight[label] = left
                    else:
                        del self._inflight[label]
                for label in set(labels) & self._superseded:
                    if label not in self._inflight:
                        self._superseded.discard(label)
                        # Deleted or overwritten mid-copy: the copies just
                        # migrated are the label's only live backend rows
                        # (direct inserts hold _migrate_lock), so tombstone
                        # them now: the journal replay.
                        if label in self.backend.labels:
                            self._mark_delete_backend(label)

    def _remove_one_from_flat(self, label: int, opid: int) -> None:
        fe = self.frontend
        if fe.multi:
            # Remove exactly the row this op inserted; a concurrent delete
            # may have removed it already (journaled path): no-op.
            target = None
            for i in fe.labels.ids_of(label):
                if int(fe.store.host["opid"][i]) == opid:
                    target = i
                    break
            if target is None:
                return
            fe.labels.remove_id(label, target)
            fe._swap_delete_row(target)
            fe.store.maybe_shrink()
        else:
            if label in self._insert_jobs:
                # A mid-copy overwrite put a NEWER value in the flat row; it
                # stays visible until its own job migrates.
                return
            fe.delete_vector(label)

    # ------------------------------------------------------------------
    # Write path
    # ------------------------------------------------------------------

    def add_vector(self, blob: np.ndarray, label: int) -> int:
        blob = np.asarray(blob)
        if VecSimIndexBase.write_mode == VecSimWriteMode.InPlace:
            # hnsw_tiered.h:724-741. Direct backend inserts serialize with
            # migrations (lock order: _migrate_lock -> _glock) so the
            # completion journal can reason about the backend label set.
            with self._migrate_lock, self._glock:
                deleted = self.delete_vector(label) if not self.backend.multi else 0
                self.backend.add_vector_batch(blob.reshape(1, -1), [label])
                self.direct_hnsw_insertions += 1
                return 1 - deleted if not self.backend.multi else 1
        with self._glock:
            flat_full = self.frontend.index_size >= self.flat_buffer_limit
            if not flat_full:
                ret, job = self._queue_async_insert(blob, label)
                self._maybe_execute_swaps()
        if flat_full:
            with self._migrate_lock, self._glock:
                if self.frontend.index_size >= self.flat_buffer_limit:
                    # Flat full: write straight into the backend
                    # (hnsw_tiered.h:742-760).
                    ret = 1
                    if not self.backend.multi and self._label_exists(label):
                        self.delete_vector(label)
                        ret = 0
                    self.backend.add_vector_batch(blob.reshape(1, -1), [label])
                    self.direct_hnsw_insertions += 1
                    return ret
                # A migration drained the flat buffer while we waited.
                ret, job = self._queue_async_insert(blob, label)
                self._maybe_execute_swaps()
        self._submit([job])
        return ret

    def _queue_async_insert(self, blob: np.ndarray, label: int):
        """Write to the flat tier and queue the insert job. _glock held."""
        ret = 1
        if not self.backend.multi:
            # Overwrite: invalidate pending jobs, purge old copies
            # (hnsw_tiered.h:766-805).
            if self._label_exists(label):
                ret = 0
            for j in self._insert_jobs.pop(label, []):
                j.is_valid = False
            if label in self._inflight:
                self._superseded.add(label)
            if label in self.frontend.labels:
                self.frontend.delete_vector(label)
            if label in self.backend.labels:
                self._mark_delete_backend(label)
        op = self._op_counter
        self._op_counter += 1
        self.frontend.add_vector(blob, label)
        if self.frontend.multi:
            fe = self.frontend
            fe.store.host["opid"][fe.store.count - 1] = op
        job = AsyncJob(HNSW_INSERT_VECTOR_JOB, self, (label, np.array(blob, copy=True), op))
        self._insert_jobs.setdefault(label, []).append(job)
        return ret, job

    def delete_vector(self, label: int) -> int:
        with self._glock:
            deleted = 0
            # Invalidate pending insert jobs and purge flat copies
            # (hnsw_tiered.h:823-851).
            for j in self._insert_jobs.pop(label, []):
                j.is_valid = False
            if label in self._inflight:
                # Copies are mid-migration: journal the delete; the
                # completion step tombstones them once they land.
                self._superseded.add(label)
            deleted += self.frontend.delete_vector(label)
            if label in self.backend.labels:
                if VecSimIndexBase.write_mode == VecSimWriteMode.InPlace:
                    deleted += self.backend.delete_vector(label)
                else:
                    deleted += self._mark_delete_backend(label)
            return deleted

    def _mark_delete_backend(self, label: int) -> int:
        ids = self.backend.mark_delete(label)
        self._pending_swaps += len(ids)
        self._maybe_execute_swaps()
        return len(ids)

    def _maybe_execute_swaps(self) -> None:
        if self._pending_swaps >= self.swap_job_threshold:
            self.run_gc()

    def run_gc(self) -> None:
        """Remove the tombstoned backend nodes (executeReadySwapJobs /
        VecSimTieredIndex_GC, hnsw_tiered.h:332-362, 230-235)."""
        with self._glock:
            be = self.backend
            count = be.store.count
            flagged = np.nonzero(be.store.host["flags"][:count] & 1)[0]
            if len(flagged) == 0:
                return
            self.log("verbose", f"tiered GC: removing {len(flagged)} tombstones")
            removed = be.delete_tombstoned_bulk(flagged)
            be.num_marked_deleted = max(0, be.num_marked_deleted - removed)
            self._pending_swaps = max(0, self._pending_swaps - removed)
            be.store.maybe_shrink()

    def _label_exists(self, label: int) -> bool:
        return label in self.frontend.labels or label in self.backend.labels

    # ------------------------------------------------------------------
    # Read path
    # ------------------------------------------------------------------

    def topk_query(
        self, query: np.ndarray, k: int, params: Optional[VecSimQueryParams] = None
    ) -> QueryReply:
        with self._glock:
            if self.frontend.index_size == 0:
                return self.backend.topk_query(query, k, params)
            flat = self.frontend.topk_query(query, k, params)
            if flat.code != VecSimQueryReplyCode.OK:
                return flat
            main = self.backend.topk_query(query, k, params)
            if main.code != VecSimQueryReplyCode.OK:
                return main
            return merge_replies(main, flat, k, with_set=True)

    def range_query(
        self,
        query: np.ndarray,
        radius: float,
        params: Optional[VecSimQueryParams] = None,
        order: QueryReplyOrder = QueryReplyOrder.BY_SCORE,
    ) -> QueryReply:
        with self._glock:
            flat = self.frontend.range_query(query, radius, params, QueryReplyOrder.BY_SCORE)
            if flat.code != VecSimQueryReplyCode.OK:
                return flat
            main = self.backend.range_query(query, radius, params, QueryReplyOrder.BY_SCORE)
            if main.code != VecSimQueryReplyCode.OK:
                return main
            merged = merge_replies(main, flat, max(len(flat) + len(main), 1), with_set=True)
            return merged.sort(order)

    def topk_query_batch(self, queries, k, params=None):
        """Batched tiered read: one batched search per tier under the global
        lock, the label-dedup merge per query outside it."""
        queries = np.atleast_2d(queries)
        with self._glock:
            flats = (
                None
                if self.frontend.index_size == 0
                else self.frontend.topk_query_batch(queries, k, params)
            )
            mains = self.backend.topk_query_batch(queries, k, params)
        if flats is None:
            return mains
        out = []
        for main, flat in zip(mains, flats):
            if flat.code != VecSimQueryReplyCode.OK:
                out.append(flat)
            elif main.code != VecSimQueryReplyCode.OK:
                out.append(main)
            else:
                out.append(merge_replies(main, flat, k, with_set=True))
        return out

    def get_distance_from(self, label: int, blob: np.ndarray) -> float:
        d1 = self.frontend.get_distance_from(label, blob)
        d2 = self.backend.get_distance_from(label, blob)
        candidates = [d for d in (d1, d2) if not np.isnan(d)]
        return min(candidates) if candidates else float("nan")

    def new_batch_iterator(self, query: np.ndarray, params: Optional[VecSimQueryParams] = None):
        from .tiered_batch_iterator import TieredBatchIterator

        return TieredBatchIterator(self, query, params)

    def prefer_adhoc_search(self, subset_size: int, k: int, initial_check: bool = False) -> bool:
        # Delegate to the bigger tier (vec_sim_tiered_index.h policy).
        bigger = self.backend.index_size >= self.frontend.index_size
        tier = self.backend if bigger else self.frontend
        res = tier.prefer_adhoc_search(subset_size, k, initial_check)
        self.last_mode = tier.last_mode
        return res

    # ------------------------------------------------------------------
    # Size / info
    # ------------------------------------------------------------------

    @property
    def index_size(self) -> int:
        with self._glock:
            # Labels may live in both tiers for a while; count them once.
            overlap = sum(
                1
                for lab in set(self._insert_jobs) | set(self._inflight)
                if lab in self.frontend.labels and lab in self.backend.labels
            )
            return self.frontend.index_size + self.backend.index_size - overlap

    @property
    def index_label_count(self) -> int:
        with self._glock:
            fl = set(self.frontend.labels.label_to_ids if self.frontend.multi
                     else self.frontend.labels.label_to_id)
            bl = set(self.backend.labels.label_to_ids if self.backend.multi
                     else self.backend.labels.label_to_id)
            return len(fl | bl)

    def basic_info(self) -> VecSimIndexBasicInfo:
        info = self.backend.basic_info()
        info.isTiered = True
        return info

    def stats_info(self) -> VecSimIndexStatsInfo:
        return VecSimIndexStatsInfo(
            memory=self.frontend.stats_info().memory + self.backend.stats_info().memory,
            numberOfMarkedDeleted=self.backend.num_marked_deleted,
            directHNSWInsertions=self.direct_hnsw_insertions,
            flatBufferSize=self.frontend.index_size,
        )

    def debug_info(self) -> VecSimIndexDebugInfo:
        be = self.backend.debug_info()
        fe = self.frontend.debug_info()
        common = CommonInfo(
            basicInfo=self.basic_info(),
            indexSize=self.index_size,
            indexLabelCount=self.index_label_count,
            memory=fe.commonInfo.memory + be.commonInfo.memory,
            lastMode=self.last_mode,
        )
        return VecSimIndexDebugInfo(
            commonInfo=common,
            tieredInfo=TieredInfo(
                backendInfo=be.hnswInfo,
                backendCommonInfo=be.commonInfo,
                frontendCommonInfo=fe.commonInfo,
                management_layer_memory=4096,
                backgroundIndexing=bool(self._insert_jobs or self._inflight),
                bufferLimit=self.flat_buffer_limit,
                specificTieredBackendInfo={"pendingSwapJobsThreshold": self.swap_job_threshold},
            ),
        )


def create_tiered_index(params: TieredIndexParams, log_ctx: Any = None, *, device=None):
    """The tiered index of ``params.primaryIndexParams``' algorithm on
    ``device`` (the current CUDA device by default, the CPU only on
    request)."""
    primary = params.primaryIndexParams
    if primary is None:
        raise ValueError("tiered index requires primaryIndexParams")
    if primary.algo == VecSimAlgo.HNSWLIB:
        return TieredHNSWIndex(params, log_ctx, device=device)
    if primary.algo == VecSimAlgo.SVS:
        from .tiered_svs import TieredSVSIndex

        return TieredSVSIndex(params, log_ctx, device=device)
    raise ValueError(f"tiered backend must be HNSW or SVS, got {primary.algo}")
