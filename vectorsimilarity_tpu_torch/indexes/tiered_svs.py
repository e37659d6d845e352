"""Tiered SVS: a flat frontend and a Vamana backend, with batch-migration
jobs.

Counterpart of ``vectorsimilarity_tpu/indexes/tiered_svs.py`` (reference:
``algorithms/svs/svs_tiered.h``). Unlike tiered HNSW's per-vector insert
jobs, SVS migrates in batches: the backend is first built once the flat
buffer reaches ``trainingTriggerThreshold`` (10 x 1024 by default,
vec_sim_common.h:53), and afterwards an update job drains the flat buffer
whenever it reaches ``updateTriggerThreshold`` (1024). The backend build of
a migration runs outside ``_glock`` (reads and writes go on against the
flat tier); deletes and overwrites that hit a label mid-copy are journaled
in ``_superseded`` and replayed when the migration completes: the landed
copies are tombstoned and the flat rows removed by op id, so every vector
written before a migration stays queryable throughout (the reference's
swap and deleted-label journals, svs_tiered.h:644-770).
"""

from __future__ import annotations

from typing import Any

import numpy as np

from ..core.interface import VecSimIndexBase
from ..types import (
    SVS_VAMANA_DEFAULT_TRAINING_THRESHOLD,
    SVS_VAMANA_DEFAULT_UPDATE_THRESHOLD,
    TieredIndexParams,
    VecSimWriteMode,
)
from ..utils.thread_pool import SharedSVSThreadPool
from .svs import SVSIndex
from .tiered import SVS_BATCH_UPDATE_JOB, SVS_GC_JOB, AsyncJob, TieredHNSWIndex


class TieredSVSIndex(TieredHNSWIndex):
    """BF frontend + SVS backend with threshold-triggered batch updates."""

    def __init__(self, params: TieredIndexParams, log_ctx: Any = None, *, device=None):
        super().__init__(params, log_ctx, device=device)
        sp = params.tieredSVSParams
        self.training_threshold = (
            sp.trainingTriggerThreshold or SVS_VAMANA_DEFAULT_TRAINING_THRESHOLD
        )
        self.update_threshold = sp.updateTriggerThreshold or SVS_VAMANA_DEFAULT_UPDATE_THRESHOLD
        self._update_scheduled = False

    def _make_backend(self, primary, device):
        return SVSIndex(primary.svsParams, primary.logCtx, device=device), primary.svsParams

    # ------------------------------------------------------------------
    # Write path: batch-threshold migration (svs_tiered.h:35-215)
    # ------------------------------------------------------------------

    def add_vector(self, blob: np.ndarray, label: int) -> int:
        blob = np.asarray(blob)
        if VecSimIndexBase.write_mode == VecSimWriteMode.InPlace and self.backend.index_size:
            # Direct backend inserts serialize with migrations, so the
            # completion journal can reason about the backend label set.
            with self._migrate_lock, self._glock:
                deleted = self.delete_vector(label) if not self.backend.multi else 0
                self.backend.add_vector_batch(blob.reshape(1, -1), [label])
                self.direct_hnsw_insertions += 1
                return 1 - deleted if not self.backend.multi else 1
        with self._glock:
            ret = 1
            if not self.backend.multi:
                if self._label_exists(label):
                    ret = 0
                if label in self._inflight:
                    # A mid-copy overwrite: the landed old copy is tombstoned
                    # at the migration's completion.
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
            job = self._maybe_schedule_update()
        if job is not None:
            self._submit([job])
        return ret

    def _maybe_schedule_update(self):
        """An update job when the flat buffer crossed its threshold (the
        training threshold while the backend is empty)."""
        if self._update_scheduled:
            return None
        threshold = (
            self.training_threshold if self.backend.index_size == 0 else self.update_threshold
        )
        if self.frontend.index_size >= threshold:
            self._update_scheduled = True
            return AsyncJob(SVS_BATCH_UPDATE_JOB, self)
        return None

    def _execute_job(self, job: AsyncJob) -> None:
        with self._on_device():
            if job.job_type == SVS_BATCH_UPDATE_JOB:
                self._execute_batch_update()
            elif job.job_type == SVS_GC_JOB:
                self.run_gc()
            else:
                self._execute_insert_job(job)

    def _execute_batch_update(self) -> None:
        """Drain the flat buffer into the backend in one batch
        (svs_tiered.h:644-770 ``updateSVSIndex``), bracketed as one
        scheduled job on the shared SVS pool (the ``SVSMultiThreadJob``
        rendezvous, svs_tiered.h:35-215): a shrink of the pool issued
        meanwhile waits until it ends, so no slot the batch build may rent
        goes away mid-job."""
        pool = SharedSVSThreadPool.instance()
        pool.begin_scheduled_job()
        try:
            self._execute_batch_update_job()
        finally:
            pool.end_scheduled_job()

    def _execute_batch_update_job(self) -> None:
        with self._migrate_lock:
            with self._glock:
                self._update_scheduled = False
                fe = self.frontend
                count = fe.store.count
                if count == 0 or fe.index_size == 0:
                    return
                vecs = fe.store.host["data"][:count].copy()
                labels = fe.store.host["label"][:count].copy()
                opids = fe.store.host["opid"][:count].copy() if fe.multi else None
                mig_labels = sorted({int(l) for l in labels})
                for lab in mig_labels:
                    self._inflight[lab] = self._inflight.get(lab, 0) + 1
            self.backend.add_vector_batch(vecs, labels.tolist())
            with self._glock:
                self.migrations += 1
                for lab in mig_labels:
                    self._inflight[lab] -= 1
                    if not self._inflight[lab]:
                        del self._inflight[lab]
                for lab in mig_labels:
                    if lab in self._superseded:
                        # Journal replay: deleted or overwritten mid-copy. A
                        # flat row of the label holds a NEWER value; tombstone
                        # what just landed and leave the flat tier alone.
                        self._superseded.discard(lab)
                        if lab in self.backend.labels:
                            self._mark_delete_backend(lab)
                        continue
                    if fe.multi:
                        for op in opids[labels == lab]:
                            self._remove_one_from_flat(lab, int(op))
                    else:
                        fe.delete_vector(lab)
        # Mid-copy adds may have refilled the flat buffer past a threshold;
        # checked outside the migrate lock (a synchronous submit would
        # re-enter the update).
        with self._glock:
            job = self._maybe_schedule_update()
        if job is not None:
            self._submit([job])

    def flush(self) -> None:
        """Migrate every pending flat vector now."""
        with self._on_device():
            self._execute_batch_update()
