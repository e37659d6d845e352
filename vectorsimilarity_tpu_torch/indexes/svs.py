"""SVS-Vamana index — a single-level proximity graph with alpha pruning,
built and searched on the device.

Counterpart of ``vectorsimilarity_tpu/indexes/svs.py`` (the reference wraps
Intel ScalableVectorSearch, ``algorithms/svs/svs.h:76-815``: a
MutableVamanaIndex of degree ``graph_max_degree``, construction window
``construction_window_size``, alpha-robust pruning and LVQ / LeanVec
compression):

  - one flat adjacency (``links`` [cap, R]) searched by ``beam_search``
    from a medoid entry point;
  - construction: batched candidate beams and ``diversity_prune`` with the
    Vamana rule (alpha * d(kept, c) < d(q, c) discards; alpha 1.2 for L2,
    0.95 for IP-like metrics, vec_sim_common.h:41-42), on the device
    (``ops/graph_build.py`` ``vamana_connect``);
  - compression (``quantBits``, vec_sim_common.h:170-179): NONE keeps the
    raw type; Scalar and Q8 store SQ8 codes, Q4 split-packed 4-bit codes,
    both searched with the asymmetric distance; Q4x4 / Q4x8 add a residual
    level that re-ranks the search window (two-level LVQ); the LeanVec
    modes search a PCA-projected primary space of ``leanvec_dim`` and
    re-rank with a full-dimension SQ8 secondary. Every re-rank is one
    gather and product per layer (``ops/quantize.py``
    ``gathered_recon_dists``).

Deletes repair referrers by a re-prune over (their links + the deleted
node's links) and remove the row by swap-with-last; referrers are found by
scans of the host link arrays (``native_bridge.find_referrers``). A
tombstone (``mark_delete``) stays traversable until removed.

With ``config.graph_build_device = False`` a batch goes through the
host-orchestrated construction (the JAX package's reference path): the beam,
pair distances and prune run on the device, the chosen links are written
into the host mirrors and the reverse edges appended there
(``native_bridge.apply_reverse_edges``), overflowing rows re-pruned on the
device.

``to_query_sharded(mesh)`` cuts batch searches over a mesh of devices
(slice i on device i, against a replica of the graph there), and
``bulk_build_device(..., _deferred=True)`` yields once per build segment, for
the data-sharded ``parallel.sharded_graph.ShardedVamana``.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from .. import config
from .. import native_bridge
from ..core.abstract_index import DeviceVectorIndex, pow2_bucket
from ..core.interface import TimeoutBudget
from ..core.results import QueryReply, filter_results_by_id, make_reply
from ..core.store import FieldSpec, _bucket_capacity
from ..ops import graph_build
from ..ops.graph_search import StoreCtx, beam_search, dists_to_ids, diversity_prune_chunked
from ..ops.quantize import (
    gathered_recon_dists,
    leanvec_project,
    leanvec_train,
    residual_quantize,
    sq4_quantize,
    sq4_reconstruct,
    sq8_quantize,
    sq8_reconstruct,
)
from ..types import (
    CommonInfo,
    QueryReplyOrder,
    SVSParams,
    SvsInfo,
    SVS_VAMANA_DEFAULT_ALPHA_IP,
    SVS_VAMANA_DEFAULT_ALPHA_L2,
    SVS_VAMANA_DEFAULT_CONSTRUCTION_WINDOW_SIZE,
    SVS_VAMANA_DEFAULT_EPSILON,
    SVS_VAMANA_DEFAULT_GRAPH_MAX_DEGREE,
    SVS_VAMANA_DEFAULT_SEARCH_WINDOW_SIZE,
    VecSearchMode,
    VecSimAlgo,
    VecSimIndexDebugInfo,
    VecSimIndexStatsInfo,
    VecSimMetric,
    VecSimOptionMode,
    VecSimQueryParams,
    VecSimQueryReplyCode,
    VecSimSvsQuantBits,
)
from ..utils.thread_pool import SharedSVSThreadPool

FLAG_DELETED = 1


class SVSIndex(DeviceVectorIndex):
    """SVS-Vamana over a block store on ``device``: the current CUDA device
    by default, the CPU only on request."""

    def __init__(self, params: SVSParams, log_ctx: Any = None, *, device=None):
        self.R = params.graph_max_degree or SVS_VAMANA_DEFAULT_GRAPH_MAX_DEGREE
        self.L_build = (
            params.construction_window_size or SVS_VAMANA_DEFAULT_CONSTRUCTION_WINDOW_SIZE
        )
        self.ws = params.search_window_size or SVS_VAMANA_DEFAULT_SEARCH_WINDOW_SIZE
        self.epsilon = params.epsilon or SVS_VAMANA_DEFAULT_EPSILON
        metric = VecSimMetric(params.metric)
        self.alpha = params.alpha or (
            SVS_VAMANA_DEFAULT_ALPHA_L2 if metric == VecSimMetric.L2 else SVS_VAMANA_DEFAULT_ALPHA_IP
        )
        # The prune discards c when alpha * d(c, kept) < d(q, c): DiskANN's
        # robust-prune inequality, so alpha passes as it is.
        self._prune_alpha = self.alpha if self.alpha > 0 else 1.0

        quant = VecSimSvsQuantBits(params.quantBits)
        self.requested_quant = quant
        # The mode's own encoding: low byte = primary bits, second byte =
        # residual / secondary bits, third byte = LeanVec (Scalar is SQ8).
        qv = int(quant)
        self.primary_bits = 8 if quant == VecSimSvsQuantBits.Scalar else (qv & 0xFF)
        self.res_bits = (qv >> 8) & 0xFF
        self.is_leanvec = bool(qv >> 16)
        self.quantized = self.primary_bits in (4, 8)
        # Primary (graph) space: LeanVec projects to leanvec_dim (dim / 2 by
        # default, the LeanVec paper's operating point).
        self.pdim = max(1, params.leanvec_dim or params.dim // 2) if self.is_leanvec else params.dim
        self._P: Optional[torch.Tensor] = None  # LeanVec projection [dim, pdim]

        extra: dict[str, FieldSpec] = {
            "links": FieldSpec((self.R,), np.int32, fill=-1),
            "nlinks": FieldSpec((), np.int32),
            "flags": FieldSpec((), np.uint8),
        }
        if self.quantized:
            extra["vmin"] = FieldSpec((), np.float32)
            extra["delta"] = FieldSpec((), np.float32)
            if self.res_bits:
                extra["rvmin"] = FieldSpec((), np.float32)
                extra["rdelta"] = FieldSpec((), np.float32)
        super().__init__(
            vtype=params.type,
            dim=params.dim,
            metric=params.metric,
            multi=params.multi,
            block_size=params.blockSize,
            device=device,
            log_ctx=log_ctx,
            extra_fields=extra,
        )
        if self.quantized:
            # The store holds primary codes (two per byte at 4 bits) and the
            # per-row scales; queries stay fp32 whatever the vector type.
            self.data_dtype = None
            prow = (self.pdim + 1) // 2 if self.primary_bits == 4 else self.pdim
            self.store.fields["data"] = FieldSpec((prow,), np.uint8)
            self.store._resize(self.store.capacity)
            if self.res_bits:
                # Secondary codes: a full-dimension SQ8 for LeanVec, the
                # residual of the primary decode otherwise.
                rrow = (self.dim + 1) // 2 if self.res_bits == 4 else self.dim
                self.store.add_field("res", FieldSpec((rrow,), np.uint8))
            if self.metric == VecSimMetric.L2 and self.is_leanvec:
                # sum x^2 in the original space, for the re-rank (``sqnorm``
                # holds it in the primary space).
                self.store.add_field("rsq", FieldSpec((), np.float32))
            self.store_kind = "sq4" if self.primary_bits == 4 else "sq8"
        self.params = params
        self.entry_id = -1
        self.num_marked_deleted = 0
        self._inserts_since_medoid = 0
        self._host_links_stale = False  # device-built links not yet pulled
        self._build_dropped: list = []
        # The first SVS index attaches to the process-wide pool and applies
        # a resize asked for before it (svs_utils.h:509-518).
        SharedSVSThreadPool.instance().on_index_attached()

    # ------------------------------------------------------------------
    # Preprocessing (the quantizing storage pipeline)
    # ------------------------------------------------------------------

    def _quantize(self, full: torch.Tensor) -> dict[str, torch.Tensor]:
        """Store columns of fp32 rows ``full`` [n, dim] (normalized already
        for Cosine), on ``full``'s device. Trains the LeanVec projection on
        the first rows it sees."""
        if self.is_leanvec:
            if self._P is None:
                self._train_leanvec(full[:65536])
            prim = leanvec_project(full, self._P)
        else:
            prim = full
        quantize = sq4_quantize if self.primary_bits == 4 else sq8_quantize
        codes, vmin, delta, _, psumsq = quantize(prim)
        cols = {"data": codes, "vmin": vmin, "delta": delta}
        if "sqnorm" in self.store.fields:
            cols["sqnorm"] = psumsq.to(self.store.fields["sqnorm"].torch_dtype)
        if self.res_bits:
            if self.is_leanvec:
                # Secondary: an independent full-dimension quantization.
                res, rvmin, rdelta = residual_quantize(full, torch.zeros_like(full), self.res_bits)
                if "rsq" in self.store.fields:
                    cols["rsq"] = torch.sum(full * full, dim=-1)
            else:
                # Secondary: the residual of the primary decode (two-level LVQ).
                if self.primary_bits == 4:
                    recon = sq4_reconstruct(codes, vmin, delta, self.dim)
                else:
                    recon = sq8_reconstruct(codes, vmin, delta)
                res, rvmin, rdelta = residual_quantize(full, recon, self.res_bits)
            cols.update(res=res, rvmin=rvmin, rdelta=rdelta)
        return cols

    def preprocess_storage(self, blob: np.ndarray) -> dict[str, np.ndarray]:
        if not self.quantized:
            return super().preprocess_storage(blob)
        arr = np.asarray(blob, dtype=np.float32 if self.np_dtype != np.float64 else np.float64)
        if arr.ndim == 1:
            arr = arr[None, :]
        if self.metric == VecSimMetric.Cosine:
            arr = self._parallel_normalize(arr.astype(np.float32))
        full = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32)).to(self.device)
        return {name: t.cpu().numpy() for name, t in self._quantize(full).items()}

    def _train_leanvec(self, sample: torch.Tensor) -> None:
        """Learn the projection once, from the first ingested rows, and
        freeze it (the reference's tiered SVS trains LeanVec on a
        threshold-sized sample and keeps it)."""
        self._P = leanvec_train(sample, self.pdim)
        self.log("info", f"LeanVec projection trained: {self.dim} -> {self.pdim} "
                         f"on {int(sample.shape[0])} rows")

    def _parallel_normalize(self, arr: np.ndarray) -> np.ndarray:
        """Row normalization on the host, partitioned over the shared pool
        (the reference's parallel dataset copy-in, svs_utils.h:245); numpy
        releases the GIL in each part."""
        pool = SharedSVSThreadPool.instance()
        nparts = min(pool.size(), max(1, arr.shape[0] // 2048))
        if nparts <= 1:
            return self._normalize_rows(arr)
        out = np.empty_like(arr)
        bounds = np.linspace(0, arr.shape[0], nparts + 1).astype(int)

        def _part(i: int) -> None:
            lo, hi = bounds[i], bounds[i + 1]
            out[lo:hi] = self._normalize_rows(arr[lo:hi])

        pool.parallel_for(_part, nparts, device=self.device)
        return out

    def preprocess_queries(self, queries: np.ndarray):
        """(q, q_norms, q_meta) in the ORIGINAL space: the search projects
        into the LeanVec primary space itself (``_primary_queries``), so the
        re-rank and the ad-hoc scoring keep the full-dimension query."""
        if not self.quantized:
            q, qn = super().preprocess_queries(queries)
            return q, qn, None
        arr = np.asarray(queries, dtype=np.float32)
        if arr.ndim == 1:
            arr = arr[None, :]
        if self.metric == VecSimMetric.Cosine:
            arr = self._normalize_rows(arr)
        ysum = arr.sum(axis=-1, dtype=np.float32)
        ysumsq = (arr * arr).sum(axis=-1, dtype=np.float32)
        return arr, None, (ysum, ysumsq)

    def _primary_queries(self, qd: torch.Tensor):
        """Original-space device queries in the primary search space, with
        the asymmetric distance's metadata recomputed there."""
        if self.is_leanvec:
            qd = leanvec_project(qd, self._P)
        return qd, (torch.sum(qd, dim=-1), torch.sum(qd * qd, dim=-1))

    def _ctx(self, dev) -> StoreCtx:
        return StoreCtx(data=dev["data"], sqnorm=dev.get("sqnorm"), norm=dev.get("norm"),
                        vmin=dev.get("vmin"), delta=dev.get("delta"))

    # ------------------------------------------------------------------
    # Host link accessors
    # ------------------------------------------------------------------

    def _ensure_host_links(self) -> None:
        """Pull device-built links into the host mirrors (one bulk read).
        Queries and device construction never need this."""
        if not self._host_links_stale:
            return
        self._host_links_stale = False
        self.store.pull_host("links", "nlinks")

    def get_links(self, node: int) -> list[int]:
        self._ensure_host_links()
        n = int(self.store.host["nlinks"][node])
        return self.store.host["links"][node, :n].tolist()

    def set_links(self, node: int, ids: list[int]) -> None:
        assert len(ids) <= self.R
        self._ensure_host_links()
        row = self.store.host["links"][node]
        row[: len(ids)] = ids
        row[len(ids):] = -1
        self.store.host["nlinks"][node] = len(ids)
        self.store.mark_dirty(node, "links", "nlinks")

    # ------------------------------------------------------------------
    # Medoid entry point
    # ------------------------------------------------------------------

    def _update_medoid(self, limit: Optional[int] = None) -> None:
        """Entry point = the row closest to the mean of the first ``limit``
        rows (all by default): a bulk build takes the whole dataset at once
        but may only enter at rows that have links already. The first of
        equal minima wins, as ``jnp.argmin``."""
        count = self.store.count if limit is None else min(limit, self.store.count)
        if count == 0:
            self.entry_id = -1
            return
        rows = torch.arange(count, device=self.device)
        data = graph_build.anchor_queries(self._ctx(self.store.device_arrays()), rows,
                                          self.store_kind, self.metric)[0].to(torch.float32)
        mean = torch.sum(data, dim=0) / count
        d = torch.sum((data - mean[None, :]) ** 2, dim=-1)
        self.entry_id = int(torch.argmin(d))
        self._inserts_since_medoid = 0

    # ------------------------------------------------------------------
    # Write path
    # ------------------------------------------------------------------

    def add_vector(self, blob: np.ndarray, label: int) -> int:
        return self.add_vector_batch(np.asarray(blob).reshape(1, -1), [label])

    def add_vector_batch(self, vecs: np.ndarray, labels) -> int:
        """Batched insert, connected on the device; a live label of a
        single-value index is deleted first. The medoid is refreshed once
        the index grew by an eighth since the last refresh. Returns the
        number of new labels (single-value) or rows (multi)."""
        labels = [int(l) for l in labels]
        with self._lock:
            overwrite: list[int] = []
            if not self.multi:
                overwrite = [l for l in labels if l in self.labels]
                for l in overwrite:
                    self.delete_vector(l)
            rows = self.preprocess_storage(np.atleast_2d(np.asarray(vecs)))
            n = len(labels)
            rows["label"] = np.asarray(labels, dtype=np.int64)
            # A row slot freed by a swap-delete keeps the moved row's flags;
            # a new row starts live.
            rows["flags"] = np.zeros(n, dtype=np.uint8)
            ids = self.store.append(rows)
            for i, node in enumerate(ids):
                node = int(node)
                if self.multi:
                    self.store.host["slot"][node] = self.labels.add(labels[i], node)
                    self.store.mark_dirty(node, "slot")
                else:
                    self.labels.add(labels[i], node)
            if config.graph_build_device:
                self._connect_batch_device(np.asarray(ids, dtype=np.int32))
            else:
                self._connect_batch(np.asarray(ids, dtype=np.int32))
            self._inserts_since_medoid += n
            if self.entry_id < 0 or self._inserts_since_medoid * 8 > self.store.count:
                self._update_medoid()
            return n - len(overwrite)

    def _build_kw(self) -> dict:
        return dict(
            L=self.L_build,
            deg=self.R,
            metric=self.metric,
            kind=self.store_kind,
            alpha=self._prune_alpha,
            a_cap=config.build_reverse_cap,
            beam_expand=config.build_beam_expand,
        )

    def _connect_batch_device(self, ids: np.ndarray) -> None:
        """Connect a batch on the device, in power-of-two chunks of at most
        ``config.build_batch`` rows (the JAX package's chunks: a chunk's
        intra-batch candidates depend on them). The device link tensors
        become authoritative; host mirrors are pulled lazily."""
        n = len(ids)
        if n == 0:
            return
        dev = self.store.device_arrays()
        ctx = self._ctx(dev)
        state = graph_build.VamanaState(dev["links"], dev["nlinks"], self.entry_id)
        off = 0
        while off < n:
            c = 1
            while c * 2 <= n - off and c * 2 <= config.build_batch:
                c *= 2
            state, d = graph_build.vamana_connect(state, ctx, ids[off:off + c], **self._build_kw())
            self._build_dropped.append(d)
            off += c
        if self.entry_id < 0:
            # The device rule: an empty graph adopts the first id; the
            # medoid refresh after the first batch replaces it.
            self.entry_id = int(ids[0])
        self._adopt_links(state)

    def _adopt_links(self, state: graph_build.VamanaState) -> None:
        self.store._device["links"] = state.links
        self.store._device["nlinks"] = state.nlinks
        self.store.mark_host_stale("links", "nlinks")
        self._host_links_stale = True

    def build_dropped(self) -> int:
        """Reverse-edge pairs dropped by the device build's per-row cap
        (``apply_reverse_edges_device``); 0 in healthy builds."""
        total = sum(int(torch.as_tensor(d).sum()) for d in self._build_dropped)
        self._build_dropped = [total]
        return int(total)

    def bulk_build_device(
        self,
        data: torch.Tensor,
        n: Optional[int] = None,
        labels=None,
        *,
        batch: Optional[int] = None,
        scan_batches: Optional[int] = None,
        assume_normalized: bool = False,
        _deferred: bool = False,
    ):
        """Build the whole index from a dataset already on the index's device.

        ``data`` [N, dim] (or a larger buffer whose first ``n`` rows are the
        data) is normalized, LeanVec-projected and quantized on the device
        and adopted into the store (host mirrors stay unfilled,
        ``BlockStore.adopt_device``). The graph is built by
        ``graph_build.vamana_build_scan``, ``scan_batches`` batches of
        ``batch`` rows per call, with the medoid refreshed between calls
        once the built prefix grew by an eighth; the last batches go
        through the pow2 chunks of ``add_vector_batch``. The index must be
        empty; ``labels`` defaults to 0..N-1.

        ``_deferred=True`` checks and preprocesses, then returns a generator
        that launches one ``vamana_build_scan`` segment per ``next()``
        (``HNSWIndex.bulk_build_device``); the index's lock stays held until
        it is exhausted or closed, so the caller must exhaust it."""
        steps = self._bulk_build_steps(data, n, labels, batch=batch,
                                       scan_batches=scan_batches,
                                       assume_normalized=assume_normalized)
        next(steps)  # the checks and the preprocessing run now
        if _deferred:
            return steps
        for _ in steps:
            pass
        return None

    def _bulk_build_steps(self, data, n, labels, *, batch, scan_batches,
                          assume_normalized):
        """``bulk_build_device`` as a generator. One hold of the index's
        lock spans the checks, the preprocessing and every segment, so no
        query or write sees a half-built graph; it yields once after the
        preprocessing and once after each segment's launch."""
        with self._lock:
            if self.store.count:
                raise ValueError("bulk_build_device requires an empty index")
            if n is None:
                n = int(data.shape[0])
            batch = int(batch or config.build_batch)
            scan_batches = int(scan_batches or config.build_scan_batches)
            self._build_dropped = []
            cap = _bucket_capacity(n, self.store.block_size)
            dev = self.device

            def padded(x, fill):
                if x.shape[0] == cap:
                    return x
                out = torch.full((cap, *x.shape[1:]), fill, dtype=x.dtype, device=dev)
                out[:n] = x[:n]
                return out

            # --- device preprocessing ---
            adopt: dict = {}
            if self.quantized:
                full = data[:n].to(torch.float32)
                if self.metric == VecSimMetric.Cosine and not assume_normalized:
                    nrm = torch.linalg.vector_norm(full, dim=1, keepdim=True)
                    full = full / torch.where(nrm == 0, 1.0, nrm)
                for name, col in self._quantize(full).items():
                    adopt[name] = padded(col, 0)
                del full
            elif self.store_kind == "int":
                di = data[:n].to(torch.int64)
                ss = torch.sum(di * di, dim=1).to(torch.float32)
                if self.metric == VecSimMetric.Cosine:
                    adopt["norm"] = padded(torch.sqrt(ss), 1.0)
                if "sqnorm" in self.store.fields:
                    adopt["sqnorm"] = padded(ss, 0.0)
                adopt["data"] = padded(data[:n].to(self.store.fields["data"].torch_dtype), 0)
            else:
                dd = data[:n].to(self.store.fields["data"].torch_dtype)
                if self.metric == VecSimMetric.Cosine and not assume_normalized:
                    f = dd.to(torch.float32)
                    nrm = torch.linalg.vector_norm(f, dim=1, keepdim=True)
                    dd = (f / torch.where(nrm == 0, 1.0, nrm)).to(dd.dtype)
                if "sqnorm" in self.store.fields:
                    f = dd.to(self.store.fields["sqnorm"].torch_dtype)
                    adopt["sqnorm"] = padded(torch.sum(f * f, dim=1), 0.0)
                adopt["data"] = padded(dd, 0)
            adopt["links"] = torch.full((cap, self.R), -1, dtype=torch.int32, device=dev)
            adopt["nlinks"] = torch.zeros((cap,), dtype=torch.int32, device=dev)
            self.store.adopt_device(adopt, count=n)

            # --- host metadata (labels; vectors and codes stay on the device) ---
            labs = (np.arange(n, dtype=np.int64) if labels is None
                    else np.asarray(labels, dtype=np.int64))
            self.store.host["label"][:n] = labs
            if self.multi:
                for i in range(n):
                    self.store.host["slot"][i] = self.labels.add(int(labs[i]), i)
            else:
                self.labels.label_to_id = {int(l): i for i, l in enumerate(labs)}
            yield  # checked and preprocessed

            # --- construction: scan segments, medoid refreshes, pow2 tail ---
            devs = self.store.device_arrays()
            ctx = self._ctx(devs)
            state = graph_build.VamanaState(devs["links"], devs["nlinks"], -1)
            nb = n // batch
            pos = 0
            built_at_medoid = 0  # rows built at the last medoid refresh
            while nb - pos >= 2:
                T = min(scan_batches, nb - pos)
                off0 = pos * batch
                offsets = np.arange(off0, off0 + T * batch, batch)
                state, dropped = graph_build.vamana_build_scan(
                    state, ctx, offsets, n=batch, **self._build_kw()
                )
                yield
                self._build_dropped.append(dropped)
                pos += T
                built = pos * batch
                # The incremental path's growth rule: the entry must stay
                # among rows that have links already.
                if (built - built_at_medoid) * 8 > built or built_at_medoid == 0:
                    self._update_medoid(limit=built)
                    built_at_medoid = built
                    state.entry = self.entry_id
                self.log("debug", f"svs bulk build: {built}/{n}")
            self._adopt_links(state)
            if state.entry >= 0:
                self.entry_id = state.entry
            if pos * batch < n:
                self._connect_batch_device(np.arange(pos * batch, n, dtype=np.int32))
            self._update_medoid()

    def _connect_batch(self, ids: np.ndarray) -> None:
        """Connect a batch of stored rows with the links chosen on the
        device and written on the host (the JAX package's ``_connect_batch``):
        a beam of the construction window from the medoid entry (one
        candidate per step, ``searchLayer``), the intra-batch pair distances
        and one robust-alpha prune for the whole batch, then the reverse
        edges on the host. Quantized stores connect their primary-space
        decode (``graph_build.anchor_queries``)."""
        self._ensure_host_links()  # the links below are written on the host
        n = len(ids)
        dv = self.device
        dev = self.store.device_arrays()
        ctx = self._ctx(dev)
        batch_ids = np.asarray(ids, dtype=np.int32)
        ids_t = torch.from_numpy(batch_ids).to(dv)
        q, qn, qm = graph_build.anchor_queries(ctx, ids_t.long(), self.store_kind, self.metric)
        kw = dict(metric=self.metric, kind=self.store_kind, q_norm=qn)
        L = self.L_build
        beam_d = torch.full((n, L), torch.inf, device=dv)
        beam_i = torch.full((n, L), -1, dtype=torch.int32, device=dv)
        if self.entry_id >= 0:
            e = torch.full((n,), self.entry_id, dtype=torch.int32, device=dv)
            ed = dists_to_ids(q, e[:, None], ctx, q_meta=qm, **kw)[:, 0]
            beam_d, beam_i = beam_search(q, ctx, dev["links"], None, e, ed,
                                         self.store.capacity, ef=L, q_meta=qm, **kw)
        if n > 1:
            pair = dists_to_ids(q, ids_t[None, :].expand(n, n), ctx, q_meta=qm, **kw)
            pair = torch.where(torch.eye(n, dtype=torch.bool, device=dv), torch.inf, pair)
        else:
            pair = torch.full((1, 1), torch.inf, device=dv)
        ci = torch.cat([beam_i, ids_t[None, :].expand(n, n)], dim=1)
        cd = torch.cat([beam_d, pair], dim=1)
        sel = diversity_prune_chunked(q, ci, cd, ctx, m=self.R, alpha=self._prune_alpha,
                                      **kw).cpu().numpy()
        self.store.host["links"][batch_ids] = sel
        self.store.host["nlinks"][batch_ids] = (sel >= 0).sum(axis=1).astype(np.int32)
        for node in batch_ids.tolist():
            self.store.mark_dirty(node, "links", "nlinks")
        valid = sel >= 0
        pairs = np.column_stack(
            [sel[valid], np.broadcast_to(batch_ids[:, None], sel.shape)[valid]]
        ).astype(np.int32)
        self._apply_reverse_edges(pairs)

    def _apply_reverse_edges(self, pairs: np.ndarray) -> None:
        """Back-edges (neighbour, node) of a batch, appended in the host rows
        by ``native_bridge``; each row that overflows is re-pruned over its
        links and its new back-edges."""
        count = self.store.count
        overflow, dirty = native_bridge.apply_reverse_edges(
            self.store.host["links"][:count], self.store.host["nlinks"][:count], pairs)
        for r in np.unique(dirty).tolist():
            self.store.mark_dirty(r, "links", "nlinks")
        if len(overflow):
            over = set(overflow.tolist())
            pending: dict[int, list[int]] = {}
            for nb, node in pairs.tolist():
                if nb in over:
                    pending.setdefault(nb, []).append(node)
            self._reprune_rows([(nb, list(dict.fromkeys(self.get_links(nb) + fresh)))
                                for nb, fresh in pending.items()])

    def _reprune_rows(self, rows: list[tuple[int, list[int]]]) -> None:
        """Robust-alpha re-prune of (node, candidates) rows on the device;
        the chosen links are written on the host. The anchors are read on
        the device (the JAX package decodes host mirrors, which a bulk build
        leaves unfilled); the JAX package pads the rows to a power of two
        for its compile cache, the port runs them as they are."""
        dev = self.store.device_arrays()
        ctx = self._ctx(dev)
        C = pow2_bucket(max(max(len(c) for _, c in rows), 1))
        cand = np.full((len(rows), C), -1, dtype=np.int32)
        for bi, (_, c) in enumerate(rows):
            cand[bi, : len(c)] = c
        nodes = torch.tensor([r[0] for r in rows], dtype=torch.int64, device=self.device)
        q, qn, qm = graph_build.anchor_queries(ctx, nodes, self.store_kind, self.metric)
        sel = diversity_prune_chunked(
            q, torch.from_numpy(cand).to(self.device), None, ctx, m=self.R,
            metric=self.metric, kind=self.store_kind, alpha=self._prune_alpha,
            q_norm=qn, q_meta=qm,
        ).cpu().numpy()
        for bi, (node, _) in enumerate(rows):
            self.set_links(node, [int(x) for x in sel[bi] if x >= 0])

    # ------------------------------------------------------------------
    # Delete path
    # ------------------------------------------------------------------

    def delete_vector(self, label: int) -> int:
        with self._lock:
            ids = self.labels.remove_label(label)
            if not ids:
                return 0
            self._ensure_host_links()
            for node in sorted(ids, reverse=True):
                self._delete_node(node)
            self.store.maybe_shrink()
            if self.entry_id >= self.store.count:
                self._update_medoid()
            return len(ids)

    def _referrers(self, node: int) -> list[int]:
        """Rows with an edge -> node, ascending: a native scan of the host
        link array."""
        self._ensure_host_links()
        hit = native_bridge.find_referrers(self.store.host["links"], self.store.count, node)
        return [int(h) for h in hit]

    def _delete_node(self, node: int) -> None:
        # Repair each referrer: re-prune over (its links + node's links).
        repairs: list[tuple[int, list[int]]] = []
        own_links = self.get_links(node)
        for ref in self._referrers(node):
            if ref == node:
                continue
            own = [x for x in self.get_links(ref) if x != node]
            borrowed = [x for x in own_links if x != ref and x != node]
            cand = list(dict.fromkeys(own + borrowed))
            if not borrowed and len(cand) <= self.R:
                self.set_links(ref, cand)
            else:
                repairs.append((ref, cand))
        if repairs:
            self._reprune_rows(repairs)
        self._swap_remove(node)
        if self.entry_id == node or self.entry_id >= self.store.count:
            self._update_medoid()

    def _swap_remove(self, node: int) -> None:
        last = self.store.count - 1
        if node != last:
            # References to `last` become `node` before the row moves.
            for ref in self._referrers(last):
                links = [node if x == last else x for x in self.get_links(ref)]
                self.set_links(ref if ref != last else node, links)
            moved_label = int(self.store.host["label"][last])
            # A tombstoned row is no longer in the label map; only a live
            # row's move is recorded.
            if self.multi:
                if last in self.labels.label_to_ids.get(moved_label, ()):
                    self.labels.on_swap(moved_label, last, node)
            elif self.labels.label_to_id.get(moved_label) == last:
                self.labels.on_swap(moved_label, node)
            if self.entry_id == last:
                self.entry_id = node
        self.store.swap_delete(node)

    def mark_delete(self, label: int) -> list[int]:
        """Tombstone all rows of a label; they stay traversable."""
        with self._lock:
            ids = self.labels.remove_label(label)
            for node in ids:
                self.store.host["flags"][node] |= FLAG_DELETED
                self.store.mark_dirty(node, "flags")
                self.num_marked_deleted += 1
            return ids

    def _delete_node_tombstoned(self, node: int) -> None:
        """Remove one tombstoned row (its label entry is gone already)."""
        self.store.host["flags"][node] &= ~np.uint8(FLAG_DELETED)
        self.store.mark_dirty(node, "flags")
        self._delete_node(node)

    def delete_tombstoned_bulk(self, nodes) -> int:
        """Remove many tombstoned rows (the tiered index's GC): each as
        ``_delete_node_tombstoned``, highest id first, so a swap-with-last
        never moves a row still to be removed. Returns the number removed;
        ``num_marked_deleted`` is the caller's to lower. (The JAX package's
        SVS index has no bulk removal, so its tiered GC raises.)"""
        nodes = sorted({int(x) for x in nodes}, reverse=True)
        with self._lock:
            if not (self.store.host["flags"][nodes] & FLAG_DELETED).all():
                raise ValueError("bulk removal takes tombstoned nodes only")
            self._ensure_host_links()
            for node in nodes:
                self._delete_node_tombstoned(node)
            self.store.maybe_shrink()
            if self.entry_id >= self.store.count:
                self._update_medoid()
            return len(nodes)

    # ------------------------------------------------------------------
    # Read path
    # ------------------------------------------------------------------

    def _effective_ws(self, k: int, params: Optional[VecSimQueryParams]) -> int:
        ws = self.ws
        if params is not None and params.svsRuntimeParams.windowSize:
            ws = params.svsRuntimeParams.windowSize
        if params is not None and params.svsRuntimeParams.bufferCapacity:
            ws = max(ws, params.svsRuntimeParams.bufferCapacity)
        return max(ws, k)

    def search_knn(self, queries: np.ndarray, k: int, ef: int, *, mesh=None):
        """Device beam search of host queries; returns numpy (dists [B, ef'],
        ids [B, ef']) with row ids, ef' = min(pow2(max(ef, k)), pow2(count)).
        The JAX package splits high-ef batches into sub-batches; the port
        runs one batch (ROADMAP.md section 3). With a mesh (``mesh``, else
        ``to_query_sharded``'s) the batch is cut over its devices."""
        with self._lock:
            bd, bi = self._search_knn_locked(np.atleast_2d(queries), k, ef, mesh=mesh)
            return bd.cpu().numpy(), bi.cpu().numpy()

    def search_resumable(self, queries: np.ndarray, k: int, ef: int, state=None):
        """Resumable beam search for deep paging (``SVSBatchIterator``):
        pass the returned ``state`` back with a larger window to continue
        expanding without re-visiting nodes. Any index mutation invalidates
        the state."""
        with self._lock:
            bd, bi, st = self._search_knn_locked(
                np.atleast_2d(queries), k, ef, init_state=state, return_state=True,
            )
            return bd.cpu().numpy(), bi.cpu().numpy(), st

    def _search_knn_locked(self, queries: np.ndarray, k: int, ef: int,
                           *, init_state=None, return_state: bool = False, mesh=None):
        """The beam on the device; returns device tensors. The batch is
        padded to a power of two with copies of its last query and the beam
        width is ef rounded up to a power of two, as in the JAX package (the
        results depend on the width). A batch search (not a resumed one) is
        cut over the query mesh where there is one
        (``_maybe_shard_queries``)."""
        q, qnorms, qmeta = self.preprocess_queries(queries)
        nq = len(q)
        bpad = pow2_bucket(nq)
        if bpad != nq:
            pad = bpad - nq
            q = np.concatenate([q, np.repeat(q[-1:], pad, axis=0)])
            if qnorms is not None:
                qnorms = np.concatenate([qnorms, np.repeat(qnorms[-1:], pad)])
            if qmeta is not None:
                qmeta = tuple(np.concatenate([m, np.repeat(m[-1:], pad)]) for m in qmeta)
        qd = self.to_device(q)
        qn = None if qnorms is None else torch.from_numpy(qnorms).to(self.device)
        qm = None if qmeta is None else tuple(torch.from_numpy(m).to(self.device) for m in qmeta)
        if self.quantized:
            qd, qm = self._primary_queries(qd)  # the beam runs in the primary space
        if init_state is None and not return_state:
            bd, bi = self._maybe_shard_queries(
                lambda q_, n_, m_, dev: self._beam(q_, n_, m_, k, ef, device=dev),
                qd, qn, qm, mesh=mesh,
            )
            return bd[:nq], bi[:nq]
        bd, bi, state, _, _ = self._beam(qd, qn, qm, k, ef, init_state=init_state,
                                         return_state=True)
        return bd[:nq], bi[:nq], state

    def _beam(self, qd, qn, qm, k: int, ef: int, *, device=None, **kw):
        """The beam from the medoid entry on the index's device, or on
        ``device`` against a replica of the index's tensors there
        (``_replica``); ``kw`` carries ``beam_search``'s resume arguments."""
        dev = self.store.device_arrays()
        links, ctx = dev["links"], self._ctx(dev)
        if device is not None:
            r = self._replica(device, {"links": links, **ctx._asdict()})
            links, ctx = r["links"], StoreCtx(**{f: r[f] for f in StoreCtx._fields})
        e = torch.full((qd.shape[0],), self.entry_id, dtype=torch.int32, device=qd.device)
        ed = dists_to_ids(qd, e[:, None], ctx, metric=self.metric, kind=self.store_kind,
                          q_norm=qn, q_meta=qm)[:, 0]
        ef_pad = min(pow2_bucket(max(ef, k)), max(pow2_bucket(self.store.count), 1))
        return beam_search(
            qd, ctx, links, None, e, ed, self.store.capacity,
            ef=ef_pad, metric=self.metric, kind=self.store_kind, q_norm=qn, q_meta=qm,
            expand=config.resolve_search_expand(ef), **kw,
        )

    # ------------------------------------------------------------------
    # Re-rank (two-level / LeanVec secondary)
    # ------------------------------------------------------------------

    def _refine_layers(self, dev):
        """(layers, packed_flags, xsumsq) for ``gathered_recon_dists``."""
        if self.is_leanvec:
            return (((dev["res"], dev["rvmin"], dev["rdelta"]),), (self.res_bits == 4,),
                    dev.get("rsq"))
        return (
            ((dev["data"], dev["vmin"], dev["delta"]), (dev["res"], dev["rvmin"], dev["rdelta"])),
            (self.primary_bits == 4, self.res_bits == 4),
            dev.get("sqnorm"),
        )

    def _recon_dists(self, q: np.ndarray, ids: torch.Tensor) -> torch.Tensor:
        """Best-decode distances [B, M] on the device from preprocessed
        original-space host queries to rows ``ids`` (valid ids)."""
        dev = self.store.device_arrays()
        layers, packed, xsumsq = self._refine_layers(dev)
        qd = torch.from_numpy(np.ascontiguousarray(q, dtype=np.float32)).to(self.device)
        return gathered_recon_dists(qd, ids, layers, xsumsq,
                                    metric_is_l2=self.metric == VecSimMetric.L2,
                                    packed_flags=packed)

    def exact_gathered_dists(self, q: np.ndarray, ids: np.ndarray) -> np.ndarray:
        """Best-decode distances from preprocessed original-space queries to
        stored rows (-1 -> +inf): the ad-hoc scoring hook (``core.adhoc``)
        of modes whose primary store lives in another space than the
        query."""
        ids_t = torch.from_numpy(np.maximum(ids, 0).astype(np.int64)).to(self.device)
        d = self._recon_dists(q, ids_t).cpu().numpy()
        return np.where(ids >= 0, d, np.inf)

    def _refine(self, queries: np.ndarray, dists, ids):
        """Re-score a search window against the best stored decode
        (primary + residual for two-level LVQ, the SQ8 secondary for
        LeanVec) and re-sort each row, stably. Takes and returns device
        tensors, or numpy arrays."""
        host = isinstance(ids, np.ndarray)
        d = torch.as_tensor(dists, device=self.device)
        i = torch.as_tensor(ids, device=self.device)
        q, _, _ = self.preprocess_queries(queries)
        refined = self._recon_dists(q, i.clamp(min=0))
        refined = torch.where((i >= 0) & torch.isfinite(d), refined, torch.inf)
        rd, order = torch.sort(refined, dim=1, stable=True)
        ri = i.gather(1, order)
        if host:
            return rd.cpu().numpy(), ri.cpu().numpy()
        return rd, ri

    def _search_host(self, queries: np.ndarray, k: int, ws: int):
        """Search, re-rank on the device where the mode has a secondary
        level, then one read of the window to the host."""
        with self._lock:
            bd, bi = self._search_knn_locked(queries, k, ws)
            if self.res_bits:
                bd, bi = self._refine(queries, bd, bi)
            return bd.cpu().numpy(), bi.cpu().numpy()

    def topk_query(
        self, query: np.ndarray, k: int, params: Optional[VecSimQueryParams] = None
    ) -> QueryReply:
        return self.topk_query_batch(np.asarray(query).reshape(1, -1), k, params)[0]

    def topk_query_batch(
        self, queries: np.ndarray, k: int, params: Optional[VecSimQueryParams] = None
    ) -> list[QueryReply]:
        self.last_mode = VecSearchMode.STANDARD_KNN
        budget = TimeoutBudget(params.timeoutCtx if params else None)
        qs2 = np.atleast_2d(queries)
        nq = len(qs2)
        if budget.expired():
            return [make_reply([], [], VecSimQueryReplyCode.TimedOut) for _ in range(nq)]
        if self.store.count == 0 or self.entry_id < 0 or k <= 0:
            return [make_reply([], []) for _ in range(nq)]
        ws = self._effective_ws(k, params)
        # Window allowance for tombstones and (multi) duplicate values, and a
        # per-query doubling re-search until k distinct live labels are in
        # (hnsw_multi.h:105's label-keyed heap guarantee without one).
        extra = self.num_marked_deleted
        if self.multi:
            extra += max(0, self.store.count - len(self.labels.label_to_ids))
        ws += min(extra, ws)
        dists, ids = self._search_host(qs2, k, ws)
        out = []
        flags = self.store.host["flags"]
        id_to_label = self.store.host["label"]
        live_label_total = len(self.labels.label_to_ids) if self.multi else 0

        def filter_live(row_i, row_d):
            valid = row_i >= 0
            row_i, row_d = row_i[valid], row_d[valid]
            live = (flags[row_i] & FLAG_DELETED) == 0
            return row_i[live], row_d[live]

        def dedup(labels, row_d):
            seen: set[int] = set()
            keep = []
            for j, lab in enumerate(labels):
                if int(lab) not in seen:
                    seen.add(int(lab))
                    keep.append(j)
                    if len(keep) >= k:
                        break
            return labels[keep], row_d[keep]

        def research(b, w):
            rd2, ri2 = self._search_host(qs2[b : b + 1], k, w)
            return filter_live(ri2[0], rd2[0])

        for b in range(nq):
            row_i, row_d = filter_live(ids[b], dists[b])
            labels = id_to_label[row_i]
            if self.multi:
                lab_k, d_k = dedup(labels, row_d)
                target = min(k, live_label_total)
                w = ws
                while len(lab_k) < target and w < self.store.count and not budget.expired():
                    w = min(w * 2, self.store.count)
                    ri, rd = research(b, w)
                    lab_k, d_k = dedup(id_to_label[ri], rd)
                out.append(make_reply(lab_k, d_k))
            else:
                tgt = min(k, len(self.labels.label_to_id))
                w = ws
                while len(labels) < tgt and w < self.store.count and not budget.expired():
                    w = min(w * 2, self.store.count)
                    row_i, row_d = research(b, w)
                    labels = id_to_label[row_i]
                out.append(make_reply(labels[:k], row_d[:k]))
        if budget.expired():
            for r in out:
                r.code = VecSimQueryReplyCode.TimedOut
        return out

    def range_query(
        self,
        query: np.ndarray,
        radius: float,
        params: Optional[VecSimQueryParams] = None,
        order: QueryReplyOrder = QueryReplyOrder.BY_SCORE,
    ) -> QueryReply:
        """Epsilon-range search: a beam with the window doubled until its
        frontier passes radius * (1 + epsilon), each doubling a fresh
        search as in the JAX package; the window is re-ranked before the
        radius cut."""
        self.last_mode = VecSearchMode.RANGE_QUERY
        budget = TimeoutBudget(params.timeoutCtx if params else None)
        if budget.expired():
            return make_reply([], [], VecSimQueryReplyCode.TimedOut)
        if self.store.count == 0 or self.entry_id < 0:
            return make_reply([], [])
        eps = self.epsilon
        if params is not None and params.svsRuntimeParams.epsilon:
            eps = params.svsRuntimeParams.epsilon
        boundary = radius * (1.0 + eps)
        ef = max(self.ws, 32)
        q2 = np.asarray(query).reshape(1, -1)
        while True:
            dists, ids = self.search_knn(q2, 1, ef)
            d, i = dists[0], ids[0]
            finite = np.isfinite(d)
            if ef >= self.store.count or not finite.any():
                break
            if d[finite].max() > boundary or finite.sum() < ef:
                break
            if budget.expired():
                break
            ef *= 2
        if self.res_bits:
            rd, ri = self._refine(q2, d[None, :], i[None, :])
            d, i = rd[0], ri[0]
        valid = (i >= 0) & (d <= radius)
        row_i = i[valid]
        live = (self.store.host["flags"][row_i] & FLAG_DELETED) == 0
        row_i, row_d = row_i[live], d[valid][live]
        reply = make_reply(self.store.host["label"][row_i], row_d)
        if self.multi:
            reply = filter_results_by_id(reply)
        if budget.expired():
            reply.code = VecSimQueryReplyCode.TimedOut
        return reply.sort(order)

    def _decode_rows(self, ids: torch.Tensor) -> torch.Tensor:
        """Best available original-space decode [n, dim] of stored rows on
        the device: the SQ8 secondary for LeanVec, primary + residual for
        two-level LVQ, the primary decode otherwise."""
        dev = self.store.device_arrays()

        def layer(codes, vmin, delta, bits):
            if bits == 4:
                return sq4_reconstruct(codes[ids], vmin[ids], delta[ids], self.dim)
            return sq8_reconstruct(codes[ids], vmin[ids], delta[ids])

        if self.is_leanvec:
            return layer(dev["res"], dev["rvmin"], dev["rdelta"], self.res_bits)
        x = layer(dev["data"], dev["vmin"], dev["delta"], self.primary_bits)
        if self.res_bits:
            x = x + layer(dev["res"], dev["rvmin"], dev["rdelta"], self.res_bits)
        return x

    def get_distance_from(self, label: int, blob: np.ndarray) -> float:
        ids = self.labels.ids_of(label)
        if not ids:
            return float("nan")
        if self.quantized:
            q, _, qm = self.preprocess_queries(np.asarray(blob).reshape(1, -1))
            ids_t = torch.as_tensor(ids, device=self.device)
            ip = self._decode_rows(ids_t) @ torch.from_numpy(q[0]).to(self.device)
            if self.metric == VecSimMetric.L2:
                sq = self.store.device_arrays()["rsq" if self.is_leanvec else "sqnorm"]
                d = sq[ids_t] - 2.0 * ip + float(qm[1][0])
            else:
                d = 1.0 - ip
            return float(torch.min(d))
        q, qnorms, _ = self.preprocess_queries(np.asarray(blob).reshape(1, -1))
        qn = None if qnorms is None else qnorms[0]
        return min(self.host_distance(i, q[0], qn) for i in ids)

    def new_batch_iterator(self, query: np.ndarray, params: Optional[VecSimQueryParams] = None):
        from .svs_batch_iterator import SVSBatchIterator

        return SVSBatchIterator(self, query, params)

    def prefer_adhoc_search(self, subset_size: int, k: int, initial_check: bool = False) -> bool:
        # The reference's SVS index applies the generic heuristic on the flat
        # index's features (svs.h preferAdHocSearch).
        index_size = self.index_size
        subset_size = min(subset_size, index_size)
        r = 0.0 if index_size == 0 else subset_size / max(self.index_label_count, 1)
        res = index_size <= 5500 or r <= 0.15
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
        return self._basic_info(VecSimAlgo.SVS)

    def stats_info(self) -> VecSimIndexStatsInfo:
        return VecSimIndexStatsInfo(memory=self.memory_bytes,
                                    numberOfMarkedDeleted=self.num_marked_deleted)

    def debug_info(self) -> VecSimIndexDebugInfo:
        return VecSimIndexDebugInfo(
            commonInfo=CommonInfo(
                basicInfo=self.basic_info(),
                indexSize=self.index_size,
                indexLabelCount=self.index_label_count,
                memory=self.memory_bytes,
                lastMode=self.last_mode,
            ),
            svsInfo=SvsInfo(
                quantBits=self.requested_quant,
                alpha=self.alpha,
                graphMaxDegree=self.R,
                constructionWindowSize=self.L_build,
                # The reference's defaults when unset (svs_utils.h:114-115):
                # candidate pool = 3 x window, prune_to = degree.
                maxCandidatePoolSize=self.params.max_candidate_pool_size or 3 * self.L_build,
                pruneTo=self.params.prune_to or self.R,
                useSearchHistory=self.params.use_search_history != VecSimOptionMode.DISABLE,
                numberOfMarkedDeletedNodes=self.num_marked_deleted,
                searchWindowSize=self.ws,
                searchBufferCapacity=self.params.search_buffer_capacity or self.ws,
                leanvecDim=self.pdim if self.is_leanvec else 0,
                epsilon=self.epsilon,
            ),
        )
