"""HNSW index — flat SoA adjacency, built and searched on the device.

Counterpart of ``vectorsimilarity_tpu/indexes/hnsw.py`` (the reference's
``algorithms/hnsw/hnsw.h``), its build and read paths. The reference's
pointer-linked nodes become dense tensors aligned with the vector store:

  - level-0 links:   ``links0`` [cap, M0] int32 (-1 padded) + ``nlinks0``
  - upper links:     a side store for the ~N/M nodes with level >= 1:
                     ``links`` [ucap, LMAX, M], ``nlinks`` [ucap, LMAX], with
                     ``upper_row`` [cap] mapping vector id -> row
  - per-node level and flags (the DELETED tombstone)

Queries run on the device: greedy descent over the upper levels
(hnsw.h:1872-1886) then an ef-beam at level 0 (hnsw.h:1888-1940), see
``ops/graph_search.py``. Inserts connect whole batches on the device
(``ops/graph_build.py``); the host keeps the label maps, level sampling and
the entry point. With ``config.graph_build_device = False`` a batch goes
through the host-orchestrated construction instead (the JAX package's
reference path): the candidate beams, pair distances and prunes still run
on the device, but the chosen links are written into the host mirrors and
the reverse edges appended there (``native_bridge.apply_reverse_edges``),
overflowing rows re-pruned on the device.

Deletion keeps the reference's in-place semantics (hnsw.h:946-1184):
referrers are repaired by re-pruning over (their links + the deleted node's
links) on the device, then the row is removed with swap-with-last and its
id rewritten in the graph. Referrers are found by scans of the host link
arrays (``native_bridge.find_referrers``). Many tombstones go in one bulk
pass (``delete_tombstoned_bulk``: one sweep, one grouped re-prune, and a
compaction of both stores on the device). Overwriting a live label deletes
its old row first.

``to_query_sharded(mesh)`` cuts batch searches over a mesh of devices (slice
i on device i, against a replica of the graph there), and
``bulk_build_device(..., _deferred=True)`` yields once per build segment, for
the data-sharded ``parallel.sharded_graph.ShardedHNSW``.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import numpy as np
import torch

from .. import config
from .. import native_bridge
from ..core.abstract_index import DeviceVectorIndex, pow2_bucket
from ..core.interface import TimeoutBudget
from ..core.labels import rebuild_labels
from ..core.results import QueryReply, filter_results_by_id, make_reply
from ..core.store import BlockStore, FieldSpec, _bucket_capacity
from ..ops import graph_build
from ..ops.graph_search import (
    StoreCtx,
    beam_search,
    dists_to_ids,
    diversity_prune_chunked,
    exact_rerank,
    greedy_level,
)
from ..types import (
    INVALID_LABEL,
    CommonInfo,
    HNSWParams,
    HnswInfo,
    QueryReplyOrder,
    VecSearchMode,
    VecSimAlgo,
    VecSimIndexDebugInfo,
    VecSimIndexStatsInfo,
    VecSimMetric,
    VecSimQueryParams,
    VecSimQueryReplyCode,
)

FLAG_DELETED = 1

_INITIAL_LMAX = 4

# At most this many overwritten labels of one insert batch are deleted one
# by one; more are tombstoned and removed by one bulk pass.
_EAGER_OVERWRITES = 8


def _remap(ids: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` where ids >= 0, -1 elsewhere."""
    return torch.where(ids >= 0, table[ids.clamp_min(0).long()], -1)


def _compact_stores(dev: dict, udev: dict, idx, uidx, perm, uperm):
    """Gather the live rows of both stores and remap their link ids: one
    ``index_select`` per field and one table lookup per id field, on the
    device. ``idx`` / ``uidx`` are full-capacity gather indices (live rows
    first), ``perm`` / ``uperm`` map old vector ids / upper rows to new ones
    (-1: gone). Returns the new field tensors."""
    out = {name: arr.index_select(0, idx) for name, arr in dev.items()}
    out["links0"] = _remap(out["links0"], perm)
    out["upper_row"] = _remap(out["upper_row"], uperm)
    uout = {name: arr.index_select(0, uidx) for name, arr in udev.items()}
    uout["links"] = _remap(uout["links"], perm)
    uout["vec"] = _remap(uout["vec"], perm)
    return out, uout


class HNSWIndex(DeviceVectorIndex):
    """HNSW over a block store on ``device``: the current CUDA device by
    default, the CPU only on request."""

    def __init__(self, params: HNSWParams, log_ctx: Any = None, seed: int = 200, *,
                 device=None):
        self.M = params.M
        self.M0 = 2 * params.M  # hnsw.h:1599 (maxM0 = 2*M)
        self.ef_construction = max(params.efConstruction, self.M)
        self.ef_runtime = params.efRuntime
        self.epsilon = params.epsilon
        self.mult = 1.0 / math.log(self.M)  # hnsw.h:399-404 level sampling
        super().__init__(
            vtype=params.type,
            dim=params.dim,
            metric=params.metric,
            multi=params.multi,
            block_size=params.blockSize,
            device=device,
            log_ctx=log_ctx,
            initial_capacity=params.initialCapacity,
            extra_fields={
                "level": FieldSpec((), np.int32),
                "upper_row": FieldSpec((), np.int32, fill=-1),
                "links0": FieldSpec((self.M0,), np.int32, fill=-1),
                "nlinks0": FieldSpec((), np.int32),
                "flags": FieldSpec((), np.uint8),
            },
        )
        self.params = params
        self.lmax = _INITIAL_LMAX
        self.upper = self._new_upper_store(self.lmax)
        self.entry_id = -1
        self.max_level = -1
        self.num_marked_deleted = 0
        self._rng = np.random.default_rng(seed)
        # Device construction leaves the DEVICE link tensors authoritative;
        # host mirrors are pulled on first host-side access.
        self._host_links_stale = False
        self._build_dropped: list = []
        self._nav_cache = None
        self.last_bulk_repairs = 0  # rows re-pruned by the last bulk removal

    # ------------------------------------------------------------------
    # Upper-level side store
    # ------------------------------------------------------------------

    def _new_upper_store(self, lmax: int) -> BlockStore:
        return BlockStore(
            {
                "links": FieldSpec((lmax, self.M), np.int32, fill=-1),
                "nlinks": FieldSpec((lmax,), np.int32),
                "vec": FieldSpec((), np.int32, fill=-1),
            },
            block_size=max(self.block_size // max(self.M, 1), 64),
            device=self.device,
        )

    def _grow_lmax(self, need: int) -> None:
        self._ensure_host_links()  # the rebuild below re-uploads from host
        new_lmax = self.lmax
        while new_lmax < need:
            new_lmax *= 2
        old = self.upper
        self.upper = self._new_upper_store(new_lmax)
        if old.count:
            n = old.count
            rows = {
                "links": np.full((n, new_lmax, self.M), -1, dtype=np.int32),
                "nlinks": np.zeros((n, new_lmax), dtype=np.int32),
                "vec": old.host["vec"][:n].copy(),
            }
            rows["links"][:, : self.lmax] = old.host["links"][:n]
            rows["nlinks"][:, : self.lmax] = old.host["nlinks"][:n]
            self.upper.append(rows)
        self.lmax = new_lmax

    def _alloc_upper_row(self, node: int) -> int:
        r = int(
            self.upper.append(
                {
                    "links": np.full((1, self.lmax, self.M), -1, dtype=np.int32),
                    "nlinks": np.zeros((1, self.lmax), dtype=np.int32),
                    "vec": np.asarray([node], dtype=np.int32),
                }
            )[0]
        )
        self.store.host["upper_row"][node] = r
        self.store.mark_dirty(node, "upper_row")
        return r

    # ------------------------------------------------------------------
    # Host link accessors
    # ------------------------------------------------------------------

    def get_links(self, node: int, lvl: int) -> list[int]:
        self._ensure_host_links()
        if lvl == 0:
            n = int(self.store.host["nlinks0"][node])
            return self.store.host["links0"][node, :n].tolist()
        r = int(self.store.host["upper_row"][node])
        n = int(self.upper.host["nlinks"][r, lvl - 1])
        return self.upper.host["links"][r, lvl - 1, :n].tolist()

    def set_links(self, node: int, lvl: int, ids: list[int]) -> None:
        self._ensure_host_links()
        if lvl == 0:
            assert len(ids) <= self.M0
            row = self.store.host["links0"][node]
            row[: len(ids)] = ids
            row[len(ids) :] = -1
            self.store.host["nlinks0"][node] = len(ids)
            self.store.mark_dirty(node, "links0", "nlinks0")
            return
        assert len(ids) <= self.M
        r = int(self.store.host["upper_row"][node])
        row = self.upper.host["links"][r, lvl - 1]
        row[: len(ids)] = ids
        row[len(ids) :] = -1
        self.upper.host["nlinks"][r, lvl - 1] = len(ids)
        self.upper.mark_dirty(r, "links", "nlinks")

    def node_level(self, node: int) -> int:
        return int(self.store.host["level"][node])

    # ------------------------------------------------------------------
    # Device context
    # ------------------------------------------------------------------

    def _device_ctx(self, nav: bool = False):
        """Synced device tensors of both stores and the score context.
        ``nav=True`` asks for the bf16 navigation shadow (fp32 stores only):
        ``config.build_nav_bf16`` for construction, ``config.search_nav_bf16``
        for queries (which re-score their window exactly)."""
        dev = self.store.device_arrays()
        udev = self.upper.device_arrays()
        nav_arr = None
        if nav and self.store_kind == "float" and dev["data"].dtype == torch.float32:
            nav_arr = self._nav_shadow(dev["data"])
        ctx = StoreCtx(data=dev["data"], sqnorm=dev.get("sqnorm"), norm=dev.get("norm"),
                       nav=nav_arr)
        return dev, udev, ctx

    def _nav_shadow(self, data: torch.Tensor) -> torch.Tensor:
        """bf16 shadow of the device data, kept while the data tensor is the
        same: the store writes its tensors in place, so rows written since
        (a newer version counter) are converted into the shadow in place.
        The shadow keeps its address, which the graph loops' captured
        chunks read, so they replay after a write and keep no old shadow
        alive."""
        cached = self._nav_cache
        if cached is not None and cached[0] is data:
            nav = cached[2]
            if cached[1] != data._version:
                nav.copy_(data)
                self._nav_cache = (data, data._version, nav)
            return nav
        nav = data.to(torch.bfloat16)
        self._nav_cache = (data, data._version, nav)
        return nav

    # ------------------------------------------------------------------
    # Device-authoritative link state (ops/graph_build.py)
    # ------------------------------------------------------------------

    def _graph_state(self, dev, udev) -> graph_build.GraphState:
        return graph_build.GraphState(
            links0=dev["links0"],
            nlinks0=dev["nlinks0"],
            ulinks=udev["links"],
            unlinks=udev["nlinks"],
            upper_row=dev["upper_row"],
            entry=self.entry_id,
            max_level=self.max_level,
        )

    def _adopt_graph_state(self, state: graph_build.GraphState) -> None:
        """Install device-built link tensors as the compute copy; host link
        mirrors become stale and are pulled lazily (``_ensure_host_links``).
        ``upper_row`` stays host-authoritative (the device write mirrors the
        values the host assigned)."""
        self.store._device["links0"] = state.links0
        self.store._device["nlinks0"] = state.nlinks0
        self.store._device["upper_row"] = state.upper_row
        self.upper._device["links"] = state.ulinks
        self.upper._device["nlinks"] = state.unlinks
        self.store.mark_host_stale("links0", "nlinks0")
        self.upper.mark_host_stale("links", "nlinks")
        self._host_links_stale = True
        self.entry_id, self.max_level = state.entry, state.max_level

    def _ensure_host_links(self) -> None:
        """Pull device-built links into the host mirrors (one bulk read).
        Queries and device construction never need this."""
        if not self._host_links_stale:
            return
        self._host_links_stale = False
        self.store.pull_host("links0", "nlinks0")
        self.upper.pull_host("links", "nlinks")

    # ------------------------------------------------------------------
    # Write path
    # ------------------------------------------------------------------

    def _sample_level(self) -> int:
        u = self._rng.random()
        return int(-math.log(max(u, 1e-12)) * self.mult)

    def add_vector(self, blob: np.ndarray, label: int) -> int:
        return self.add_vector_batch(np.asarray(blob).reshape(1, -1), [label])

    def add_vector_batch(self, vecs: np.ndarray, labels) -> int:
        """Batched insert: the batch shares the device candidate searches,
        and intra-batch edges come from batch-pairwise distances merged into
        the candidate lists. A live label of a single-value index is
        overwritten: up to 8 such labels are deleted one by one, more are
        tombstoned and removed by one bulk repair and compaction pass.
        Returns the number of new labels (single-value) or rows (multi)."""
        labels = [int(l) for l in labels]
        with self._lock:
            overwrite: list[int] = []
            if not self.multi:
                overwrite = [l for l in labels if l in self.labels]
                if len(overwrite) > _EAGER_OVERWRITES:
                    old_ids: list[int] = []
                    for l in overwrite:
                        old_ids.extend(self.mark_delete(l))
                    self._delete_tombstoned_bulk_locked(old_ids)
                    self.num_marked_deleted -= len(old_ids)
                    self.store.maybe_shrink()
                else:
                    for l in overwrite:
                        self.delete_vector(l)
            rows = self.preprocess_storage(vecs)
            n = len(labels)
            rows["label"] = np.asarray(labels, dtype=np.int64)
            levels = np.asarray([self._sample_level() for _ in range(n)], dtype=np.int32)
            rows["level"] = levels
            rows["flags"] = np.zeros(n, dtype=np.uint8)
            rows["upper_row"] = np.full(n, -1, dtype=np.int32)
            if levels.max(initial=0) + 1 > self.lmax:
                self.log("debug", f"growing upper-level capacity to {int(levels.max()) + 1}")
                self._grow_lmax(int(levels.max()) + 1)
            ids = self.store.append(rows)
            for i, node in enumerate(ids):
                node = int(node)
                if self.multi:
                    slot = self.labels.add(labels[i], node)
                    self.store.host["slot"][node] = slot
                    self.store.mark_dirty(node, "slot")
                else:
                    self.labels.add(labels[i], node)
                if levels[i] >= 1:
                    self._alloc_upper_row(node)
            if config.graph_build_device:
                self._connect_batch_device(np.asarray(ids, dtype=np.int32), levels)
            else:
                self._connect_batch(np.asarray(ids, dtype=np.int32), levels)
            return n - len(overwrite)

    def _connect_batch_device(self, ids: np.ndarray, levels: np.ndarray) -> None:
        """Connect a batch on the device, in power-of-two chunks of at most
        ``config.build_batch`` rows (the JAX package's chunks: a chunk's
        intra-batch candidates depend on them)."""
        n = len(ids)
        if n == 0:
            return
        ids = np.asarray(ids, dtype=np.int32)
        levels = np.asarray(levels, dtype=np.int32)
        urows = self.store.host["upper_row"][ids].astype(np.int32)
        dev, udev, ctx = self._device_ctx(nav=config.build_nav_bf16)
        state = self._graph_state(dev, udev)
        off = 0
        while off < n:
            c = 1
            while c * 2 <= n - off and c * 2 <= config.build_batch:
                c *= 2
            ch = slice(off, off + c)
            state, d = graph_build.connect_batch(
                state, ctx, ids[ch], levels[ch], urows[ch], **self._build_kw()
            )
            self._build_dropped.append(d)
            off += c
        self._adopt_graph_state(state)

    def _build_kw(self) -> dict:
        return dict(
            efc=self.ef_construction,
            M=self.M,
            M0=self.M0,
            metric=self.metric,
            kind=self.store_kind,
            a_cap=config.build_reverse_cap,
            beam_expand=config.build_beam_expand,
        )

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

        ``data`` [N, dim] (or a larger buffer of which the first ``n`` rows
        are the data) is normalized / norm-annotated on the device and
        adopted into the store (host vector mirrors stay unfilled,
        ``BlockStore.adopt_device``), and the graph is built by
        ``graph_build.build_scan``, ``scan_batches`` batches of ``batch``
        rows per call; the last batches go through the pow2 chunks of
        ``add_vector_batch``. The index must be empty; ``labels`` defaults
        to 0..N-1.

        ``_deferred=True`` checks and preprocesses, then returns a generator
        instead of running to the end: each ``next()`` launches ONE
        ``build_scan`` segment and yields before it adopts the segment's
        result, so a multi-shard caller (``parallel.sharded_graph``) can
        drive the shards' builds in turns. The index's lock stays held until
        the generator is exhausted or closed, so the caller must exhaust it."""
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
            if self.store.count or self.upper.count:
                raise ValueError("bulk_build_device requires an empty index")
            if n is None:
                n = int(data.shape[0])
            batch = int(batch or config.build_batch)
            scan_batches = int(scan_batches or config.build_scan_batches)
            self._build_dropped = []
            cap = _bucket_capacity(n, self.store.block_size)

            # --- level sampling + upper-row layout (host RNG) ---
            u = self._rng.random(n)
            levels = (-np.log(np.maximum(u, 1e-12)) * self.mult).astype(np.int32)
            if int(levels.max(initial=0)) + 1 > self.lmax:
                self._grow_lmax(int(levels.max()) + 1)
            upper_nodes = np.nonzero(levels >= 1)[0].astype(np.int32)
            n_up = len(upper_nodes)
            urows = np.full(n, -1, dtype=np.int32)
            urows[upper_nodes] = np.arange(n_up, dtype=np.int32)

            # --- device preprocessing (CosinePreprocessor semantics) ---
            dev = self.device

            def padded(x, fill):
                if x.shape[0] == cap:
                    return x
                out = torch.full((cap, *x.shape[1:]), fill, dtype=x.dtype, device=dev)
                out[:n] = x[:n]
                return out

            adopt: dict = {}
            if self.store_kind == "int":
                dd = data
                di = dd.to(torch.int64)
                ss = torch.sum(di * di, dim=1).to(torch.float32)
                if self.metric == VecSimMetric.Cosine:
                    adopt["norm"] = padded(torch.sqrt(ss), 1.0)
                if "sqnorm" in self.store.fields:
                    adopt["sqnorm"] = padded(ss, 0.0)
            else:
                dd = data.to(self.store.fields["data"].torch_dtype)
                if self.metric == VecSimMetric.Cosine and not assume_normalized:
                    f = dd.to(torch.float32)
                    nrm = torch.linalg.vector_norm(f, dim=1, keepdim=True)
                    dd = (f / torch.where(nrm == 0, 1.0, nrm)).to(dd.dtype)
                if "sqnorm" in self.store.fields:
                    f = dd.to(self.store.fields["sqnorm"].torch_dtype)
                    adopt["sqnorm"] = padded(torch.sum(f * f, dim=1), 0.0)
            adopt["data"] = padded(dd, 0)
            adopt["links0"] = torch.full((cap, self.M0), -1, dtype=torch.int32, device=dev)
            adopt["nlinks0"] = torch.zeros((cap,), dtype=torch.int32, device=dev)
            adopt["upper_row"] = padded(torch.from_numpy(urows).to(dev), -1)
            self.store.adopt_device(adopt, count=n)

            # --- host metadata (levels, labels; vectors stay device-only) ---
            self.store.host["level"][:n] = levels
            self.store.host["upper_row"][:n] = urows
            self.store._host_stale.discard("upper_row")  # the host mirror is exact
            labs = (
                np.arange(n, dtype=np.int64) if labels is None
                else np.asarray(labels, dtype=np.int64)
            )
            self.store.host["label"][:n] = labs
            if self.multi:
                for i in range(n):
                    self.store.host["slot"][i] = self.labels.add(int(labs[i]), i)
            else:
                self.labels.label_to_id = {int(l): i for i, l in enumerate(labs)}

            ucap = _bucket_capacity(max(n_up, 1), self.upper.block_size)
            vec_pad = np.full(ucap, -1, dtype=np.int32)
            vec_pad[:n_up] = upper_nodes
            self.upper.adopt_device(
                {
                    "links": torch.full((ucap, self.lmax, self.M), -1, dtype=torch.int32,
                                        device=dev),
                    "nlinks": torch.zeros((ucap, self.lmax), dtype=torch.int32, device=dev),
                    "vec": torch.from_numpy(vec_pad).to(dev),
                },
                count=n_up,
            )
            self.upper.host["vec"][:n_up] = upper_nodes
            self.upper._host_stale.discard("vec")  # the host mirror is exact
            yield  # checked and preprocessed

            # --- construction: build_scan segments, then the pow2 tail ---
            devs, udev, ctx = self._device_ctx(nav=config.build_nav_bf16)
            state = self._graph_state(devs, udev)
            nb = n // batch
            pos = 0
            while nb - pos >= 2:
                T = min(scan_batches, nb - pos)
                off0 = pos * batch
                offsets = np.arange(off0, off0 + T * batch, batch)
                state, dropped = graph_build.build_scan(
                    state, ctx, offsets,
                    levels[off0 : off0 + T * batch].reshape(T, batch),
                    urows[off0 : off0 + T * batch].reshape(T, batch),
                    **self._build_kw(),
                )
                yield
                self._build_dropped.append(dropped)
                pos += T
                self.log("debug", f"bulk build: {pos * batch}/{n}")
            self._adopt_graph_state(state)
            tail_start = pos * batch
            if tail_start < n:
                self._connect_batch_device(
                    np.arange(tail_start, n, dtype=np.int32), levels[tail_start:]
                )

    # -- construction (host-orchestrated reference path) -----------------

    def _connect_batch(self, ids: np.ndarray, levels: np.ndarray) -> None:
        """Connect a batch of stored rows with the links chosen on the
        device and written on the host (the JAX package's ``_connect_batch``):
        a level-synchronous descent (the nodes living at a level run the
        candidate beam, the others descend greedily), the level-0 beam, the
        intra-batch pair distances, one prune for level 0 (to M0) and one per
        upper level (to M), then the reverse edges on the host. The beams
        step one candidate at a time (``searchLayer``), navigation reads the
        exact rows, and the batch is not cut into power-of-two chunks."""
        self._ensure_host_links()  # the links below are written on the host
        prev_ep, prev_max = self.entry_id, self.max_level
        n = len(ids)
        dv = self.device
        dev, udev, ctx = self._device_ctx()
        batch_ids = np.asarray(ids, dtype=np.int32)
        ids_t = torch.from_numpy(batch_ids).to(dv)
        q, qn, _ = graph_build.anchor_queries(ctx, ids_t.long(), self.store_kind, self.metric)
        kw = dict(metric=self.metric, kind=self.store_kind)
        efc = self.ef_construction
        cap = self.store.capacity

        def sub(x, r):
            return None if x is None else x[r]

        # --- graph candidates (the batch's rows have no incoming links yet,
        # so the graph cannot reach them) ---
        b0d = torch.full((n, efc), torch.inf, device=dv)
        b0i = torch.full((n, efc), -1, dtype=torch.int32, device=dv)
        upper_cands: dict[tuple[int, int], tuple[np.ndarray, np.ndarray]] = {}
        if prev_ep >= 0:
            cur = torch.full((n,), prev_ep, dtype=torch.int32, device=dv)
            cur_d = dists_to_ids(q, cur[:, None], ctx, q_norm=qn, **kw)[:, 0]
            for lvl in range(prev_max, 0, -1):
                beam_rows = np.nonzero(levels >= lvl)[0]
                if len(beam_rows):
                    r = torch.from_numpy(beam_rows).to(dv)
                    bd, bi = beam_search(
                        q[r], ctx, udev["links"], dev["upper_row"], cur[r], cur_d[r], cap,
                        level=lvl, ef=efc, q_norm=sub(qn, r), **kw,
                    )
                    bi_np, bd_np = bi.cpu().numpy(), bd.cpu().numpy()
                    for row, i in enumerate(beam_rows.tolist()):
                        upper_cands[(i, lvl)] = (bi_np[row], bd_np[row])
                    cur[r], cur_d[r] = bi[:, 0], bd[:, 0]
                greedy = levels < lvl
                if greedy.any():
                    cur, cur_d = greedy_level(
                        q, ctx, udev["links"], dev["upper_row"], cur, cur_d, level=lvl,
                        active=torch.from_numpy(greedy).to(dv), q_norm=qn, **kw,
                    )
            b0d, b0i = beam_search(q, ctx, dev["links0"], None, cur, cur_d, cap, ef=efc,
                                   q_norm=qn, **kw)

        # --- intra-batch candidates: the exact [n, n] pair distances ---
        if n > 1:
            pair = dists_to_ids(q, ids_t[None, :].expand(n, n), ctx, q_norm=qn, **kw)
            pair = torch.where(torch.eye(n, dtype=torch.bool, device=dv), torch.inf, pair)
        else:
            pair = torch.full((1, 1), torch.inf, device=dv)

        # --- level 0: merge + prune for the whole batch ---
        ci = torch.cat([b0i, ids_t[None, :].expand(n, n)], dim=1)
        cd = torch.cat([b0d, pair], dim=1)
        sel = diversity_prune_chunked(q, ci, cd, ctx, m=self.M0, q_norm=qn, **kw).cpu().numpy()
        upper_rows = np.nonzero(levels >= 1)[0]
        pair_np = pair[torch.from_numpy(upper_rows).to(dv)].cpu().numpy()
        pair_row = {int(r): j for j, r in enumerate(upper_rows)}
        self.store.host["links0"][batch_ids] = sel
        self.store.host["nlinks0"][batch_ids] = (sel >= 0).sum(axis=1).astype(np.int32)
        for node in batch_ids.tolist():
            self.store.mark_dirty(node, "links0", "nlinks0")
        valid = sel >= 0
        pairs = np.column_stack(
            [sel[valid], np.broadcast_to(batch_ids[:, None], sel.shape)[valid]]
        ).astype(np.int32)
        self._apply_reverse_edges_l0(pairs)

        # --- upper levels: one prune per level ---
        by_level: dict[int, list[tuple[int, np.ndarray, np.ndarray]]] = {}
        for i, node in enumerate(batch_ids.tolist()):
            for lvl in range(1, int(levels[i]) + 1):
                gi, gd = upper_cands.get((i, lvl), (np.empty(0, np.int32),
                                                    np.empty(0, np.float32)))
                mask = levels >= lvl
                mask[i] = False
                c_i = np.concatenate([gi, batch_ids[mask]]).astype(np.int32)
                c_d = np.concatenate([gd, pair_np[pair_row[i]][mask]]).astype(np.float32)
                if len(c_i) == 0:
                    self.set_links(node, lvl, [])
                    continue
                by_level.setdefault(lvl, []).append((i, c_i, c_d))
        additions: dict[tuple[int, int], list[int]] = {}
        for lvl, group in by_level.items():
            # The candidate width keeps the JAX package's power-of-two padding.
            C = pow2_bucket(max(len(c_i) for _, c_i, _ in group))
            cand = np.full((len(group), C), -1, dtype=np.int32)
            cand_d = np.full((len(group), C), np.inf, dtype=np.float32)
            for g, (_, c_i, c_d) in enumerate(group):
                cand[g, : len(c_i)] = c_i
                cand_d[g, : len(c_i)] = c_d
            r = torch.tensor([i for i, _, _ in group], dtype=torch.int64, device=dv)
            s = diversity_prune_chunked(
                q[r], torch.from_numpy(cand).to(dv), torch.from_numpy(cand_d).to(dv), ctx,
                m=self.M, q_norm=sub(qn, r), **kw,
            ).cpu().numpy()
            for g, (i, _, _) in enumerate(group):
                node = int(batch_ids[i])
                chosen = [int(x) for x in s[g] if x >= 0]
                self.set_links(node, lvl, chosen)
                for nb in chosen:
                    additions.setdefault((nb, lvl), []).append(node)
        self._apply_reverse_edges(additions)

        # --- entry point / max level (first occurrence of the highest level) ---
        top = int(levels.max(initial=0))
        if prev_ep < 0 or top > prev_max:
            best = int(np.argmax(levels))
            self.entry_id = int(batch_ids[best])
            self.max_level = int(levels[best])

    def _apply_reverse_edges_l0(self, pairs: np.ndarray) -> None:
        """Level-0 back-edges (neighbour, node) of a whole batch, appended in
        the host rows by ``native_bridge``; each row that overflows is
        re-pruned over its links and its new back-edges."""
        count = self.store.count
        overflow, dirty = native_bridge.apply_reverse_edges(
            self.store.host["links0"][:count], self.store.host["nlinks0"][:count], pairs)
        for r in np.unique(dirty).tolist():
            self.store.mark_dirty(r, "links0", "nlinks0")
        if len(overflow):
            over = set(overflow.tolist())
            pending: dict[int, list[int]] = {}
            for nb, node in pairs.tolist():
                if nb in over:
                    pending.setdefault(nb, []).append(node)
            self._reprune_rows([
                (nb, 0, list(dict.fromkeys(self.get_links(nb, 0) + fresh)))
                for nb, fresh in pending.items()
            ])

    def _apply_reverse_edges(self, additions: dict[tuple[int, int], list[int]]) -> None:
        """Add back-edges {(neighbour, level): new nodes}: appended where the
        row has room, else the row is re-pruned over old + new (the
        reference's ``revisitNeighborConnections``, hnsw.h:781-868)."""
        overflow: list[tuple[int, int, list[int]]] = []
        for (nb, lvl), new_ids in additions.items():
            cur = self.get_links(nb, lvl)
            cur_set = set(cur)
            fresh = [x for x in dict.fromkeys(new_ids) if x not in cur_set and x != nb]
            if not fresh:
                continue
            if len(cur) + len(fresh) <= (self.M0 if lvl == 0 else self.M):
                self.set_links(nb, lvl, cur + fresh)
            else:
                overflow.append((nb, lvl, cur + fresh))
        if overflow:
            self._reprune_rows(overflow)

    # ------------------------------------------------------------------
    # Delete path (in place: repair + swap, hnsw.h:946-1184)
    # ------------------------------------------------------------------

    def _reprune_rows(self, rows: list[tuple[int, int, list[int]]]) -> None:
        """Heuristic re-prune of (node, level, candidates) rows on the
        device, level 0 and the upper levels in one call each; the chosen
        links are written on the host. The JAX package pads the rows to a
        power of two for its compile cache; rows are independent, so the
        port runs them as they are (the candidate width keeps its padding)."""
        dev, _, ctx = self._device_ctx()
        for lvl_zero in (True, False):
            group = [r for r in rows if (r[1] == 0) == lvl_zero]
            if not group:
                continue
            m = self.M0 if lvl_zero else self.M
            C = pow2_bucket(max(len(c) for _, _, c in group))
            cand = np.full((len(group), C), -1, dtype=np.int32)
            for bi, (_, _, c) in enumerate(group):
                cand[bi, : len(c)] = c
            nodes = torch.tensor([g[0] for g in group], dtype=torch.int64, device=self.device)
            q = dev["data"].index_select(0, nodes)
            qn = None if ctx.norm is None else ctx.norm.index_select(0, nodes)
            # Chunked: at bulk-GC scale the repair set is O(tombstones * M)
            # rows, and one [rows, C, D] gather of their candidates is GBs.
            sel = diversity_prune_chunked(
                q, torch.from_numpy(cand).to(self.device), None, ctx, m=m,
                metric=self.metric, kind=self.store_kind, q_norm=qn,
            ).cpu().numpy()
            for bi, (node, lvl, _) in enumerate(group):
                self.set_links(node, lvl, [int(x) for x in sel[bi] if x >= 0])

    def delete_vector(self, label: int) -> int:
        with self._lock:
            ids = self.labels.remove_label(label)
            if not ids:
                return 0
            for node in sorted(ids, reverse=True):
                self._delete_node(node)
            self.store.maybe_shrink()
            return len(ids)

    def _referrers(self, node: int) -> list[tuple[int, int]]:
        """All (referrer, level) with an edge -> node: native scans of the
        host link arrays, level 0 first, rows ascending."""
        self._ensure_host_links()
        out = [(int(h), 0) for h in
               native_bridge.find_referrers(self.store.host["links0"], self.store.count, node)]
        ucount = self.upper.count
        if ucount:
            ul = self.upper.host["links"][:ucount]
            vec = self.upper.host["vec"]
            hit = native_bridge.find_referrers(
                ul.reshape(ucount * self.lmax, self.M), ucount * self.lmax, node
            )
            out.extend((int(vec[fr // self.lmax]), int(fr % self.lmax) + 1) for fr in hit)
        return out

    def _delete_node(self, node: int) -> None:
        node_lvl = self.node_level(node)
        # Repair each referrer: re-prune over (its links + node's links).
        repairs: list[tuple[int, int, list[int]]] = []
        for ref, lvl in self._referrers(node):
            if ref == node:
                continue
            own = [x for x in self.get_links(ref, lvl) if x != node]
            borrowed = (
                [x for x in self.get_links(node, lvl) if x != ref and x != node]
                if lvl <= node_lvl
                else []
            )
            cand = list(dict.fromkeys(own + borrowed))
            cap_l = self.M0 if lvl == 0 else self.M
            if len(cand) <= cap_l and not borrowed:
                self.set_links(ref, lvl, cand)
            else:
                repairs.append((ref, lvl, cand))
        if repairs:
            self._reprune_rows(repairs)
        # Entry point replacement (hnsw.h:1045-1120 semantics).
        if self.entry_id == node:
            self._replace_entry_point(exclude=node)
        self._remove_upper_row(node)
        self._swap_remove(node)

    def _remove_upper_row(self, node: int) -> None:
        r = int(self.store.host["upper_row"][node])
        if r < 0:
            return
        last = self.upper.count - 1
        moved_vec = int(self.upper.host["vec"][last])
        self.upper.swap_delete(r)
        if r != last:
            self.store.host["upper_row"][moved_vec] = r
            self.store.mark_dirty(moved_vec, "upper_row")
        self.store.host["upper_row"][node] = -1
        self.store.mark_dirty(node, "upper_row")

    def _swap_remove(self, node: int) -> None:
        last = self.store.count - 1
        if node != last:
            # Rewrite references to `last` -> `node` before moving the row.
            for ref, lvl in self._referrers(last):
                links = [node if x == last else x for x in self.get_links(ref, lvl)]
                self.set_links(ref if ref != last else node, lvl, links)
            r = int(self.store.host["upper_row"][last])
            if r >= 0:
                self.upper.host["vec"][r] = node
                self.upper.mark_dirty(r, "vec")
            moved_label = int(self.store.host["label"][last])
            # Tombstoned rows are no longer in the label map (mark_delete
            # removed them); only a live row's move is recorded.
            if self.multi:
                if last in self.labels.label_to_ids.get(moved_label, ()):
                    self.labels.on_swap(moved_label, last, node)
            elif self.labels.label_to_id.get(moved_label) == last:
                self.labels.on_swap(moved_label, node)
            if self.entry_id == last:
                self.entry_id = node
        self.store.swap_delete(node)

    def _delete_node_tombstoned(self, node: int) -> None:
        """Remove one tombstoned node (its label entry is gone already):
        repair and swap, as ``_delete_node`` (hnsw.h:1694)."""
        self.store.host["flags"][node] &= ~np.uint8(FLAG_DELETED)
        self.store.mark_dirty(node, "flags")
        self._delete_node(node)

    def delete_tombstoned_bulk(self, nodes) -> int:
        """Remove many tombstoned nodes in one pass (the reference's
        ``executeReadySwapJobs``, hnsw_tiered.h:332-362): one referrer sweep
        over the link arrays for the whole set, one grouped re-prune, then a
        compaction of both stores on the device (a gather of the live rows
        and a remap of the link ids) instead of a swap-with-last per node.

        Every node must be tombstoned (``mark_delete``). Returns the number
        removed; ``num_marked_deleted`` is the caller's to lower."""
        nodes = [int(x) for x in nodes]
        if not nodes:
            return 0
        with self._lock:
            return self._delete_tombstoned_bulk_locked(nodes)

    def _delete_tombstoned_bulk_locked(self, nodes: list[int]) -> int:
        self._ensure_host_links()
        count = self.store.count
        deleted = np.zeros(count, dtype=bool)
        deleted[nodes] = True
        if not (self.store.host["flags"][nodes] & FLAG_DELETED).all():
            raise ValueError("bulk removal takes tombstoned nodes only")
        l0 = self.store.host["links0"][:count]
        nl0 = self.store.host["nlinks0"][:count]

        # --- neighbour repair (the reference's repair jobs) ---
        def repair_candidates(ref: int, lvl: int, row: np.ndarray):
            own = [int(x) for x in row if not deleted[x]]
            borrowed: list[int] = []
            for nb in row:
                if deleted[nb]:
                    borrowed.extend(
                        x for x in self.get_links(int(nb), lvl) if x != ref and not deleted[x]
                    )
            cand = list(dict.fromkeys(own + borrowed))
            cap_l = self.M0 if lvl == 0 else self.M
            if len(cand) <= cap_l and not borrowed:
                self.set_links(ref, lvl, cand)
                return None
            return (ref, lvl, cand)

        repairs: list[tuple[int, int, list[int]]] = []
        hit0 = np.nonzero(((l0 >= 0) & deleted[np.maximum(l0, 0)]).any(axis=1) & ~deleted)[0]
        for ref in hit0:
            r = repair_candidates(int(ref), 0, l0[ref][: nl0[ref]])
            if r is not None:
                repairs.append(r)
        ucount = self.upper.count
        if ucount:
            ul = self.upper.host["links"][:ucount]
            un = self.upper.host["nlinks"][:ucount]
            vec = self.upper.host["vec"][:ucount]
            rows_u, lvls_u = np.nonzero(((ul >= 0) & deleted[np.maximum(ul, 0)]).any(axis=2))
            for r, li in zip(rows_u, lvls_u):
                ref = int(vec[r])
                if deleted[ref]:
                    continue
                r2 = repair_candidates(ref, int(li) + 1, ul[r, li][: un[r, li]])
                if r2 is not None:
                    repairs.append(r2)
        self.last_bulk_repairs = len(repairs)
        if repairs:
            self._reprune_rows(repairs)

        # --- entry point: the tombstone flags exclude the whole set ---
        if self.entry_id >= 0 and deleted[self.entry_id]:
            self._replace_entry_point(exclude=self.entry_id)

        # --- compaction: live rows slide down, link ids remap ---
        live = np.nonzero(~deleted)[0]
        nlive = len(live)
        perm = np.full(count, -1, dtype=np.int32)
        perm[live] = np.arange(nlive, dtype=np.int32)
        uvec = self.upper.host["vec"][:ucount]
        ulive = np.nonzero(~deleted[np.maximum(uvec, 0)] & (uvec >= 0))[0]
        nu = len(ulive)
        uperm = np.full(max(ucount, 1), -1, dtype=np.int32)
        uperm[ulive] = np.arange(nu, dtype=np.int32)

        # The sync pushes the repairs and applies deferred row moves, so the
        # device tensors hold every row's newest content; then both stores
        # are compacted on the device (re-uploading compacted host columns
        # would move the whole store through the host link, and the host
        # mirror of a device-authoritative field holds nothing).
        self._nav_cache = None  # its shadow of the old rows goes too
        dev, udev, _ = self._device_ctx()
        cap = self.store.capacity
        idx = np.full(cap, max(count - 1, 0), dtype=np.int64)
        idx[:nlive] = live
        uidx = np.zeros(self.upper.capacity, dtype=np.int64)
        uidx[:nu] = ulive
        perm_pad = np.full(cap, -1, dtype=np.int32)
        perm_pad[:count] = perm
        uperm_pad = np.full(max(self.upper.capacity, 1), -1, dtype=np.int32)
        uperm_pad[: len(uperm)] = uperm
        new_dev, new_udev = _compact_stores(
            dev, udev, *(torch.from_numpy(a).to(self.device) for a in (idx, uidx, perm_pad,
                                                                        uperm_pad)))
        del dev, udev
        self.store._device.update(new_dev)
        self.upper._device.update(new_udev)
        del new_dev, new_udev

        # Host mirrors follow the same permutation; device-authoritative
        # fields stay so (their host rows are pulled on demand).
        for st, rows, n_keep in ((self.store, live, nlive), (self.upper, ulive, nu)):
            for name in st.fields:
                if name not in st._host_stale:
                    st.host[name][:n_keep] = st.host[name][rows]
            for dset in st._dirty_rows.values():
                dset.clear()
            st._dirty_from = n_keep
        lh = self.store.host["links0"][:nlive]
        lh[:] = np.where(lh >= 0, perm_pad[np.maximum(lh, 0)], -1)
        urh = self.store.host["upper_row"][:nlive]
        urh[:] = np.where(urh >= 0, uperm[np.maximum(urh, 0)], -1)
        if nu:
            ulh = self.upper.host["links"][:nu]
            ulh[:] = np.where(ulh >= 0, perm_pad[np.maximum(ulh, 0)], -1)
            uvh = self.upper.host["vec"][:nu]
            uvh[:] = np.where(uvh >= 0, perm[np.maximum(uvh, 0)], -1)
        self.store.count = nlive
        self.upper.count = nu

        # --- label map + entry remap ---
        if self.entry_id >= 0:
            self.entry_id = int(perm[self.entry_id])
        self.labels = type(self.labels)()
        rebuild_labels(self)
        return len(nodes)

    def mark_delete(self, label: int) -> list[int]:
        """Tombstone all vectors of a label; they stay traversable."""
        with self._lock:
            ids = self.labels.remove_label(label)
            for node in ids:
                self.store.host["flags"][node] |= FLAG_DELETED
                self.store.mark_dirty(node, "flags")
                self.num_marked_deleted += 1
            if self.entry_id in ids:
                self._replace_entry_point(exclude=self.entry_id)
            return ids

    def _replace_entry_point(self, exclude: int) -> None:
        count = self.store.count
        levels = self.store.host["level"][:count]
        flags = self.store.host["flags"][:count]
        while self.max_level >= 0:
            cands = np.nonzero(
                (levels == self.max_level)
                & (np.arange(count) != exclude)
                & (flags & FLAG_DELETED == 0)
            )[0]
            if len(cands):
                self.entry_id = int(cands[0])
                return
            self.max_level -= 1
        # fall back: any live node
        live = np.nonzero((np.arange(count) != exclude) & (flags & FLAG_DELETED == 0))[0]
        if len(live):
            self.entry_id = int(live[0])
            self.max_level = int(levels[live[0]])
        else:
            self.entry_id = -1
            self.max_level = -1

    # ------------------------------------------------------------------
    # Read path
    # ------------------------------------------------------------------

    def _effective_ef(self, k: int, params: Optional[VecSimQueryParams]) -> int:
        ef = self.ef_runtime
        if params is not None and params.hnswRuntimeParams.efRuntime:
            ef = params.hnswRuntimeParams.efRuntime
        return max(ef, k)

    def _device_queries(self, queries: np.ndarray):
        q, qnorms = self.preprocess_queries(np.atleast_2d(queries))
        return self.to_device(q), self.to_device(qnorms)

    def search_knn(self, queries: np.ndarray, k: int, ef: int, *, mesh=None):
        """Device graph search of host queries; returns numpy (dists [B, ef'],
        ids [B, ef']) with row ids. The JAX package pads the batch to a power
        of two (one compiled shape per bucket); rows are independent, so the
        port runs the batch as it is. With a mesh (``mesh``, else
        ``to_query_sharded``'s) the batch is cut over its devices
        (``_maybe_shard_queries``)."""
        with self._lock:
            qd, qn = self._device_queries(queries)
            bd, bi = self._maybe_shard_queries(
                lambda q, n, _m, dev: self._device_search(q, n, k, ef, device=dev),
                qd, qn, mesh=mesh,
            )
            return bd.cpu().numpy(), bi.cpu().numpy()

    def search_knn_device(self, qd: torch.Tensor, k: int, ef: int, qn=None):
        """Device-tensor entry point: ``qd`` [B, dim] on the store's device,
        already preprocessed (normalized for float Cosine; ``qn`` = query
        norms for integer Cosine). Returns DEVICE (dists [B, ef'], ids
        [B, ef']) with row ids, ef' = min(pow2(max(ef, k)), pow2(count))."""
        with self._lock:
            return self._device_search(qd, qn, k, ef)

    def _device_search(
        self, qd, qn, k: int, ef: int, *, init_state=None, iter_budget=None,
        return_state=False, device=None,
    ):
        """The search on the index's device, or on ``device`` against a
        replica of the index's tensors there (``_replica``)."""
        count = self.store.count
        bq = qd.shape[0]
        dev, udev, ctx = self._device_ctx(nav=config.search_nav_bf16)
        if device is not None:
            r = self._replica(device, {"links0": dev["links0"], "upper_row": dev["upper_row"],
                                       "ulinks": udev["links"], **ctx._asdict()})
            dev, udev = r, {"links": r["ulinks"]}
            ctx = StoreCtx(**{f: r[f] for f in StoreCtx._fields})
        if init_state is None:
            ep = self.entry_id
            cur = torch.full((bq,), ep, dtype=torch.int32, device=qd.device)
            cur_d = dists_to_ids(qd, cur[:, None], ctx, metric=self.metric,
                                 kind=self.store_kind, q_norm=qn)[:, 0]
            for lvl in range(self.max_level, 0, -1):
                cur, cur_d = greedy_level(
                    qd, ctx, udev["links"], dev["upper_row"], cur, cur_d, lvl,
                    metric=self.metric, kind=self.store_kind, q_norm=qn,
                )
        else:
            # Resume: the entry arguments are placeholders.
            cur = torch.zeros((bq,), dtype=torch.int32, device=qd.device)
            cur_d = torch.zeros((bq,), dtype=torch.float32, device=qd.device)
        # The beam width is ef rounded up to a power of two, as in the JAX
        # package (a wider beam than ef: the results depend on it).
        ef_pad = min(pow2_bucket(max(ef, k)), max(pow2_bucket(count), 1))
        out = beam_search(
            qd, ctx, dev["links0"], None, cur, cur_d, self.store.capacity,
            ef=ef_pad, metric=self.metric, kind=self.store_kind, q_norm=qn,
            expand=config.resolve_search_expand(ef),
            init_state=init_state, return_state=return_state, iter_budget=iter_budget,
        )
        if ctx.nav is None:
            return out
        # Traversal ranked with the bf16 shadow: re-score the returned window
        # exactly and re-sort, so every caller sees true fp32 distances. The
        # resumable state keeps its traversal-order beam.
        bd, bi = exact_rerank(qd, out[1], ctx, metric=self.metric, kind=self.store_kind,
                              q_norm=qn)
        if return_state:
            return (bd, bi) + tuple(out[2:])
        return bd, bi

    def _search_knn_segmented(self, queries: np.ndarray, k: int, ef: int, budget):
        """Beam search in bounded segments with the timeout callback polled
        between them (the reference's per-hop VECSIM_TIMEOUT, hnsw.h:1923).
        Returns (dists, ids, completed); ``completed`` False means the
        deadline fired mid-search and the beam so far is a partial result."""
        with self._lock:
            qd, qn = self._device_queries(queries)
            seg = max(config.timeout_poll_iters, 1)
            total = max(
                (config.beam_iter_factor * ef + config.beam_iter_base)
                // config.resolve_search_expand(ef),
                64,
            )
            state, completed = None, False
            bd = bi = None
            for _ in range(-(-total // seg)):
                bd, bi, state, completed, _ = self._device_search(
                    qd, qn, k, ef, init_state=state, iter_budget=seg, return_state=True,
                )
                if completed or budget.expired():
                    break
            return bd.cpu().numpy(), bi.cpu().numpy(), completed

    def search_resumable(self, queries: np.ndarray, k: int, ef: int, state=None):
        """Resumable beam search for deep paging (the reference batch
        iterator's persisted frontier, hnsw_batch_iterator.h:94,206-249):
        pass the returned ``state`` back with a larger ``ef`` to continue
        expansion without re-visiting nodes. Any index mutation invalidates
        the state."""
        with self._lock:
            qd, qn = self._device_queries(queries)
            bd, bi, state, _, _ = self._device_search(
                qd, qn, k, ef, init_state=state, return_state=True
            )
            return bd.cpu().numpy(), bi.cpu().numpy(), state

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
        ef = self._effective_ef(k, params)
        # Window allowance for post-search filters: tombstoned nodes and
        # (multi) duplicate values of one label consume beam slots without
        # contributing distinct results; a doubling retry below guarantees k
        # distinct live labels.
        extra = self.num_marked_deleted
        if self.multi:
            extra += max(0, self.store.count - len(self.labels.label_to_ids))
        ef += min(extra, ef)
        if budget.ctx is not None:
            dists, ids, _ = self._search_knn_segmented(qs2, k, ef, budget)
        else:
            dists, ids = self.search_knn(qs2, k, ef)
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

        for b in range(nq):
            row_i, row_d = filter_live(ids[b], dists[b])
            labels = id_to_label[row_i]
            if self.multi:
                lab_k, d_k = dedup(labels, row_d)
                # Distinct-label guarantee: re-search THIS query with a
                # doubled window until k distinct live labels are in.
                target = min(k, live_label_total)
                w = ef
                while len(lab_k) < target and w < self.store.count and not budget.expired():
                    w = min(w * 2, self.store.count)
                    rd2, ri2 = self.search_knn(qs2[b : b + 1], k, w)
                    ri, rd = filter_live(ri2[0], rd2[0])
                    lab_k, d_k = dedup(id_to_label[ri], rd)
                out.append(make_reply(lab_k, d_k))
            else:
                tgt = min(k, len(self.labels.label_to_id))
                if len(labels) < tgt and not budget.expired():
                    # Tombstone-crowded window: the same doubling retry.
                    w = ef
                    while len(labels) < tgt and w < self.store.count:
                        w = min(w * 2, self.store.count)
                        rd2, ri2 = self.search_knn(qs2[b : b + 1], k, w)
                        row_i, row_d = filter_live(ri2[0], rd2[0])
                        labels = id_to_label[row_i]
                        if budget.expired():
                            break
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
        """Epsilon-range search (hnsw.h:1991-2092): explore the
        radius*(1+epsilon) neighbourhood, return nodes within radius, as a
        beam search with doubling ef until the beam frontier passes the
        epsilon boundary. Each doubling searches afresh, as in the JAX
        package (a resumed window cannot recover scored-then-evicted nodes)."""
        self.last_mode = VecSearchMode.RANGE_QUERY
        budget = TimeoutBudget(params.timeoutCtx if params else None)
        if budget.expired():
            return make_reply([], [], VecSimQueryReplyCode.TimedOut)
        if self.store.count == 0 or self.entry_id < 0:
            return make_reply([], [])
        eps = self.epsilon
        if params is not None and params.hnswRuntimeParams.epsilon:
            eps = params.hnswRuntimeParams.epsilon
        boundary = radius * (1.0 + eps)
        ef = 32
        q2 = np.asarray(query).reshape(1, -1)
        while True:
            dists, ids = self.search_knn(q2, 1, ef)
            d, i = dists[0], ids[0]
            finite = np.isfinite(d)
            if ef >= self.store.count or not finite.any():
                break
            worst = d[finite].max()
            if worst > boundary or finite.sum() < ef:
                break
            if budget.expired():
                break
            ef *= 2
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

    def get_distance_from(self, label: int, blob: np.ndarray) -> float:
        ids = self.labels.ids_of(label)
        if not ids:
            return float("nan")
        q, qnorms = self.preprocess_queries(np.asarray(blob).reshape(1, -1))
        qn = None if qnorms is None else qnorms[0]
        return min(self.host_distance(i, q[0], qn) for i in ids)

    def new_batch_iterator(self, query: np.ndarray, params: Optional[VecSimQueryParams] = None):
        from .hnsw_batch_iterator import HNSWBatchIterator

        return HNSWBatchIterator(self, query, params)

    # ------------------------------------------------------------------
    # Hybrid-policy heuristic (hnsw.h:2179-2313, sklearn decision tree)
    # ------------------------------------------------------------------

    def prefer_adhoc_search(self, subset_size: int, k: int, initial_check: bool = False) -> bool:
        index_size = self.index_size
        subset_size = min(subset_size, index_size)
        d = self.dim
        M = self.M
        r = 0.0 if index_size == 0 else subset_size / max(self.index_label_count, 1)
        if index_size <= 30000:
            if index_size <= 5500:
                res = True
            elif r <= 0.17:
                res = True
            elif k <= 12:
                if d <= 55:
                    res = False
                else:
                    res = M > 10
            else:
                res = True
        else:
            if r < 0.07:
                if index_size <= 750000:
                    res = True
                elif k <= 7:
                    res = False
                else:
                    res = r <= 0.03
            else:
                if d <= 75:
                    res = False
                elif k <= 12:
                    if r <= 0.21:
                        if M <= 57:
                            res = index_size <= 75000
                        else:
                            res = True
                    else:
                        res = False
                else:
                    if M <= 10:
                        res = r <= 0.17
                    elif index_size <= 300000:
                        res = True
                    else:
                        res = r <= 0.17
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
        return self._basic_info(VecSimAlgo.HNSWLIB)

    def _total_memory_bytes(self) -> int:
        total = self.memory_bytes + self.upper.memory_bytes
        if self._nav_cache is not None:
            nav = self._nav_cache[2]
            total += nav.numel() * nav.element_size()
        return total

    def stats_info(self) -> VecSimIndexStatsInfo:
        return VecSimIndexStatsInfo(
            memory=self._total_memory_bytes(),
            numberOfMarkedDeleted=self.num_marked_deleted,
        )

    def debug_info(self) -> VecSimIndexDebugInfo:
        ep_label = INVALID_LABEL
        if self.entry_id >= 0:
            ep_label = int(self.store.host["label"][self.entry_id])
        return VecSimIndexDebugInfo(
            commonInfo=CommonInfo(
                basicInfo=self.basic_info(),
                indexSize=self.index_size,
                indexLabelCount=self.index_label_count,
                memory=self._total_memory_bytes(),
                lastMode=self.last_mode,
            ),
            hnswInfo=HnswInfo(
                M=self.M,
                efConstruction=self.ef_construction,
                efRuntime=self.ef_runtime,
                epsilon=self.epsilon,
                max_level=max(self.max_level, 0),
                entrypoint=ep_label,
                visitedNodesPoolSize=0,
                numberOfMarkedDeletedNodes=self.num_marked_deleted,
            ),
        )

    def get_element_neighbors(self, label: int):
        """Debug parity: VecSimDebug_GetElementNeighborsInHNSWGraph
        (vec_sim_debug.h:37-44, hnsw.h:2317-2345)."""
        ids = self.labels.ids_of(label)
        if not ids:
            return None
        out = []
        for node in ids:
            per_level = []
            for lvl in range(0, self.node_level(node) + 1):
                per_level.append(
                    [int(self.store.host["label"][x]) for x in self.get_links(node, lvl)]
                )
            out.append(per_level)
        return out
