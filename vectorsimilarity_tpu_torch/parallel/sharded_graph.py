"""Data-sharded graph index: independent subgraphs, one per mesh device.

Counterpart of ``vectorsimilarity_tpu/parallel/sharded_graph.py``.
``parallel.sharding`` covers the flat scan (rows sharded, one top-k merge)
and query-parallel graph serving (graph replicated, query batch cut). This
module adds the remaining axis: the *dataset* is partitioned over the mesh,
each device owns an independent HNSW (or Vamana) subgraph over its
partition, a query searches every subgraph, and one top-k merge combines the
per-shard candidates on the mesh's first device.

Per-shard recall at ef equals single-graph recall at the same ef, because
each subgraph is an ordinary graph over its rows, and the merge of S exact
per-shard top-k lists is the exact top-k of their union. This scales index
*memory* (each device holds 1/S of the vectors and links), unlike
``to_query_sharded``, which scales only throughput.

Design notes:
- Per-shard stores are ordinary ``HNSWIndex`` / ``SVSIndex`` objects made on
  their own device (every mutation path is reused as it is); only the read
  path is the sharded one. The JAX package stacks the shards' arrays,
  padded to one shape, on a leading shard axis and vmaps one program over
  it; here each shard's tensors already live on its device and a loop runs
  each shard's search there, so no padded copy exists.
- Labels route to shards round-robin at first sight and stick (a label's
  values colocate, so multi-value dedup and overwrite stay per-shard
  problems the sub-index already solves).
- ``load`` pins every loaded shard to its mesh device (the JAX package's
  ``load`` leaves its device list unset, and its first query raises).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional

import numpy as np
import torch

from .. import config
from ..core.abstract_index import pow2_bucket
from ..core.results import QueryReply, make_reply
from ..indexes.hnsw import FLAG_DELETED, HNSWIndex
from ..ops.distances import _lex_topk
from ..ops.graph_search import StoreCtx, beam_search, dists_to_ids, greedy_level
from ..types import QueryReplyOrder, VecSimIndexStatsInfo, VecSimQueryParams


def _search_one_shard(q, qn, qm, shard, *, k: int, ef: int, metric, kind: str, expand: int):
    """Exact descent + beam over ONE shard's tensors, on its device; [B, k]
    local (dists, row ids), unfilled slots (inf, -1).

    ``HNSWIndex._device_search`` without the bf16 navigation shadow: the
    beam reads the exact rows (as the JAX package's stacked program does).
    Single-layer graphs (Vamana) have no upper store and go straight from
    the medoid into the beam. Quantized stores (sq8 / sq4 primaries) carry
    vmin / delta and the queries' (sum y, sum y^2) metadata ``qm``."""
    B = q.shape[0]
    if shard.store.count <= 0 or shard.entry_id < 0:
        return (torch.full((B, k), torch.inf, device=q.device),
                torch.full((B, k), -1, dtype=torch.int32, device=q.device))
    dev = shard.store.device_arrays()
    ctx = StoreCtx(data=dev["data"], sqnorm=dev.get("sqnorm"), norm=dev.get("norm"),
                   vmin=dev.get("vmin"), delta=dev.get("delta"))
    kw = dict(metric=metric, kind=kind, q_norm=qn, q_meta=qm)
    cur = torch.full((B,), shard.entry_id, dtype=torch.int32, device=q.device)
    cur_d = dists_to_ids(q, cur[:, None], ctx, **kw)[:, 0]
    upper = getattr(shard, "upper", None)
    if upper is not None:
        udev = upper.device_arrays()
        for lvl in range(shard.max_level, 0, -1):
            cur, cur_d = greedy_level(q, ctx, udev["links"], dev["upper_row"], cur, cur_d, lvl,
                                      **kw)
    links = dev["links0"] if upper is not None else dev["links"]
    bd, bi = beam_search(q, ctx, links, None, cur, cur_d, shard.store.capacity, ef=ef,
                         expand=expand, **kw)
    w = bd.shape[1]
    if w < k:
        bd = torch.cat([bd, bd.new_full((B, k - w), torch.inf)], dim=1)
        bi = torch.cat([bi, bi.new_full((B, k - w), -1)], dim=1)
    bd, bi = bd[:, :k], bi[:, :k]
    return torch.where(bi < 0, torch.inf, bd), bi


def sharded_graph_topk(q, qn, shards, devices, qm=None, *, k: int, ef: int, metric, kind: str,
                       expand: int, k_merge: Optional[int] = None):
    """All-shard search + global merge. Shard s is searched on ``devices[s]``
    (the queries moved there), then its [B, k] candidates move to
    ``devices[0]`` and the [B, S*k] merge keeps the ``k_merge`` (default k,
    at most S*k) best under (distance, shard, rank) order, the JAX
    ``lax.top_k`` order. ``k_merge`` widens the merge beyond k: the host
    filters tombstones and duplicate labels after it, so a crowded shard
    needs the extra width to keep k live labels in play.

    Returns device (dists [B, km], local row ids [B, km], shard_of [B, km]),
    shard_of -1 where the id is."""
    out0 = devices[0]
    cand_d, cand_i = [], []
    for shard, dev in zip(shards, devices):
        mv = lambda t: None if t is None else t.to(dev)  # noqa: E731
        bd, bi = _search_one_shard(mv(q), mv(qn), None if qm is None else tuple(map(mv, qm)),
                                   shard, k=k, ef=ef, metric=metric, kind=kind, expand=expand)
        cand_d.append(bd.to(out0, torch.float32))
        cand_i.append(bi.to(out0, torch.int64))
    all_d = torch.cat(cand_d, dim=1)
    all_i = torch.cat(cand_i, dim=1)
    km = k if k_merge is None else min(int(k_merge), all_d.shape[1])
    vals, sel = _lex_topk(all_d, km)
    ids = torch.gather(all_i, 1, sel)
    shard_of = torch.where(ids >= 0, sel // k, -1)
    return vals, ids, shard_of


class _ShardedGraphBase:
    """Shared machinery: label routing, per-shard delegation and the merged
    query path. Subclasses supply the per-shard index type."""

    def __init__(self, params, mesh, seed: int = 200):
        self.mesh = mesh
        self.n_shards = mesh.size
        self.params = params
        self._devs = list(mesh.devices)
        # Each shard is made on its mesh device, so its store, build and
        # search live there (the memory scale-out).
        self.shards = [self._new_shard(i, seed, self._devs[i]) for i in range(self.n_shards)]
        self._label_shard: dict[int, int] = {}
        self._rr = 0
        # One host lock serializes mutation against queries, the contract of
        # the single indexes (sub-index locks guard their own bookkeeping).
        self._lock = threading.RLock()

    # subclass hooks -----------------------------------------------------

    def _new_shard(self, i: int, seed: int, device):
        raise NotImplementedError

    def _window(self, k: int, params) -> int:
        raise NotImplementedError

    # -- write path ----------------------------------------------------

    def _shard_of_label(self, label: int) -> int:
        s = self._label_shard.get(label)
        if s is None:
            s = self._rr % self.n_shards
            self._rr += 1
            self._label_shard[label] = s
        return s

    def add_vector(self, blob, label: int) -> int:
        return self.add_vector_batch(np.atleast_2d(np.asarray(blob)), [label])

    def add_vector_batch(self, data, labels) -> int:
        with self._lock:
            data = np.atleast_2d(np.asarray(data))
            groups: dict[int, list[int]] = {}
            for i, lab in enumerate(labels):
                groups.setdefault(self._shard_of_label(int(lab)), []).append(i)
            return sum(self.shards[s].add_vector_batch(data[rows], [int(labels[i]) for i in rows])
                       for s, rows in groups.items())

    def delete_vector(self, label: int) -> int:
        with self._lock:
            s = self._label_shard.get(int(label))
            if s is None:
                return 0
            removed = self.shards[s].delete_vector(int(label))
            if removed:
                del self._label_shard[int(label)]
            return removed

    def bulk_build_device(self, data: torch.Tensor, n=None, labels=None, **kw) -> None:
        """Partition a dataset on the device round-robin (row i to shard
        i mod S, as strided views) and bulk-build every shard's subgraph
        with the single index's ``bulk_build_device``. The shards' deferred
        builds are driven in turns, one segment each per round. A segment
        reads its beams back to the host as it runs, so the turns are not
        shown to overlap shards' work (not measured on a multi-card mesh);
        the graphs equal those of shard-by-shard builds."""
        with self._lock:
            if self.size:
                raise ValueError("bulk_build_device requires an empty index")
            n = int(data.shape[0]) if n is None else int(n)
            labels = np.arange(n, dtype=np.int64) if labels is None else np.asarray(labels)
            S = self.n_shards
            gens = []
            try:
                for i, s in enumerate(self.shards):
                    rows = np.arange(i, n, S)
                    if not len(rows):
                        continue
                    gens.append(s.bulk_build_device(data[i:n:S].to(self._devs[i]),
                                                    labels=labels[rows].tolist(),
                                                    _deferred=True, **kw))
                    for lab in labels[rows]:
                        self._label_shard[int(lab)] = i
                while gens:
                    still = []
                    for g in gens:
                        try:
                            next(g)
                            still.append(g)
                        except StopIteration:
                            pass
                    gens = still
            finally:
                for g in gens:  # a failed round releases every shard's lock
                    g.close()
            self._rr = n

    @property
    def size(self) -> int:
        return sum(s.index_size for s in self.shards)

    @property
    def index_size(self) -> int:
        return self.size

    # -- batch iterator / info -----------------------------------------

    def new_batch_iterator(self, query, params: Optional[VecSimQueryParams] = None):
        """K-way merge of the per-shard resumable iterators (labels are
        disjoint across shards; see ``sharded_batch_iterator``)."""
        from .sharded_batch_iterator import ShardedBatchIterator

        return ShardedBatchIterator(self, query, params)

    def basic_info(self):
        """Shard 0's basic info: one shard defines type, metric and dim, and
        the shards are alike by construction."""
        return self.shards[0].basic_info()

    def stats_info(self) -> VecSimIndexStatsInfo:
        return VecSimIndexStatsInfo(
            memory=self.memory_bytes,
            numberOfMarkedDeleted=sum(s.num_marked_deleted for s in self.shards),
        )

    def debug_info(self):
        """Shard 0's structural fields with the sharded totals of size,
        label count and memory; ``shard_debug_info`` lists every shard's."""
        info = self.shards[0].debug_info()
        info.commonInfo.indexSize = self.index_size
        info.commonInfo.indexLabelCount = sum(s.index_label_count for s in self.shards)
        info.commonInfo.memory = self.memory_bytes
        return info

    def shard_debug_info(self) -> list:
        return [s.debug_info() for s in self.shards]

    @property
    def memory_bytes(self) -> int:
        """The sum of the shards' accounting. The shards' tensors are the
        ones the read path uses: there is no stacked or padded copy."""
        return sum(s.memory_bytes for s in self.shards)

    # -- read path -----------------------------------------------------

    def topk_query(self, query, k: int, params: Optional[VecSimQueryParams] = None) -> QueryReply:
        return self.topk_query_batch(np.atleast_2d(np.asarray(query)), k, params)[0]

    def topk_query_batch(self, queries, k: int,
                         params: Optional[VecSimQueryParams] = None) -> list[QueryReply]:
        s0 = self.shards[0]
        queries = np.atleast_2d(np.asarray(queries))
        nq = len(queries)
        if self.size == 0 or k <= 0:
            return [make_reply([], []) for _ in range(nq)]
        ef = self._window(k, params)
        q, qnorms = s0.preprocess_queries(queries)[:2]
        with self._lock:
            return self._query_locked(q, qnorms, k, ef, nq)

    def _query_locked(self, q, qnorms, k, ef, nq):
        s0 = self.shards[0]
        S = self.n_shards
        # Tombstoned rows and (multi) duplicate values survive the merge and
        # are filtered here, so the merge carries an allowance, or a crowded
        # shard would underfill k (the single indexes widen their window the
        # same way).
        tomb = sum(s.num_marked_deleted for s in self.shards)
        dups = 0
        if s0.multi:
            dups = sum(max(0, s.store.count - len(s.labels.label_to_ids)) for s in self.shards)
        flags = [s.store.host["flags"] for s in self.shards]
        id_to_label = [s.store.host["label"] for s in self.shards]
        live_total = sum(len(s.labels.label_to_ids if s0.multi else s.labels.label_to_id)
                         for s in self.shards)
        target = min(k, live_total)
        max_count = max(s.store.count for s in self.shards)
        w_cap = max(pow2_bucket(max_count), 1)
        kq_cap = S * w_cap  # every row of every shard

        def dispatch(qd, qn, ef_eff, kq):
            ef_pad = min(pow2_bucket(max(ef_eff, k)), w_cap)
            ks = min(kq, ef_pad)  # per-shard return width
            km = min(kq, S * ks)  # global merge width
            qm = None
            if s0.store_kind in ("sq8", "sq4"):
                # The asymmetric distance's query metadata (sum y, sum y^2):
                # queries stay float against the shards' quantized rows.
                qm = (torch.sum(qd, dim=-1), torch.sum(qd * qd, dim=-1))
            bd, bi, bs = sharded_graph_topk(
                qd, qn, self.shards, self._devs, qm, k=ks, ef=ef_pad, metric=s0.metric,
                kind=s0.store_kind, expand=config.resolve_search_expand(ef_eff), k_merge=km,
            )
            return bd.cpu().numpy(), bi.cpu().numpy(), bs.cpu().numpy(), ef_pad, km

        def collect(bd, bi, bs, b, kq):
            rows = []
            seen: set[int] = set()
            for j in range(kq):
                s, i = int(bs[b, j]), int(bi[b, j])
                if s < 0 or i < 0 or flags[s][i] & FLAG_DELETED:
                    continue
                lab = int(id_to_label[s][i])
                if s0.multi and lab in seen:
                    continue
                seen.add(lab)
                rows.append((lab, float(bd[b, j])))
                if len(rows) >= k:
                    break
            return rows

        qd, qn = s0.to_device(q), s0.to_device(qnorms)
        kq0 = k + min(tomb + dups, 3 * k + 8)
        bd, bi, bs, ef_pad, kq0 = dispatch(qd, qn, ef, kq0)
        out = []
        for b in range(nq):
            rows = collect(bd, bi, bs, b, kq0)
            # Deficiency retry: a tombstone-heavy or duplicate-crowded shard
            # can still underfill; re-search this query with a doubled window
            # AND merge width. At w == w_cap and kq == S * w_cap the merge is
            # a full sort of every row of every shard, so stopping there
            # means every live label was seen.
            w, kq = ef_pad, kq0
            while len(rows) < target and not (w >= w_cap and kq >= kq_cap):
                w = min(w * 2, w_cap)
                kq = min(kq * 2, kq_cap)
                bd2, bi2, bs2, w, kq = dispatch(qd[b : b + 1],
                                                None if qn is None else qn[b : b + 1], w, kq)
                rows = collect(bd2, bi2, bs2, 0, kq)
            out.append(make_reply([r[0] for r in rows], [r[1] for r in rows]))
        return out

    def range_query(self, query, radius: float, params=None, order=None):
        """Union of the per-shard epsilon-range searches, merged on the host
        (range results have no fixed size to merge on the device); each
        shard runs its own index's range search (hnsw.h:1991-2092)."""
        order = QueryReplyOrder.BY_SCORE if order is None else order
        ids: list[int] = []
        scores: list[float] = []
        with self._lock:
            for s in self.shards:
                r = (s.range_query(query, radius, params) if params is not None
                     else s.range_query(query, radius))
                ids += r.ids.tolist()
                scores += r.scores.tolist()
        ids_a = np.asarray(ids, dtype=np.int64)
        sc_a = np.asarray(scores, dtype=np.float64)
        if order == QueryReplyOrder.BY_ID:
            o = np.argsort(ids_a, kind="stable")
        else:
            o = np.lexsort((ids_a, sc_a))
        return make_reply(ids_a[o], sc_a[o])

    # -- persistence ---------------------------------------------------

    def save(self, path: str) -> None:
        """A directory: ``shard_<i>.npz`` (each by ``utils.serializer``, the
        format both packages read) and ``routing.json`` (the label -> shard
        map and the round-robin cursor)."""
        from ..utils.serializer import save_index

        with self._lock:
            os.makedirs(path, exist_ok=True)
            for i, s in enumerate(self.shards):
                save_index(s, os.path.join(path, f"shard_{i}.npz"))
            with open(os.path.join(path, "routing.json"), "w") as f:
                json.dump({"n_shards": self.n_shards, "rr": self._rr,
                           "label_shard": {str(k): v for k, v in self._label_shard.items()}}, f)

    @classmethod
    def load(cls, path: str, mesh):
        """The index saved at ``path``, shard i loaded onto ``mesh.devices[i]``
        (its device list set and every shard pinned, which the JAX
        package's ``load`` omits)."""
        from ..utils.serializer import load_index

        with open(os.path.join(path, "routing.json")) as f:
            routing = json.load(f)
        n = routing["n_shards"]
        if mesh.size != n:
            raise ValueError(f"index was saved with {n} shards; mesh has {mesh.size}")
        shards = [load_index(os.path.join(path, f"shard_{i}.npz"), device=mesh.devices[i])
                  for i in range(n)]
        return cls._from_shards(shards, mesh, routing["label_shard"], routing["rr"])

    @classmethod
    def _from_shards(cls, shards: list, mesh, label_shard: dict, rr: int):
        """An index over ready shards, shard i already on ``mesh.devices[i]``,
        with its label -> shard map and round-robin cursor."""
        if mesh.size != len(shards):
            raise ValueError(f"{len(shards)} shards; the mesh has {mesh.size} devices")
        obj = cls.__new__(cls)
        obj.mesh = mesh
        obj.n_shards = len(shards)
        obj._devs = list(mesh.devices)
        obj.shards = list(shards)
        obj.params = shards[0].params
        obj._label_shard = {int(k): int(v) for k, v in label_shard.items()}
        obj._rr = int(rr)
        obj._lock = threading.RLock()
        return obj


class ShardedHNSW(_ShardedGraphBase):
    """HNSW with the dataset partitioned over a mesh of devices (see the
    module docstring): write paths go to per-shard ``HNSWIndex`` objects
    (round-robin label routing); the read path searches every subgraph on
    its device and merges once (``sharded_graph_topk``)."""

    def _new_shard(self, i: int, seed: int, device):
        return HNSWIndex(self.params, seed=seed + 1000 * i, device=device)

    def _window(self, k: int, params) -> int:
        return self.shards[0]._effective_ef(k, params)


class ShardedVamana(_ShardedGraphBase):
    """SVS-Vamana with the dataset partitioned over the mesh, the
    single-layer sibling of ``ShardedHNSW``: each device owns an independent
    Vamana subgraph (medoid entry, alpha-pruned links), searched from its own
    medoid before the merge. Takes unquantized stores and the single-level
    SQ8 / LVQ4 primaries (the asymmetric distance reads each shard's vmin /
    delta). The two-level residual and LeanVec modes re-rank per shard with
    their own secondary codes and projection, which the merged path does not
    do: serve those with ``to_query_sharded`` instead."""

    def _new_shard(self, i: int, seed: int, device):
        from ..indexes.svs import SVSIndex

        shard = SVSIndex(self.params, device=device)
        if shard.res_bits or shard.is_leanvec:
            raise ValueError(
                "ShardedVamana supports unquantized or single-level SQ8/LVQ4 SVS indexes only "
                "(no residual/LeanVec rerank)"
            )
        return shard

    def _window(self, k: int, params) -> int:
        return self.shards[0]._effective_ws(k, params)
