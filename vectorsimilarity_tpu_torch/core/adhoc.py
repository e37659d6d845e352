"""Ad-hoc brute-force scoring context.

Counterpart of ``vectorsimilarity_tpu/core/adhoc.py`` (reference:
``vec_sim_adhoc_bf_ctx.h`` + ``vec_sim.h:236-274``). The hybrid ad-hoc
policy scores each filtered label directly instead of searching; the context
holds the preprocessed query so repeated per-label scoring skips
preprocessing, and ``get_exact_distances`` scores all requested labels in
one device gather (``graph_search.dists_to_ids``) instead of a per-label
loop; on a row-sharded flat index (``to_sharded``), one gather per shard,
on the shard's device. Serves the flat, the HNSW and the SVS index: SVS's quantized stores
carry the query metadata (sum y, sum y^2), and its two-level and LeanVec
modes score through the index's re-rank decode (``exact_gathered_dists``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.graph_search import StoreCtx, dists_to_ids


class AdhocBfCtx:
    def __init__(self, index, query: np.ndarray):
        self.index = index
        pre = index.preprocess_queries(np.asarray(query).reshape(1, -1))
        self._q, self._qn = pre[:2]
        self._qm = pre[2] if len(pre) == 3 else None  # SVS: (q, q_norm, q_meta)

    def get_distance(self, label: int) -> float:
        """Min distance to the label's vectors; NaN if absent
        (``VecSimIndex_AdhocBfCtx_GetDistanceFrom``)."""
        return float(self.get_exact_distances([label])[0])

    def get_exact_distances(self, labels) -> np.ndarray:
        """Distances for many labels in one device call
        (``VecSimIndex_AdhocBfCtx_GetExactDistances``)."""
        index = self.index
        ids_per_label = [index.labels.ids_of(int(l)) for l in labels]
        width = max((len(x) for x in ids_per_label), default=0)
        if width == 0:
            return np.full(len(labels), np.nan)
        ids = np.full((len(labels), width), -1, dtype=np.int32)
        for r, lst in enumerate(ids_per_label):
            ids[r, : len(lst)] = lst
        n = len(labels)
        if getattr(index, "res_bits", 0):
            # Two-level / LeanVec SVS stores: the index's re-rank decode is
            # the exact scoring surface (the primary store may live in a
            # projected space the gather cannot score).
            d = index.exact_gathered_dists(np.broadcast_to(self._q[0], (n, self._q.shape[1])), ids)
        else:
            dev = index.store.device_arrays()
            cols = {f: dev.get(f) for f in ("data", "sqnorm", "norm", "vmin", "delta")}
            mesh = getattr(index, "mesh", None)  # the row-sharded flat index
            if mesh is None:
                d = self._dists(StoreCtx(**cols), ids, index.device)
            else:
                # Each id is scored on the device of the shard that owns it.
                d = np.full(ids.shape, np.inf, dtype=np.float32)
                shard_n = cols["data"].shard_n
                for s, device in enumerate(mesh.devices):
                    lo = s * shard_n
                    own = (ids >= lo) & (ids < lo + shard_n)
                    if own.any():
                        ctx = StoreCtx(**{f: None if c is None else c.shard(s)
                                          for f, c in cols.items()})
                        local = np.where(own, ids - lo, -1).astype(np.int32)
                        d[own] = self._dists(ctx, local, device)[own]
        best = d.min(axis=1)
        best[~np.isfinite(best)] = np.nan
        return best

    def _dists(self, ctx: StoreCtx, ids: np.ndarray, device) -> np.ndarray:
        """Masked distances from the query to rows ``ids`` [n, width] of
        ``ctx``'s tensors, which live on ``device``."""
        n = ids.shape[0]
        index = self.index
        q = index.to_device(self._q).to(device).expand(n, -1)
        qn = None if self._qn is None else index.to_device(self._qn).to(device).expand(n)
        qm = None if self._qm is None else tuple(
            torch.from_numpy(np.asarray(m[0:1])).to(device).expand(n) for m in self._qm)
        return dists_to_ids(
            q, torch.from_numpy(ids).to(device), ctx,
            metric=index.metric, kind=index.store_kind, q_norm=qn, q_meta=qm,
        ).cpu().numpy()
