"""Multi-device scale-out: shard the vector store over a mesh of devices.

Counterpart of ``vectorsimilarity_tpu/parallel/sharding.py``. The JAX
package's mesh is single-controller: one process drives every device and a
``shard_map`` runs the same program on each. The port keeps that shape with
no collective library: a ``Mesh`` is one process's ordered list of torch
devices. Shard s's rows live on ``devices[s]`` (``core.store.ShardedRows``),
shard s is scanned there by the flat index's own engine (the kernels K1, K3
and K4, chosen by k as ``BruteForceIndex`` chooses them), and the [B, S*k]
candidates are merged on ``devices[0]``, the part the JAX package does with
one ``all_gather``. Shards that share a device share one copy of its rows,
so the one-card mesh ``[cuda:0] * 4`` holds the store once and runs four
shard scans over four views of it. ``torch.distributed`` is not used: NCCL
runs no two ranks on one card, and a process per rank would cost every test
a spawn.

Deletes keep working because swap-with-last relocations are row writes, and
row writes land in whichever shard owns the row.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.store import ShardedRows
from ..ops.distances import _lex_topk, streaming_topk
from ..types import VecSimMetric

AXIS = "shard"


def _normalized(device) -> torch.device:
    """A CUDA device without an index is the current one, so that
    ``"cuda"`` and ``"cuda:0"`` name one device of the mesh."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """An ordered list of torch devices, one per shard. ``shape[AXIS]`` is the
    shard count, as on a JAX mesh; a device may appear more than once (the
    one-card mesh ``[cuda:0] * 4``)."""

    def __init__(self, devices):
        self.devices = tuple(_normalized(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.shape = {AXIS: len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    def runs(self) -> list:
        """[(device, first shard, end shard)]: the maximal runs of
        consecutive shards on one device."""
        out = []
        for s, d in enumerate(self.devices):
            if out and out[-1][0] == d:
                out[-1] = (d, out[-1][1], s + 1)
            else:
                out.append((d, s, s + 1))
        return out

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(devices=None) -> Mesh:
    """A mesh over ``devices``; with none given, every visible CUDA device.
    Raises where there is none: a mesh never falls back to the CPU unless
    the caller names it (``make_mesh(["cpu"] * 8)``)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: name the mesh's devices, e.g. "
                               "make_mesh(['cpu'] * 8)")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return Mesh(devices)


def shard_rows(arr: torch.Tensor, mesh: Mesh) -> ShardedRows:
    """Place an [N, ...] tensor row-sharded over the mesh (N a multiple of
    the mesh size). Rows already on their shard's device are not copied."""
    return ShardedRows.place(arr, mesh)


def replicate(arr: torch.Tensor, mesh: Mesh) -> tuple:
    """``arr`` on every shard's device: one tensor per shard, the same one
    for shards that share a device. Kept for the JAX package's API; the
    port's own replicas are the indexes' ``_replica``."""
    on = {}
    for d in mesh.devices:
        if d not in on:
            on[d] = arr.to(d)
    return tuple(on[d] for d in mesh.devices)


def _shard_topk(q, arrs: tuple, live: int, k: int, *, metric, kind: str, qn):
    """Top-k of one shard's rows [0, live) on their device: the flat index's
    engine (``brute_force.engine_topk``: K1, K3, K4 or the streaming scan)
    for the float and int kinds, the streaming scan over ``scores_sq8`` for
    sq8."""
    if kind in ("float", "int"):
        from ..indexes.brute_force import engine_topk

        return engine_topk(q, arrs[0], arrs[1], live, k, metric=metric, kind=kind,
                           query_norms=qn)
    if kind == "sq8":
        from ..indexes.brute_force import _SCAN_CHUNK

        chunk = max(min(_SCAN_CHUNK, arrs[0].shape[0]), k)
        return streaming_topk(q, arrs, live, k, metric=metric, kind="sq8", chunk=chunk)
    raise ValueError(f"sharded_topk takes the float, int and sq8 kinds, got {kind!r}")


def sharded_topk(
    queries: torch.Tensor,
    store: tuple,
    count: int,
    k: int,
    *,
    metric: VecSimMetric,
    kind: str,
    mesh: Mesh,
    query_norms: Optional[torch.Tensor] = None,
):
    """Exact top-k over a row-sharded store.

    ``store`` holds the kind's columns ([N_global, ...] ``ShardedRows``, or
    tensors, which are placed over the mesh first; None where the kind has
    no such column): ``(data, sqnorms)`` for "float", ``(data, norms)`` for
    "int", ``(codes, vmin, delta, xsumsq)`` for "sq8". ``count`` is the
    global live-row count. Shard s owns the rows [s * n_s, (s + 1) * n_s),
    n_s = N_global / S, of which ``clamp(count - s * n_s, 0, n_s)`` are
    live; it answers min(k, n_s) candidates on its device, shifted by its
    offset and padded with (inf, -1). The [B, S*k] candidates merge on
    ``mesh.devices[0]`` under (distance, id) order: each shard's list is in
    that order and the shards' id ranges ascend, so a candidate's position
    in the concatenation orders ties by id. Returns (dists [B, k], ids
    [B, k] int64) on ``mesh.devices[0]``."""
    metric = VecSimMetric(metric)
    parts = tuple(None if a is None else a if isinstance(a, ShardedRows)
                  else ShardedRows.place(a, mesh) for a in store)
    S = mesh.size
    shard_n = parts[0].shape[0] // S
    count = int(count)
    B = queries.shape[0]
    kk = min(k, shard_n)
    out0 = mesh.devices[0]
    cand_d, cand_i = [], []
    for s, dev in enumerate(mesh.devices):
        live = max(0, min(count - s * shard_n, shard_n))
        if live == 0:
            d = torch.full((B, kk), float("inf"), dtype=torch.float32, device=out0)
            i = torch.full((B, kk), -1, dtype=torch.int64, device=out0)
        else:
            q = queries.to(dev)
            qn = None if query_norms is None else query_norms.to(dev)
            arrs = tuple(None if p is None else p.shard(s) for p in parts)
            d, i = _shard_topk(q, arrs, live, kk, metric=metric, kind=kind, qn=qn)
            i = torch.where(i >= 0, i.to(torch.int64) + s * shard_n, -1)
            d, i = d.to(out0, torch.float32), i.to(out0)
        cand_d.append(d)
        cand_i.append(i)
    all_d = torch.cat(cand_d, dim=1)  # [B, S * kk]
    all_i = torch.cat(cand_i, dim=1)
    if all_d.shape[1] < k:
        pad = k - all_d.shape[1]
        all_d = torch.cat([all_d, all_d.new_full((B, pad), float("inf"))], dim=1)
        all_i = torch.cat([all_i, all_i.new_full((B, pad), -1)], dim=1)
    vals, pos = _lex_topk(all_d, k)
    ids = torch.gather(all_i, 1, pos)
    return vals, torch.where(torch.isfinite(vals), ids, -1)


def query_parallel_search(index, queries, k: int, ef: int, mesh: Mesh):
    """Multi-device graph search: the query batch cut over the mesh, the
    graph replicated. Slice i of the batch is searched on ``mesh.devices[i]``
    against a replica of the index's device tensors there (one replica per
    distinct device; none where it is the index's own). The throughput axis
    of the graph indexes; the data axis belongs to the flat scan
    (``sharded_topk``).

    ``index`` is an ``HNSWIndex`` or ``SVSIndex``; ``queries`` [B, D] host
    rows as ``search_knn`` takes them, B a multiple of the mesh size.
    Returns host (dists, ids) like ``search_knn``."""
    queries = np.atleast_2d(np.asarray(queries))
    if len(queries) % mesh.size:
        raise ValueError("pad the query batch to the mesh size")
    return index.search_knn(queries, k, ef, mesh=mesh)


class ShardedFlatStore:
    """Host-side helper: keep flat-store columns sharded over a mesh. Pads the
    row count to a multiple of the mesh size. Kept for the JAX package's
    API; the flat index shards through ``BlockStore.set_sharding``, which
    re-shards on capacity growth."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh

    def pad_rows(self, n: int) -> int:
        s = self.mesh.size
        return ((n + s - 1) // s) * s

    def place(self, host_arrays: dict) -> dict:
        out = {}
        for name, arr in host_arrays.items():
            pad = self.pad_rows(arr.shape[0]) - arr.shape[0]
            if pad:
                arr = np.pad(arr, [(0, pad)] + [(0, 0)] * (arr.ndim - 1))
            out[name] = ShardedRows.place(torch.from_numpy(np.ascontiguousarray(arr)),
                                          self.mesh, copy=True)
        return out
