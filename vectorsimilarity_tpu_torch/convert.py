"""Carry an index's state across packages as numpy.

``export_state`` reads the state of a flat index of either package — the
JAX package's or this one's — through attributes the two share (params,
store, label map), and returns plain Python and numpy values only.
``bruteforce_from_state`` builds this package's ``BruteForceIndex`` from
such a state.

``export_hnsw_state`` does the same for an HNSW index of either package: the
store's host columns (data, label, ``level``, ``upper_row``, ``links0``,
``nlinks0``, ``flags``, and ``sqnorm`` / ``norm`` / ``slot`` where the index
has them), the upper store's ``links``, ``nlinks`` and ``vec``, the entry
point, the maximum level, the tombstone count, the label map and the level
sampler's RNG state. Device-built links are pulled to the host first.
``hnsw_from_state`` builds this package's ``HNSWIndex`` holding the same
graph, and ``hnsw_from_jax(index, device=...)`` chains the two: a JAX
``HNSWIndex`` carried across, so both packages can be searched on one graph.
An HNSW index of this package can be carried from one device to another the
same way.

``export_svs_state`` does the same for an SVS index of either package: the
store's host columns (codes or rows, ``links``, ``nlinks``, ``flags``, and
``vmin`` / ``delta`` / ``res`` / ``rvmin`` / ``rdelta`` / ``sqnorm`` /
``rsq`` / ``norm`` / ``slot`` where the mode has them), the medoid entry,
the tombstone count, the medoid refresh counter, the label map and the
LeanVec projection ``_P``. ``svs_from_state`` and ``svs_from_jax`` build
this package's ``SVSIndex`` from it.

``export_tiered_state`` does the same for a tiered HNSW or tiered SVS index
of either package: the frontend as flat state (with its ``opid`` column
where the index is multi-value), the backend as HNSW or SVS state, and the
tiered counters and thresholds. It raises while jobs are pending or
mid-migration: their vectors are in neither tier's final place.
``tiered_from_state`` builds this package's ``TieredHNSWIndex`` or
``TieredSVSIndex`` (with no job queue: its jobs run inline), and
``tiered_from_jax`` / ``tiered_svs_from_jax`` chain the two.

``sharded_hnsw_from_jax`` / ``sharded_vamana_from_jax`` carry a JAX
package's data-sharded graph index across onto a mesh of this package
(``parallel.make_mesh``): each shard through ``hnsw_from_jax`` /
``svs_from_jax`` onto its mesh device, with the label -> shard map and the
round-robin cursor. A sharded flat index is ``bruteforce_from_state``
followed by ``.to_sharded(mesh)``.

Nothing here imports jax: a caller holding a JAX index hands it over, and
only numpy comes back out of it.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .indexes.brute_force import BruteForceIndex
from .indexes.hnsw import HNSWIndex
from .indexes.svs import SVSIndex
from .indexes.tiered import TieredHNSWIndex
from .indexes.tiered_svs import TieredSVSIndex
from .types import (
    BFParams,
    HNSWParams,
    SVSParams,
    TieredHNSWParams,
    TieredIndexParams,
    TieredSVSParams,
    VecSimAlgo,
    VecSimMetric,
    VecSimOptionMode,
    VecSimParams,
    VecSimSvsQuantBits,
    VecSimType,
)


def _label_state(labels) -> dict:
    if hasattr(labels, "label_to_ids"):  # MultiLabelMap
        return {
            "label_to_ids": {int(l): sorted(ids) for l, ids in labels.label_to_ids.items()},
            "label_to_slot": {int(l): int(s) for l, s in labels.label_to_slot.items()},
            "free_slots": [int(s) for s in labels._free_slots],
            "next_slot": int(labels._next_slot),
        }
    return {"label_to_id": {int(l): int(i) for l, i in labels.label_to_id.items()}}


def _store_state(store) -> dict:
    """count, capacity and host arrays (rows [0, count), after
    ``pull_host``) of a block store of either package."""
    store.pull_host()
    count = int(store.count)
    return {
        "count": count,
        "capacity": int(store.capacity),
        "arrays": {n: np.array(a[:count]) for n, a in store.host.items()},
    }


def _params_state(params) -> dict:
    values = {f.name: getattr(params, f.name) for f in dataclasses.fields(params)}
    # Enum members (ints) of either package become plain ints.
    return {n: int(v) if isinstance(v, int) else v for n, v in values.items()}


def export_state(index) -> dict:
    """State of a flat index: params (plain values), count, capacity, the
    store's host arrays (rows [0, count), after ``pull_host``) and the label
    map."""
    return {
        "params": _params_state(index.params),
        **_store_state(index.store),
        "labels": _label_state(index.labels),
    }


def _fill_store(store, state: dict) -> None:
    arrays = state["arrays"]
    if set(arrays) != set(store.fields):
        raise ValueError(f"fields {sorted(arrays)} do not match {sorted(store.fields)}")
    store._resize(state["capacity"])
    if state["count"]:
        store.append({n: arrays[n] for n in store.fields})


def _fill_labels(index, lab: dict) -> None:
    if index.multi:
        m = index.labels
        m.label_to_ids = {l: set(ids) for l, ids in lab["label_to_ids"].items()}
        m.label_to_slot = dict(lab["label_to_slot"])
        m._slot_to_label = {s: l for l, s in m.label_to_slot.items()}
        m._free_slots = list(lab["free_slots"])
        m._next_slot = lab["next_slot"]
    else:
        index.labels.label_to_id = dict(lab["label_to_id"])


def bruteforce_from_state(state: dict, *, device=None) -> BruteForceIndex:
    """This package's ``BruteForceIndex`` on ``device`` (the current CUDA
    device by default, the CPU only on request) holding the same rows, ids,
    labels and label slots as the exported index."""
    p = state["params"]
    params = BFParams(
        type=VecSimType(p["type"]),
        dim=int(p["dim"]),
        metric=VecSimMetric(p["metric"]),
        multi=bool(p["multi"]),
        initialCapacity=int(p["initialCapacity"]),
        blockSize=int(p["blockSize"]),
    )
    index = BruteForceIndex(params, device=device)
    _fill_store(index.store, state)
    _fill_labels(index, state["labels"])
    return index


def export_hnsw_state(index) -> dict:
    """State of an HNSW index of either package (see the module docstring);
    plain Python and numpy values only."""
    index._ensure_host_links()
    return {
        "params": _params_state(index.params),
        **_store_state(index.store),
        "upper": _store_state(index.upper),
        "lmax": int(index.lmax),
        "entry_id": int(index.entry_id),
        "max_level": int(index.max_level),
        "num_marked_deleted": int(index.num_marked_deleted),
        "labels": _label_state(index.labels),
        "rng": index._rng.bit_generator.state,
    }


def _hnsw_params(p: dict) -> HNSWParams:
    return HNSWParams(
        type=VecSimType(p["type"]),
        dim=int(p["dim"]),
        metric=VecSimMetric(p["metric"]),
        multi=bool(p["multi"]),
        initialCapacity=int(p["initialCapacity"]),
        blockSize=int(p["blockSize"]),
        M=int(p["M"]),
        efConstruction=int(p["efConstruction"]),
        efRuntime=int(p["efRuntime"]),
        epsilon=float(p["epsilon"]),
    )


def hnsw_from_state(state: dict, *, device=None) -> HNSWIndex:
    """This package's ``HNSWIndex`` on ``device`` (the current CUDA device by
    default, the CPU only on request) holding the exported graph, rows, ids,
    labels, entry point and level sampler."""
    index = HNSWIndex(_hnsw_params(state["params"]), device=device)
    index.lmax = state["lmax"]
    index.upper = index._new_upper_store(index.lmax)
    _fill_store(index.store, state)
    _fill_store(index.upper, state["upper"])
    _fill_labels(index, state["labels"])
    index.entry_id = state["entry_id"]
    index.max_level = state["max_level"]
    index.num_marked_deleted = state["num_marked_deleted"]
    index._rng.bit_generator.state = state["rng"]
    return index


def hnsw_from_jax(index, *, device=None) -> HNSWIndex:
    """A JAX package ``HNSWIndex`` carried across to this package's."""
    return hnsw_from_state(export_hnsw_state(index), device=device)


def export_svs_state(index) -> dict:
    """State of an SVS index of either package (see the module docstring);
    plain Python and numpy values only."""
    index._ensure_host_links()
    P = index._P
    if isinstance(P, torch.Tensor):
        P = P.cpu().numpy()
    return {
        "params": _params_state(index.params),
        **_store_state(index.store),
        "entry_id": int(index.entry_id),
        "num_marked_deleted": int(index.num_marked_deleted),
        "inserts_since_medoid": int(index._inserts_since_medoid),
        "labels": _label_state(index.labels),
        "P": None if P is None else np.array(P, dtype=np.float32),
    }


def _svs_params(p: dict) -> SVSParams:
    return dataclasses.replace(
        SVSParams(**p),
        type=VecSimType(p["type"]),
        metric=VecSimMetric(p["metric"]),
        quantBits=VecSimSvsQuantBits(p["quantBits"]),
        use_search_history=VecSimOptionMode(p["use_search_history"]),
    )


def svs_from_state(state: dict, *, device=None) -> SVSIndex:
    """This package's ``SVSIndex`` on ``device`` (the current CUDA device by
    default, the CPU only on request) holding the exported graph, codes,
    ids, labels, entry point and LeanVec projection."""
    index = SVSIndex(_svs_params(state["params"]), device=device)
    _fill_store(index.store, state)
    _fill_labels(index, state["labels"])
    index.entry_id = state["entry_id"]
    index.num_marked_deleted = state["num_marked_deleted"]
    index._inserts_since_medoid = state["inserts_since_medoid"]
    if state["P"] is not None:
        index._P = torch.from_numpy(state["P"]).to(index.device)
    return index


def svs_from_jax(index, *, device=None) -> SVSIndex:
    """A JAX package ``SVSIndex`` carried across to this package's."""
    return svs_from_state(export_svs_state(index), device=device)


def export_tiered_state(index) -> dict:
    """State of a tiered HNSW or SVS index of either package (see the module
    docstring); plain Python and numpy values only. Raises ``ValueError``
    while jobs are pending."""
    with index._glock:
        svs = hasattr(index, "update_threshold")
        if index._insert_jobs or index._inflight or getattr(index, "_update_scheduled", False):
            raise ValueError("jobs are pending: wait for the job queue to drain first")
        state = {
            "flat_buffer_limit": int(index.flat_buffer_limit),
            "swap_job_threshold": int(index.swap_job_threshold),
            "pending_swaps": int(index._pending_swaps),
            "direct_hnsw_insertions": int(index.direct_hnsw_insertions),
            "op_counter": int(index._op_counter),
            "frontend": export_state(index.frontend),
            "backend": (export_svs_state if svs else export_hnsw_state)(index.backend),
        }
        if svs:
            state["training_threshold"] = int(index.training_threshold)
            state["update_threshold"] = int(index.update_threshold)
        return state


def tiered_from_state(state: dict, *, device=None):
    """This package's ``TieredHNSWIndex`` or ``TieredSVSIndex`` on ``device``
    (the current CUDA device by default, the CPU only on request) holding
    the exported tiers, with no job queue (jobs run inline)."""
    svs = "update_threshold" in state
    bp = state["backend"]["params"]
    primary = (
        VecSimParams(algo=VecSimAlgo.SVS, svsParams=_svs_params(bp)) if svs
        else VecSimParams(algo=VecSimAlgo.HNSWLIB, hnswParams=_hnsw_params(bp))
    )
    params = TieredIndexParams(
        primaryIndexParams=primary,
        flatBufferLimit=state["flat_buffer_limit"],
        tieredHnswParams=TieredHNSWParams(swapJobThreshold=state["swap_job_threshold"]),
    )
    if svs:
        params.tieredSVSParams = TieredSVSParams(
            trainingTriggerThreshold=state["training_threshold"],
            updateTriggerThreshold=state["update_threshold"],
        )
        index = TieredSVSIndex(params, device=device)
        index.backend = svs_from_state(state["backend"], device=index.device)
    else:
        index = TieredHNSWIndex(params, device=device)
        index.backend = hnsw_from_state(state["backend"], device=index.device)
    _fill_store(index.frontend.store, state["frontend"])
    _fill_labels(index.frontend, state["frontend"]["labels"])
    index._pending_swaps = state["pending_swaps"]
    index.direct_hnsw_insertions = state["direct_hnsw_insertions"]
    index._op_counter = state["op_counter"]
    return index


def tiered_from_jax(index, *, device=None) -> TieredHNSWIndex:
    """A JAX package ``TieredHNSWIndex`` carried across to this package's;
    raises while its insert jobs are pending."""
    return tiered_from_state(export_tiered_state(index), device=device)


def tiered_svs_from_jax(index, *, device=None) -> TieredSVSIndex:
    """A JAX package ``TieredSVSIndex`` carried across to this package's;
    raises while a batch update is pending or mid-migration."""
    return tiered_from_state(export_tiered_state(index), device=device)


def _sharded_from_jax(cls, index, mesh, shard_from_jax):
    if mesh.size != len(index.shards):
        raise ValueError(f"the index has {len(index.shards)} shards; the mesh {mesh.size}")
    shards = [shard_from_jax(s, device=d) for s, d in zip(index.shards, mesh.devices)]
    return cls._from_shards(shards, mesh, index._label_shard, index._rr)


def sharded_hnsw_from_jax(index, mesh):
    """A JAX package ``ShardedHNSW`` carried across to this package's, shard
    i on ``mesh.devices[i]``."""
    from .parallel.sharded_graph import ShardedHNSW

    return _sharded_from_jax(ShardedHNSW, index, mesh, hnsw_from_jax)


def sharded_vamana_from_jax(index, mesh):
    """A JAX package ``ShardedVamana`` carried across to this package's,
    shard i on ``mesh.devices[i]``."""
    from .parallel.sharded_graph import ShardedVamana

    return _sharded_from_jax(ShardedVamana, index, mesh, svs_from_jax)
