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

``export_tiered_state`` does the same for a tiered HNSW index of either
package: the frontend as flat state (with its ``opid`` column where the
index is multi-value), the backend as HNSW state, and the tiered counters.
It raises while insert jobs are pending or mid-migration: their vectors are
in neither tier's final place. ``tiered_from_state`` builds this package's
``TieredHNSWIndex`` (with no job queue: its jobs run inline), and
``tiered_from_jax`` chains the two.

Nothing here imports jax: a caller holding a JAX index hands it over, and
only numpy comes back out of it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .indexes.brute_force import BruteForceIndex
from .indexes.hnsw import HNSWIndex
from .indexes.tiered import TieredHNSWIndex
from .types import (
    BFParams,
    HNSWParams,
    TieredHNSWParams,
    TieredIndexParams,
    VecSimAlgo,
    VecSimMetric,
    VecSimParams,
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


def export_tiered_state(index) -> dict:
    """State of a tiered HNSW index of either package (see the module
    docstring); plain Python and numpy values only. Raises ``ValueError``
    while insert jobs are pending."""
    with index._glock:
        if index._insert_jobs or index._inflight:
            raise ValueError("insert jobs are pending: wait for the job queue to drain first")
        return {
            "flat_buffer_limit": int(index.flat_buffer_limit),
            "swap_job_threshold": int(index.swap_job_threshold),
            "pending_swaps": int(index._pending_swaps),
            "direct_hnsw_insertions": int(index.direct_hnsw_insertions),
            "op_counter": int(index._op_counter),
            "frontend": export_state(index.frontend),
            "backend": export_hnsw_state(index.backend),
        }


def tiered_from_state(state: dict, *, device=None) -> TieredHNSWIndex:
    """This package's ``TieredHNSWIndex`` on ``device`` (the current CUDA
    device by default, the CPU only on request) holding the exported tiers,
    with no job queue (jobs run inline)."""
    params = TieredIndexParams(
        primaryIndexParams=VecSimParams(
            algo=VecSimAlgo.HNSWLIB, hnswParams=_hnsw_params(state["backend"]["params"])
        ),
        flatBufferLimit=state["flat_buffer_limit"],
        tieredHnswParams=TieredHNSWParams(swapJobThreshold=state["swap_job_threshold"]),
    )
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
