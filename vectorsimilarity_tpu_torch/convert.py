"""Carry a flat index's state across packages as numpy.

``export_state`` reads the state of a flat index of either package — the
JAX package's or this one's — through attributes the two share (params,
store, label map), and returns plain Python and numpy values only.
``bruteforce_from_state`` builds this package's ``BruteForceIndex`` from
such a state. Nothing here imports jax: a caller holding a JAX index hands
it over, and only numpy comes back out of it.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .indexes.brute_force import BruteForceIndex
from .types import BFParams, VecSimMetric, VecSimType


def _label_state(labels) -> dict:
    if hasattr(labels, "label_to_ids"):  # MultiLabelMap
        return {
            "label_to_ids": {int(l): sorted(ids) for l, ids in labels.label_to_ids.items()},
            "label_to_slot": {int(l): int(s) for l, s in labels.label_to_slot.items()},
            "free_slots": [int(s) for s in labels._free_slots],
            "next_slot": int(labels._next_slot),
        }
    return {"label_to_id": {int(l): int(i) for l, i in labels.label_to_id.items()}}


def export_state(index) -> dict:
    """State of a flat index: params (plain values), count, capacity, the
    store's host arrays (rows [0, count), after ``pull_host``) and the label
    map."""
    index.store.pull_host()
    count = int(index.store.count)
    params = {f.name: getattr(index.params, f.name) for f in dataclasses.fields(index.params)}
    return {
        # Enum members (ints) of either package become plain ints.
        "params": {n: int(v) if isinstance(v, int) else v for n, v in params.items()},
        "count": count,
        "capacity": int(index.store.capacity),
        "arrays": {n: np.array(a[:count]) for n, a in index.store.host.items()},
        "labels": _label_state(index.labels),
    }


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
    store = index.store
    arrays = state["arrays"]
    if set(arrays) != set(store.fields):
        raise ValueError(f"fields {sorted(arrays)} do not match {sorted(store.fields)}")
    store._resize(state["capacity"])
    if state["count"]:
        store.append({n: arrays[n] for n in store.fields})
    lab = state["labels"]
    if params.multi:
        m = index.labels
        m.label_to_ids = {l: set(ids) for l, ids in lab["label_to_ids"].items()}
        m.label_to_slot = dict(lab["label_to_slot"])
        m._slot_to_label = {s: l for l, s in m.label_to_slot.items()}
        m._free_slots = list(lab["free_slots"])
        m._next_slot = lab["next_slot"]
    else:
        index.labels.label_to_id = dict(lab["label_to_id"])
    return index
