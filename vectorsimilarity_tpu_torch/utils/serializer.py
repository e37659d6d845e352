"""Index serialization — versioned save/load.

Counterpart of ``vectorsimilarity_tpu/utils/serializer.py`` (the reference's
``utils/serializer.h:37-60`` and ``hnsw_serializer_impl.h``). The format
("vstpu-v1") is the JAX package's, file for file: one ``.npz`` holding a
JSON metadata blob (``__meta__``: params, entry point, counters) and the
store's host columns under ``s_<field>`` (the HNSW upper store's under
``u_<field>``). The columns ARE the index, so save and load are a dump and a
restore, with the label maps rebuilt from the label / slot / flags columns.
Either package reads the other's files.

One divergence: the JAX package never saves an SVS index's LeanVec
projection, so its reloaded LeanVec index fails at its first query. Here the
projection goes under one more key, ``leanvec_P`` (the JAX loader reads only
``s_`` / ``u_`` keys and ignores it), and is restored on load; a LeanVec file
without it (written by the JAX package) is refused with ``ValueError``.

``load_index`` puts the index on ``device``: the current CUDA device by
default (an error where there is none), the CPU only on request.
``check_integrity`` is the reference's ``checkIntegrity``.
"""

from __future__ import annotations

import dataclasses
import json

import numpy as np
import torch

from ..core.labels import rebuild_labels
from ..types import (
    BFParams,
    HNSWParams,
    SVSParams,
    VecSimMetric,
    VecSimOptionMode,
    VecSimSvsQuantBits,
    VecSimType,
)

FORMAT_VERSION = "vstpu-v1"
LEANVEC_KEY = "leanvec_P"


def _params_to_dict(p) -> dict:
    d = dataclasses.asdict(p)
    for k, v in d.items():
        if hasattr(v, "value"):
            d[k] = int(v)
    return d


def _store_arrays(store, prefix: str) -> dict[str, np.ndarray]:
    return {f"{prefix}{name}": store.host[name][: store.count] for name in store.fields}


def _restore_store(store, arrays: dict, prefix: str, count: int) -> None:
    store._maybe_grow(count)
    for name in store.fields:
        store.host[name][:count] = arrays[f"{prefix}{name}"]
    store.count = count
    store._dirty_from = 0


def save_index(index, path: str) -> None:
    """Write ``index`` (flat, HNSW or SVS) to ``path`` as one ``.npz``.
    Device-authoritative links and rows (a device build, an adopted store)
    are pulled to the host first. A tiered index raises ``ValueError``:
    the reference serializes backend indexes only."""
    from ..indexes.brute_force import BruteForceIndex
    from ..indexes.hnsw import HNSWIndex
    from ..indexes.svs import SVSIndex
    from ..indexes.tiered import TieredHNSWIndex
    from ..indexes.tiered_svs import TieredSVSIndex

    if isinstance(index, (TieredHNSWIndex, TieredSVSIndex)):
        raise ValueError(
            "serialize the tiers separately (run GC + drain jobs first); "
            "the reference likewise serializes backend indexes only"
        )
    arrays: dict[str, np.ndarray] = {}
    meta: dict = {"version": FORMAT_VERSION}
    getattr(index, "_ensure_host_links", lambda: None)()
    index.store.pull_host()
    if isinstance(index, HNSWIndex):
        index.upper.pull_host()
        meta["kind"] = "hnsw"
        meta["params"] = _params_to_dict(index.params)
        meta["entry_id"] = index.entry_id
        meta["max_level"] = index.max_level
        meta["lmax"] = index.lmax
        meta["num_marked_deleted"] = index.num_marked_deleted
        meta["count"] = index.store.count
        meta["upper_count"] = index.upper.count
        arrays.update(_store_arrays(index.store, "s_"))
        arrays.update(_store_arrays(index.upper, "u_"))
    elif isinstance(index, SVSIndex):
        meta["kind"] = "svs"
        meta["params"] = _params_to_dict(index.params)
        meta["entry_id"] = index.entry_id
        meta["num_marked_deleted"] = index.num_marked_deleted
        meta["count"] = index.store.count
        arrays.update(_store_arrays(index.store, "s_"))
        if index._P is not None:
            arrays[LEANVEC_KEY] = index._P.cpu().numpy()
    elif isinstance(index, BruteForceIndex):
        meta["kind"] = "bf"
        meta["params"] = _params_to_dict(index.params)
        meta["count"] = index.store.count
        arrays.update(_store_arrays(index.store, "s_"))
    else:
        raise TypeError(f"cannot serialize {type(index)}")

    np.savez_compressed(path, __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
                        **arrays)


def load_index(path: str, *, device=None):
    """The index saved at ``path`` (by either package), on ``device``."""
    from ..indexes.brute_force import BruteForceIndex
    from ..indexes.hnsw import HNSWIndex
    from ..indexes.svs import SVSIndex

    with np.load(path) as z:
        meta = json.loads(bytes(z["__meta__"]).decode())
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
    if meta["version"] != FORMAT_VERSION:
        raise ValueError(f"unsupported format version {meta['version']}")
    kind = meta["kind"]
    pd = dict(meta["params"])
    pd["type"] = VecSimType(pd["type"])
    pd["metric"] = VecSimMetric(pd["metric"])

    if kind == "bf":
        index = BruteForceIndex(BFParams(**pd), device=device)
    elif kind == "hnsw":
        index = HNSWIndex(HNSWParams(**pd), device=device)
        if meta["lmax"] > index.lmax:
            index._grow_lmax(meta["lmax"])
    elif kind == "svs":
        pd["quantBits"] = VecSimSvsQuantBits(pd["quantBits"])
        pd["use_search_history"] = VecSimOptionMode(pd["use_search_history"])
        params = SVSParams(**pd)
        index = SVSIndex(params, device=device)
        if index.is_leanvec:
            if LEANVEC_KEY not in arrays:
                raise ValueError(
                    f"{path}: a {params.quantBits.name} index needs its LeanVec projection "
                    f"_P ('{LEANVEC_KEY}'), which this file lacks"
                )
            index._P = torch.from_numpy(arrays[LEANVEC_KEY]).to(index.device)
    else:
        raise ValueError(f"unknown kind {kind}")

    _restore_store(index.store, arrays, "s_", meta["count"])
    if kind == "hnsw":
        _restore_store(index.upper, arrays, "u_", meta["upper_count"])
        index.max_level = meta["max_level"]
    if kind in ("hnsw", "svs"):
        index.entry_id = meta["entry_id"]
        index.num_marked_deleted = meta["num_marked_deleted"]
    rebuild_labels(index)
    return index


def check_integrity(index) -> bool:
    """Structural invariants (``hnsw_serializer_impl.h:57`` checkIntegrity):
    the label maps agree with the label column and leave out tombstoned
    rows, and every link points below the row count."""
    getattr(index, "_ensure_host_links", lambda: None)()
    index.store.pull_host()
    count = index.store.count
    labels_col = index.store.host["label"][:count]
    flags = index.store.host.get("flags")
    tomb = int((flags[:count] & 1).sum()) if flags is not None else 0
    if index.multi:
        total = sum(len(v) for v in index.labels.label_to_ids.values())
        if total != count - tomb:
            return False
        for lab, ids in index.labels.label_to_ids.items():
            if any(labels_col[i] != lab for i in ids):
                return False
    else:
        if len(index.labels) != count - tomb:
            return False
        for lab, i in index.labels.label_to_id.items():
            if labels_col[i] != lab:
                return False
    for field in ("links0", "links"):
        if field in index.store.fields:
            links = index.store.host[field][:count]
            if links.size and links.max(initial=-1) >= count:
                return False
    if hasattr(index, "upper") and index.upper.count:
        ul = index.upper.host["links"][: index.upper.count]
        if ul.size and ul.max(initial=-1) >= count:
            return False
    return True
