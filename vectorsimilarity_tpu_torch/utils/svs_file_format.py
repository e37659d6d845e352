"""Reference-compatible SVS (Vamana) folder serialization.

Counterpart of ``vectorsimilarity_tpu/utils/svs_file_format.py``. The
reference saves an SVS index as a FOLDER (``svs_serializer.cpp:29-38``
``SVSSerializer::saveIndex``): a ``metadata`` file with an encoding-version
header and every field needed to validate reconstruction
(``svs_serializer_impl.h:20-61`` ``saveIndexFields``), beside
``config`` / ``graph`` / ``data`` files written by the Intel SVS library.
Loading needs an index ALREADY CREATED with the same parameters; the
metadata is compared field by field before the graph and data are adopted
(``svs_serializer_impl.h:85-145`` ``loadIndex`` / ``compareMetadataFile``).

- ``metadata`` is byte-compatible with the reference and the JAX package
  (the same POD sequence, widths and order as ``saveIndexFields``).
- ``config`` / ``graph`` / ``data`` are the JAX package's numpy containers
  (the Intel SVS library's formats are not defined in the reference
  snapshot), so a folder written by either package loads into the other.
- ``load_svs_folder(index, path)`` validates the metadata against the live
  index like ``compareMetadataFile`` (field order, one error naming the
  first mismatching field), then restores the store, the labels and the
  medoid entry.

One divergence: the JAX loader adds every row's label, tombstoned rows too,
so a folder saved after ``mark_delete`` reloads with the deleted label
answering and ``check_integrity`` false. Here a row whose ``flags & 1`` is
set gets no label, as ``mark_delete`` left it.
"""

from __future__ import annotations

import json
import struct
from pathlib import Path

import numpy as np
import torch

from ..types import VecSimSvsQuantBits

V0 = 0  # SVSSerializer::EncodingVersion::V0

# Per-row store fields persisted beside the codes (quantization scales,
# two-level residual codes, norms, multi-value slots).
_PER_ROW_FIELDS = (
    "vmin", "delta", "sqnorm", "norm", "slot", "res", "rvmin", "rdelta", "rsq",
)

# VecSimSvsQuantBits -> (QuantBits, ResidualBits, IsLeanVec) template
# parameters, as instantiated by svs_factory.cpp:70-87.
_TEMPLATE_PARAMS = {
    VecSimSvsQuantBits.NONE: (0, 0, False),
    VecSimSvsQuantBits.Scalar: (1, 0, False),
    VecSimSvsQuantBits.Q8: (8, 0, False),
    VecSimSvsQuantBits.Q4: (4, 0, False),
    VecSimSvsQuantBits.Q4x4: (4, 4, False),
    VecSimSvsQuantBits.Q4x8: (4, 8, False),
    VecSimSvsQuantBits.Q4x8_LeanVec: (4, 8, True),
    VecSimSvsQuantBits.Q8x8_LeanVec: (8, 8, True),
}

# (name, struct format) in saveIndexFields order. bool is 1 byte, enums are
# 4-byte ints, size_t is 8 bytes, alpha is float, epsilon is double.
_FIELDS = (
    ("dim", "<Q"),
    ("vecType", "<i"),
    ("storedDataSize", "<Q"),
    ("metric", "<i"),
    ("blockSize", "<Q"),
    ("isMulti", "<B"),
    ("forcePreprocessing", "<B"),
    ("alpha", "<f"),
    ("graph_max_degree", "<Q"),
    ("window_size", "<Q"),
    ("max_candidate_pool_size", "<Q"),
    ("prune_to", "<Q"),
    ("use_full_search_history", "<B"),
    ("search_window_size", "<Q"),
    ("epsilon", "<d"),
    ("compression_mode", "<i"),
    ("QuantBits", "<Q"),
    ("ResidualBits", "<Q"),
    ("IsLeanVec", "<B"),
    ("isMulti (template param)", "<B"),
    ("lastMode", "<i"),
)


def _metadata_values(index) -> dict:
    """The reference's saveIndexFields values for an ``SVSIndex``."""
    quant = VecSimSvsQuantBits(index.requested_quant)
    qb, rb, lean = _TEMPLATE_PARAMS[quant]
    spec = index.store.fields["data"]
    return {
        "dim": index.dim,
        "vecType": int(index.vtype),
        # Bytes per stored element in this layout (primary codes or rows),
        # as the JAX package's host row holds them.
        "storedDataSize": int(np.prod(spec.shape, dtype=np.int64)) * spec.dtype.itemsize,
        "metric": int(index.metric),
        "blockSize": index.block_size,
        "isMulti": int(bool(index.multi)),
        # Redundant preprocessing is never forced (the reference sets this
        # for pre-normalized cosine input paths).
        "forcePreprocessing": 0,
        "alpha": float(index.alpha),
        "graph_max_degree": index.R,
        "window_size": index.L_build,
        # Reference defaults (svs_utils.h:114-115): pool = 3x window,
        # prune_to = degree - 4. This pruner prunes exactly to R.
        "max_candidate_pool_size": 3 * index.L_build,
        "prune_to": index.R,
        "use_full_search_history": 1,
        "search_window_size": index.ws,
        "epsilon": float(index.epsilon),
        "compression_mode": int(quant),
        "QuantBits": qb,
        "ResidualBits": rb,
        "IsLeanVec": int(lean),
        "isMulti (template param)": int(bool(index.multi)),
        "lastMode": int(getattr(index, "last_mode", 0)),
    }


def write_metadata(index, path: Path) -> None:
    out = bytearray(struct.pack("<i", V0))
    vals = _metadata_values(index)
    for name, fmt in _FIELDS:
        out += struct.pack(fmt, vals[name])
    Path(path).write_bytes(bytes(out))


def check_metadata(index, path: Path) -> None:
    """``compareMetadataFile`` (svs_serializer_impl.h:119-159): read the
    version, then compare every field in order; raise naming the FIRST
    mismatching field. ``lastMode`` is written but not compared, as in the
    reference."""
    buf = Path(path).read_bytes()
    (version,) = struct.unpack_from("<i", buf, 0)
    if version >= 1:  # EncodingVersion::INVALID
        raise RuntimeError(f"Cannot load index: bad encoding version: {version}")
    off = 4
    vals = _metadata_values(index)
    for name, fmt in _FIELDS:
        (got,) = struct.unpack_from(fmt, buf, off)
        off += struct.calcsize(fmt)
        if name == "lastMode":
            continue
        want = vals[name]
        if fmt == "<f":
            match = abs(got - want) < 1e-6
        elif fmt == "<d":
            match = abs(got - want) < 1e-12
        else:
            match = int(got) == int(want)
        if not match:
            raise RuntimeError(
                f"Field mismatch in metadata file: {name} (file: {got}, index: {want})")


def save_svs_folder(index, location: str) -> None:
    """``SVSSerializer::saveIndex``: metadata + config + graph + data.
    Device-built links and device-adopted rows are pulled first."""
    loc = Path(location)
    loc.mkdir(parents=True, exist_ok=True)
    index._ensure_host_links()
    index.store.pull_host()
    write_metadata(index, loc / "metadata")

    count = index.store.count
    host = index.store.host
    config = {
        "count": int(count),
        "entry_id": int(index.entry_id),
        "num_marked_deleted": int(index.num_marked_deleted),
        "requested_quant": int(index.requested_quant),
    }
    (loc / "config").write_text(json.dumps(config))

    np.savez(loc / "graph", links=host["links"][:count], nlinks=host["nlinks"][:count])
    data_fields = {
        "data": host["data"][:count],
        "label": host["label"][:count],
        "flags": host["flags"][:count],
    }
    for f in _PER_ROW_FIELDS:
        if f in index.store.fields:
            data_fields[f] = host[f][:count]
    if index._P is not None:
        data_fields["leanvec_P"] = index._P.cpu().numpy()  # [dim, leanvec_dim]
    np.savez(loc / "data", **data_fields)
    # np.savez appends .npz; the reference uses bare names.
    for name in ("graph", "data"):
        (loc / f"{name}.npz").replace(loc / name)


def load_svs_folder(index, location: str) -> None:
    """``loadIndex``: ``index`` must be freshly created with the same
    parameters; the metadata is validated, then the store is adopted. The
    rows keep their saved flags, and tombstoned rows get no label."""
    loc = Path(location)
    check_metadata(index, loc / "metadata")
    config = json.loads((loc / "config").read_text())
    count = int(config["count"])

    with open(loc / "graph", "rb") as f:
        graph = np.load(f)
        links, nlinks = graph["links"], graph["nlinks"]
    with open(loc / "data", "rb") as f:
        data = dict(np.load(f).items())

    if links.shape != (count, index.R):
        raise RuntimeError(f"graph shape mismatch: {links.shape} vs ({count}, {index.R})")

    store = index.store
    rows = {"data": data["data"], "label": data["label"], "flags": data["flags"],
            "links": links, "nlinks": nlinks}
    for f in _PER_ROW_FIELDS:
        if f in store.fields and f in data:
            rows[f] = data[f]
    if "leanvec_P" in data:
        index._P = torch.from_numpy(data["leanvec_P"]).to(index.device)
    store.append(rows)

    live = (data["flags"][:count] & 1) == 0
    for i in np.nonzero(live)[0].tolist():
        lab = int(data["label"][i])
        if index.multi:
            store.host["slot"][i] = index.labels.add(lab, i)
        else:
            index.labels.add(lab, i)
    index.entry_id = int(config["entry_id"])
    index.num_marked_deleted = int(config["num_marked_deleted"])
    index._inserts_since_medoid = 0
