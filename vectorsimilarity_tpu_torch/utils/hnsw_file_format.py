"""Reference-compatible HNSW file format (V3/V4) — import and export.

Counterpart of ``vectorsimilarity_tpu/utils/hnsw_file_format.py``: the
binary layout of the reference serializer, so an index moves between the
reference, the JAX package and this one in any direction (the writer's bytes
equal the JAX package's for the same index):

  [version i32][algo i32][dim u64][type i32][metric i32][blockSize u64]
  [multi u8][initialCapacity u64]                    (hnsw_factory.cpp:173-180)
  [M u64][M0 u64][efConstruction u64][ef u64][epsilon f64][mult f64]
  [curElementCount u64][numMarkedDeleted u64][maxLevel u64][entrypoint u32]
                                         (hnsw_serializer_impl.h restore/saveIndexFields)
  per id: [label u64][flags u8]
  vectors: V3: [numBlocks u32] then per block [len u32][len * elementBytes];
           V4: raw elements, block sizes derived     (data_blocks_container.cpp)
  graph: per block [len u32]; per element [toplevel u64];
         per level [numLinks u16][links u32 x n][incomingSize u32][ids u32 x s]
                                         (graph_data.h:15-20, saveLevel/restoreLevel)

An element is ``dim`` values of the index's type, followed by the fp32 norm
for int8 / uint8 Cosine (kept as the ``norm`` column here). The reference
keeps incoming-unidirectional-edge lists to make deletes O(degree); this
package finds referrers by scans, so the loader skips them and the writer
rebuilds them (an edge a -> b with no b -> a puts a on b's list, in
ascending order), so the reference's ``checkIntegrity`` holds on written
files. numpy and ``struct`` only.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from ..types import HNSWParams, VecSimMetric, VecSimType, numpy_dtype

V3 = 3
V4 = 4

_MAXLEVEL_NONE = 2**64 - 1  # HNSW_INVALID_LEVEL (SIZE_MAX) when the index is empty
_NO_ENTRY = 2**32 - 1
_LABEL_FLAGS = np.dtype([("label", "<u8"), ("flags", "u1")])  # packed, 9 bytes


def _element_bytes(data: np.ndarray, vtype: VecSimType) -> np.ndarray:
    """Rows [count, dim] as the reference's element bytes [count, dim *
    sizeof(type)]. bfloat16 rows held as fp32 (where numpy lacks the type)
    are rounded to their bfloat16 bits."""
    if vtype == VecSimType.BFLOAT16 and data.dtype.itemsize != 2:
        data = torch.from_numpy(np.ascontiguousarray(data, np.float32)).to(
            torch.bfloat16).view(torch.int16).numpy()
    return np.ascontiguousarray(data).view(np.uint8).reshape(len(data), -1)


def _rows_of_bytes(raw: np.ndarray, vtype: VecSimType, dim: int) -> np.ndarray:
    """``_element_bytes`` inverted: the host column of the index's type."""
    np_dt = numpy_dtype(vtype)
    if vtype == VecSimType.BFLOAT16 and np_dt.itemsize != 2:
        bits = raw.copy().view("<u2").reshape(len(raw), dim).astype(np.uint32) << 16
        return bits.view(np.float32)
    return raw.copy().view(np_dt).reshape(len(raw), dim)


def load_hnsw_file(path: str, device_data=None, *, device=None):
    """Load a reference-serialized HNSW index (V3/V4) into an ``HNSWIndex``
    on ``device`` (the current CUDA device by default, the CPU only on
    request).

    ``device_data``: the vectors already on the index's device, a tensor of
    shape [store capacity bucket, dim] in the STORED representation
    (normalized for Cosine), or a callable ``(capacity, count, dim) ->
    tensor`` making one. The store adopts it as its device copy
    (``BlockStore.adopt_device``), and only the graph and metadata columns
    are uploaded. The host mirrors hold the file's contents either way."""
    from ..indexes.hnsw import HNSWIndex

    with open(path, "rb") as f:
        buf = f.read()
    pos = 0

    def read(fmt: str):
        nonlocal pos
        vals = struct.unpack_from("<" + fmt, buf, pos)
        pos += struct.calcsize("<" + fmt)
        return vals if len(vals) > 1 else vals[0]

    def read_array(dtype, n: int) -> np.ndarray:
        nonlocal pos
        out = np.frombuffer(buf, dtype=dtype, count=n, offset=pos)
        pos += out.nbytes
        return out

    version = read("i")
    if version not in (V3, V4):
        raise ValueError(f"unsupported HNSW encoding version {version}")
    algo = read("i")
    if algo != 1:  # VecSimAlgo_HNSWLIB
        raise ValueError(f"not an HNSW index file (algo={algo})")
    dim = read("Q")
    vtype = VecSimType(read("i"))
    metric = VecSimMetric(read("i"))
    block_size = read("Q")
    multi = bool(read("B"))
    read("Q")  # initialCapacity
    M, M0, ef_construction, ef = read("QQQQ")
    epsilon = read("d")
    read("d")  # mult: recomputed from M
    count, num_marked_deleted, max_level = read("QQQ")
    entrypoint = read("I")

    params = HNSWParams(
        type=vtype, dim=dim, metric=metric, multi=multi,
        blockSize=block_size or 1024, M=M, efConstruction=ef_construction,
        efRuntime=ef, epsilon=epsilon,
    )
    index = HNSWIndex(params, device=device)
    if index.M0 != M0:
        raise ValueError(f"M0 mismatch: file {M0} vs 2*M {index.M0}")

    lf = read_array(_LABEL_FLAGS, count)
    labels = lf["label"].astype(np.int64)
    flags = lf["flags"].copy()

    # Vectors (+ the fp32 norm tail of int8 / uint8 Cosine).
    row_bytes = dim * (2 if vtype == VecSimType.BFLOAT16 else numpy_dtype(vtype).itemsize)
    has_norm_tail = metric == VecSimMetric.Cosine and vtype in (VecSimType.INT8,
                                                                VecSimType.UINT8)
    elem_bytes = row_bytes + (4 if has_norm_tail else 0)
    if version == V3:
        parts = []
        for _ in range(read("I")):
            block_len = read("I")
            parts.append(read_array(np.uint8, block_len * elem_bytes))
        flat = np.concatenate(parts) if parts else np.empty(0, np.uint8)
    else:
        flat = read_array(np.uint8, count * elem_bytes)
    raw = flat.reshape(count, elem_bytes)
    data = _rows_of_bytes(raw[:, :row_bytes], vtype, dim)
    norms = raw[:, row_bytes:].copy().view(np.float32).reshape(count) if has_norm_tail else None

    # Graph: block-structured, levels inline; incoming-edge lists skipped.
    levels = np.zeros(count, dtype=np.int32)
    links0 = np.full((count, M0), -1, dtype=np.int32)
    nlinks0 = np.zeros(count, dtype=np.int32)
    upper: list[tuple[int, list[np.ndarray]]] = []  # (node, [links per level >= 1])
    bs = block_size or 1024
    node = 0
    for _ in range(-(-count // bs) if count else 0):
        for _ in range(read("I")):
            toplevel = read("Q")
            levels[node] = toplevel
            per_level = []
            for lvl in range(toplevel + 1):
                nl = read("H")
                ids = read_array("<u4", nl)
                n_in = read("I")
                pos += 4 * n_in  # incoming edges: recomputed on demand
                if lvl == 0:
                    nlinks0[node] = nl
                    links0[node, :nl] = ids
                else:
                    per_level.append(ids.astype(np.int32))
            if toplevel >= 1:
                upper.append((node, per_level))
            node += 1
    if node != count:
        raise ValueError(f"graph truncated: {node}/{count}")

    rows = {
        "data": data, "label": labels, "level": levels,
        "links0": links0, "nlinks0": nlinks0, "flags": flags,
        "upper_row": np.full(count, -1, dtype=np.int32),
    }
    if "sqnorm" in index.store.fields:
        if vtype in (VecSimType.INT8, VecSimType.UINT8):
            v64 = data.astype(np.int64)
            rows["sqnorm"] = np.sum(v64 * v64, axis=-1).astype(np.float32)
        else:
            v = data.astype(np.float64 if data.dtype == np.float64 else np.float32)
            rows["sqnorm"] = np.sum(v * v, axis=-1).astype(np.float32)
    if "norm" in index.store.fields:
        rows["norm"] = norms if norms is not None else np.zeros(count, np.float32)
    if multi:
        rows["slot"] = np.full(count, -1, dtype=np.int32)
    index.store.append(rows)

    if int(levels.max(initial=0)) + 1 > index.lmax:
        index._grow_lmax(int(levels.max()) + 1)
    for node_id, per_level in upper:
        urow = index._alloc_upper_row(node_id)
        for lvl_i, ids in enumerate(per_level):
            index.upper.host["links"][urow, lvl_i, : len(ids)] = ids
            index.upper.host["nlinks"][urow, lvl_i] = len(ids)
        index.upper.mark_dirty(urow, "links", "nlinks")

    # Label maps (tombstoned rows excluded, as mark_delete leaves them).
    for i in np.nonzero((flags & 1) == 0)[0].tolist():
        if multi:
            index.store.host["slot"][i] = index.labels.add(int(labels[i]), i)
        else:
            index.labels.add(int(labels[i]), i)
    index.num_marked_deleted = int(num_marked_deleted)
    index.entry_id = int(entrypoint) if entrypoint != _NO_ENTRY else -1
    index.max_level = -1 if max_level == _MAXLEVEL_NONE else int(max_level)

    if device_data is not None:
        st = index.store
        arr = device_data(st.capacity, count, dim) if callable(device_data) else device_data
        if arr.shape[0] != st.capacity:
            raise ValueError(f"device_data must be padded to the capacity bucket "
                             f"{st.capacity}, got {arr.shape[0]} rows")
        adopt = {"data": arr.to(st.fields["data"].torch_dtype)}
        for name, spec in st.fields.items():
            if name != "data":
                adopt[name] = torch.from_numpy(st.host[name]).to(index.device, spec.torch_dtype)
        host = dict(st.host)
        st.adopt_device(adopt, count=count)
        # adopt_device starts fresh host mirrors and flags them stale; the
        # file's columns are exact, so they stay the mirrors.
        st.host = host
        st._host_stale.clear()
    return index


def _incoming(links: np.ndarray, nlinks: np.ndarray, node_of: np.ndarray) -> dict:
    """Incoming-unidirectional edges of one level: {node b: the ascending
    nodes a with b in a's links and a not in b's links}. ``links`` [rows,
    m] and ``nlinks`` [rows] hold the level's rows, ``node_of`` [rows] the
    node of each row. A link to a node without a row on this level counts
    as one-way, and a row holding a target twice adds one entry."""
    m = links.shape[1]
    rows, cols = np.nonzero(np.arange(m)[None, :] < nlinks[:, None])
    key = np.unique(rows.astype(np.int64) << 32 | links[rows, cols].astype(np.int64))
    src_row, dst = key >> 32, key & 0xFFFFFFFF
    if not len(dst):
        return {}
    row_of = np.full(max(int(node_of.max()), int(dst.max())) + 1, -1, np.int64)
    row_of[node_of] = np.arange(len(node_of))
    dst_row = row_of[dst]
    src = node_of[src_row]
    back = np.zeros(len(dst), dtype=bool)
    has = dst_row >= 0
    r = dst_row[has]
    back[has] = ((links[r] == src[has][:, None])
                 & (np.arange(m)[None, :] < nlinks[r][:, None])).any(axis=1)
    dst, src = dst[~back], src[~back]
    order = np.lexsort((src, dst))
    dst, src = dst[order], src[order]
    starts = np.flatnonzero(np.r_[True, dst[1:] != dst[:-1]]) if len(dst) else []
    ends = np.r_[starts[1:], len(dst)] if len(dst) else []
    return {int(dst[s]): src[s:e] for s, e in zip(starts, ends)}


def save_hnsw_file(index, path: str, version: int = V4, vectors_from=None) -> None:
    """Export an ``HNSWIndex`` to the reference binary format.

    ``vectors_from`` (numpy [count, dim], the STORED representation: the
    normalized rows for Cosine) replaces the store's vector column, so an
    index built from device rows is written without pulling them back (the
    caller often holds the exact rows it built from)."""
    if version not in (V3, V4):
        raise ValueError(f"unsupported version {version}")
    index._ensure_host_links()
    if vectors_from is not None:
        index.store.pull_host(*[f for f in tuple(index.store._host_stale) if f != "data"])
    else:
        index.store.pull_host()
    index.upper.pull_host()
    count = index.store.count
    pk = struct.pack
    out = [
        pk("<ii", version, 1),  # VecSimAlgo_HNSWLIB
        pk("<Q", index.dim),
        pk("<ii", int(index.vtype), int(index.metric)),
        pk("<Q", index.block_size),
        pk("<B", int(index.multi)),
        pk("<Q", count),  # maxElements / initial capacity hint
        pk("<QQQQ", index.M, index.M0, index.ef_construction, index.ef_runtime),
        pk("<dd", index.epsilon, index.mult),
        pk("<QQQ", count, index.num_marked_deleted,
           index.max_level if index.max_level >= 0 else _MAXLEVEL_NONE),
        pk("<I", index.entry_id if index.entry_id >= 0 else _NO_ENTRY),
    ]
    host = index.store.host
    lf = np.empty(count, dtype=_LABEL_FLAGS)
    lf["label"] = host["label"][:count]
    lf["flags"] = host["flags"][:count]
    out.append(lf.tobytes())

    if vectors_from is not None:
        data = np.asarray(vectors_from)[:count].astype(index.store.fields["data"].dtype,
                                                       copy=False)
    else:
        data = host["data"][:count]
    elems = _element_bytes(data, index.vtype)
    if "norm" in index.store.fields:
        norm = np.ascontiguousarray(host["norm"][:count], dtype=np.float32)
        elems = np.concatenate([elems, norm.view(np.uint8).reshape(count, 4)], axis=1)
    bs = index.block_size
    if version == V3:
        out.append(pk("<I", -(-count // bs) if count else 0))
    for start in range(0, count, bs):
        blen = min(bs, count - start)
        if version == V3:
            out.append(pk("<I", blen))
        out.append(elems[start:start + blen].tobytes())

    # The graph, with the incoming-edge lists rebuilt per level.
    level = host["level"][:count]
    links0, nlinks0 = host["links0"][:count], host["nlinks0"][:count]
    upper_row = host["upper_row"][:count]
    ulinks, unlinks = index.upper.host["links"], index.upper.host["nlinks"]
    incoming = [_incoming(links0, nlinks0, np.arange(count))]
    for lvl in range(1, int(level.max(initial=0)) + 1):
        nodes = np.nonzero(level >= lvl)[0]
        ur = upper_row[nodes]
        incoming.append(_incoming(ulinks[ur, lvl - 1], unlinks[ur, lvl - 1], nodes))
    empty = np.empty(0, dtype=np.int64)

    def level_bytes(links: np.ndarray, inc: np.ndarray) -> None:
        out.append(pk("<H", len(links)))
        out.append(links.astype("<u4").tobytes())
        out.append(pk("<I", len(inc)))
        out.append(inc.astype("<u4").tobytes())

    for start in range(0, count, bs):
        blen = min(bs, count - start)
        out.append(pk("<I", blen))
        for i in range(start, start + blen):
            toplevel = int(level[i])
            out.append(pk("<Q", toplevel))
            level_bytes(links0[i, : nlinks0[i]], incoming[0].get(i, empty))
            r = int(upper_row[i])
            for lvl in range(1, toplevel + 1):
                level_bytes(ulinks[r, lvl - 1, : unlinks[r, lvl - 1]],
                            incoming[lvl].get(i, empty))

    with open(path, "wb") as f:
        f.write(b"".join(out))
