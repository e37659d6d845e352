"""The port's reference-format HNSW files (V3/V4) against the JAX package's,
on the CPU.

The suite's shared JAX build (``torch_port_common.jax_hnsw_index``, 384 x
16 fp32 Cosine, M = 8) is carried across with ``convert.hnsw_from_jax``
(after tombstones and a delete, on a copy): the port's V3 and V4 writers
produce the bytes of the JAX package's ``save_hnsw_file``, each package
loads the other's file into the same graph and answers ``topk_query_batch``
with the same labels (distances within ``TOL``), and the file's incoming
edge lists are the one-way edges of the graph. An int8 Cosine index (the
norm tail of each element) and a multi-value index, built by the port, make
the same bytes after a trip through the JAX package. ``device_data`` is
adopted as a CPU tensor and from a callable. The reference's own V3
fixtures (a checkout of the reference beside this repository) skip where
they are absent, as in ``tests/test_hnsw_file_format.py``.
"""

import os
import struct
from pathlib import Path

import numpy as np
import pytest
import torch

import vectorsimilarity_tpu_torch as tvs
from torch_port_common import (
    HNSW_DIM,
    TOL,
    assert_replies_parity,
    hnsw_params,
    jax_hnsw_index,
    unit_rows,
)
from vectorsimilarity_tpu.utils import hnsw_file_format as jfmt
from vectorsimilarity_tpu.utils import serializer as jser
from vectorsimilarity_tpu_torch.convert import export_hnsw_state, hnsw_from_jax
from vectorsimilarity_tpu_torch.utils import hnsw_file_format as tfmt
from vectorsimilarity_tpu_torch.utils.serializer import check_integrity

K = 10
QUERIES = unit_rows(np.random.default_rng(31), 16, HNSW_DIM)

# The reference's committed fixtures, in a checkout of it beside this repo.
REF_DATA = Path(__file__).resolve().parents[3] / "reference" / "tests" / "unit" / "data"
SINGLE = str(REF_DATA / "1k-d4-L2-M8-ef_c10_FLOAT32_single.v3")
needs_fixtures = pytest.mark.skipif(
    not os.path.exists(SINGLE), reason="reference fixtures not available"
)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """A JAX index with writes behind it, its V3 / V4 files by either
    package, and its replies."""
    tmp = tmp_path_factory.mktemp("hnswfmt")
    shared, _ = jax_hnsw_index()
    jser.save_index(shared, str(tmp / "copy.npz"))  # the shared build stays as it is
    jidx = jser.load_index(str(tmp / "copy.npz"))
    jidx.delete_vector(5)
    for lab in (40, 41, 90):
        jidx.mark_delete(lab)
    tidx = hnsw_from_jax(jidx, device="cpu")
    out = {"jidx": jidx, "tidx": tidx, "ref": jidx.topk_query_batch(QUERIES, K)}
    for v in (3, 4):
        out[("jax", v)] = str(tmp / f"jax.v{v}")
        out[("port", v)] = str(tmp / f"port.v{v}")
        jfmt.save_hnsw_file(jidx, out[("jax", v)], version=v)
        tfmt.save_hnsw_file(tidx, out[("port", v)], version=v)
    out["jax_from_port"] = jfmt.load_hnsw_file(out[("port", 4)]).topk_query_batch(QUERIES, K)
    return out


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("version", [3, 4])
def test_writer_bytes_equal_jax(files, version):
    assert _bytes(files[("port", version)]) == _bytes(files[("jax", version)])


@pytest.mark.parametrize("version", [3, 4])
def test_port_loads_jax_file(files, version):
    idx = tfmt.load_hnsw_file(files[("jax", version)], device="cpu")
    assert idx.store.device.type == "cpu" and check_integrity(idx)
    js, ts = export_hnsw_state(files["jidx"]), export_hnsw_state(idx)
    for name in ("label", "level", "links0", "nlinks0", "flags", "data"):
        assert np.array_equal(ts["arrays"][name], js["arrays"][name]), name
    assert (idx.entry_id, idx.max_level, idx.num_marked_deleted) == (
        files["jidx"].entry_id, files["jidx"].max_level, files["jidx"].num_marked_deleted)
    assert idx.labels.label_to_id == files["jidx"].labels.label_to_id
    assert_replies_parity(idx.topk_query_batch(QUERIES, K), files["ref"], TOL)
    # Written again, it is the same file.
    out = files[("jax", version)] + ".again"
    tfmt.save_hnsw_file(idx, out, version=version)
    assert _bytes(out) == _bytes(files[("jax", version)])


def test_jax_loads_port_file(files):
    assert_replies_parity(files["jax_from_port"], files["ref"], TOL)


def test_incoming_edges_are_the_one_way_edges(files):
    """Parse the port's V4 file and check each incoming list against the
    graph: a on b's list iff b in a's links and a not in b's."""
    idx = files["tidx"]
    buf = _bytes(files[("port", 4)])
    count = idx.store.count
    pos = 4 + 4 + 8 + 4 + 4 + 8 + 1 + 8 + 8 * 4 + 16 + 24 + 4 + 9 * count
    pos += count * idx.dim * 4
    links = {}
    incoming = {}
    node = 0
    while node < count:
        (blen,) = struct.unpack_from("<I", buf, pos)
        pos += 4
        for _ in range(blen):
            (top,) = struct.unpack_from("<Q", buf, pos)
            pos += 8
            for lvl in range(top + 1):
                (nl,) = struct.unpack_from("<H", buf, pos)
                links[(node, lvl)] = set(np.frombuffer(buf, "<u4", nl, pos + 2).tolist())
                pos += 2 + 4 * nl
                (ni,) = struct.unpack_from("<I", buf, pos)
                incoming[(node, lvl)] = np.frombuffer(buf, "<u4", ni, pos + 4).tolist()
                pos += 4 + 4 * ni
            node += 1
    assert pos == len(buf)
    want = {key: [] for key in links}
    for (a, lvl), targets in sorted(links.items()):
        for b in targets:
            if a not in links.get((b, lvl), ()):
                want[(b, lvl)].append(a)
    assert incoming == want
    assert any(incoming.values())


@pytest.mark.parametrize("kind", ["int8_cosine", "multi"])
def test_port_built_files_cross(tmp_path, kind):
    """A port-built index's file loads into the JAX package, and the JAX
    package writes it back byte for byte; the port answers as the JAX
    package does on it."""
    rng = np.random.default_rng(4)
    if kind == "int8_cosine":
        x = rng.integers(-100, 100, size=(160, HNSW_DIM)).astype(np.int8)
        params = tvs.VecSimParams(algo=tvs.VecSimAlgo.HNSWLIB, hnswParams=tvs.HNSWParams(
            type=tvs.VecSimType.INT8, dim=HNSW_DIM, metric=tvs.VecSimMetric.Cosine, M=8,
            efConstruction=32))
        labels = list(range(160))
    else:
        x = unit_rows(rng, 160, HNSW_DIM)
        params = hnsw_params(tvs, multi=True)
        labels = [i // 2 for i in range(160)]
    idx = tvs.create_index(params, device="cpu")
    idx.add_vector_batch(x, labels)
    idx.mark_delete(labels[7])
    p1, p2 = str(tmp_path / "port.v4"), str(tmp_path / "jax.v4")
    tfmt.save_hnsw_file(idx, p1)
    jidx = jfmt.load_hnsw_file(p1)
    jfmt.save_hnsw_file(jidx, p2)
    assert _bytes(p1) == _bytes(p2)
    back = tfmt.load_hnsw_file(p2, device="cpu")
    assert check_integrity(back) and back.num_marked_deleted == idx.num_marked_deleted
    q = x[:4]
    assert_replies_parity(back.topk_query_batch(q, K), idx.topk_query_batch(q, K), 0.0)


@pytest.mark.parametrize("how", ["tensor", "callable"])
def test_device_data_is_adopted(files, how):
    """``device_data``: the store adopts the given rows as its device copy;
    the host mirrors keep the file's contents."""
    path = files[("port", 4)]
    tidx = files["tidx"]
    count = tidx.store.count
    rows = torch.from_numpy(tidx.store.host["data"][:count].copy())
    seen = {}

    def make(cap, n, dim):
        seen["shape"] = (cap, n, dim)
        pad = torch.zeros((cap, dim), dtype=torch.float32)
        pad[:n] = rows
        return pad

    if how == "callable":
        data = make
    else:
        data = make(tidx.store.capacity, count, tidx.dim)
    idx = tfmt.load_hnsw_file(path, data, device="cpu")
    if how == "callable":
        assert seen["shape"] == (idx.store.capacity, count, tidx.dim)
    assert not idx.store._host_stale
    assert np.array_equal(idx.store.host["data"][:count], tidx.store.host["data"][:count])
    if how == "tensor":
        assert idx.store._device["data"].data_ptr() == data.data_ptr()
    assert_replies_parity(idx.topk_query_batch(QUERIES, K), files["ref"], TOL)
    with pytest.raises(ValueError, match="capacity bucket"):
        tfmt.load_hnsw_file(path, rows, device="cpu")


@needs_fixtures
@pytest.mark.parametrize("version", [3, 4])
def test_reference_fixture_round_trip(tmp_path, version):
    idx = tfmt.load_hnsw_file(SINGLE, device="cpu")
    assert idx.index_size == 1001 and check_integrity(idx)
    out = str(tmp_path / f"ref.v{version}")
    tfmt.save_hnsw_file(idx, out, version=version)
    jout = str(tmp_path / f"ref_jax.v{version}")
    jfmt.save_hnsw_file(jfmt.load_hnsw_file(SINGLE), jout, version=version)
    assert _bytes(out) == _bytes(jout)
