"""The port's SVS folders against the JAX package's, on the CPU.

Mirrors ``tests/test_svs_file_format.py`` across the packages:

- the ``metadata`` bytes of every ``quantBits`` mode equal the JAX
  package's for the same params (and the reference's POD layout);
- a folder saved by the port loads into a fresh JAX index, which saves it
  again into a folder the port loads: every file's arrays are equal, and
  all three indexes answer ``topk_query_batch`` with the same labels
  (distances within ``TOL``), single- and multi-value;
- mismatched params and a bad version are refused;
- ``test_bindings_surface`` runs against the port's ``bindings``.

One divergence from the JAX package (its loader gives a tombstoned row its
label back, ``vectorsimilarity_tpu/utils/svs_file_format.py:224-230``): a
folder saved after ``mark_delete`` reloads here with the label gone and
``check_integrity`` true, where the JAX reload holds one label more and
fails it.
"""

import struct

import numpy as np
import pytest

import vectorsimilarity_tpu as jvs
import vectorsimilarity_tpu_torch as tvs
from torch_port_common import TOL, assert_replies_parity, unit_rows
from vectorsimilarity_tpu.utils import serializer as jser
from vectorsimilarity_tpu.utils import svs_file_format as jfmt
from vectorsimilarity_tpu_torch.bindings import SVSIndex as PySVSIndex
from vectorsimilarity_tpu_torch.utils import svs_file_format as tfmt
from vectorsimilarity_tpu_torch.utils.serializer import check_integrity

K = 5
MODES = ["NONE", "Scalar", "Q8", "Q4", "Q4x4", "Q4x8", "Q4x8_LeanVec", "Q8x8_LeanVec"]


def _params(pkg, dim=24, metric="L2", quant="NONE", multi=False, R=16):
    return pkg.VecSimParams(algo=pkg.VecSimAlgo.SVS, svsParams=pkg.SVSParams(
        type=pkg.VecSimType.FLOAT32, dim=dim, metric=pkg.VecSimMetric[metric], multi=multi,
        quantBits=pkg.VecSimSvsQuantBits[quant], graph_max_degree=R,
        construction_window_size=60, search_window_size=24))


def _port(**kw):
    return tvs.create_index(_params(tvs, **kw), device="cpu")


def _jax(**kw):
    return jvs.create_index(_params(jvs, **kw))


def _fill(idx, n=300, dim=24, seed=0, multi=False):
    data = unit_rows(np.random.default_rng(seed), n, dim)
    idx.add_vector_batch(data, [i % (n // 3) if multi else i for i in range(n)])
    return data


@pytest.mark.parametrize("quant", MODES)
def test_metadata_bytes_equal_jax(tmp_path, quant):
    tfmt.write_metadata(_port(quant=quant), tmp_path / "port")
    jfmt.write_metadata(_jax(quant=quant), tmp_path / "jax")
    buf = (tmp_path / "port").read_bytes()
    assert buf == (tmp_path / "jax").read_bytes()
    assert len(buf) == 4 + sum(struct.calcsize(f) for _, f in tfmt._FIELDS)
    assert struct.unpack_from("<iQ", buf, 0) == (tfmt.V0, 24)


def _npz(path):
    with open(path, "rb") as f:
        z = np.load(f)
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("quant, multi", [("NONE", False), ("Scalar", False), ("NONE", True)])
def test_folder_crosses_both_ways(tmp_path, quant, multi):
    idx = _port(quant=quant, multi=multi)
    data = _fill(idx, multi=multi)
    idx.delete_vector(11)
    q = data[:8]
    ref = idx.topk_query_batch(q, K)
    tfmt.save_svs_folder(idx, tmp_path / "port")
    assert {p.name for p in (tmp_path / "port").iterdir()} == {"metadata", "config", "graph",
                                                               "data"}
    jidx = _jax(quant=quant, multi=multi)
    jfmt.load_svs_folder(jidx, tmp_path / "port")
    assert jidx.index_size == idx.index_size and jidx.entry_id == idx.entry_id
    assert_replies_parity(jidx.topk_query_batch(q, K), ref, TOL)
    jfmt.save_svs_folder(jidx, tmp_path / "jax")
    for name in ("metadata", "config"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
    for name in ("graph", "data"):
        a, b = _npz(tmp_path / "port" / name), _npz(tmp_path / "jax" / name)
        assert set(a) == set(b)
        for key in a:
            if key == "slot":  # each loader hands out slots anew, in row order
                continue
            assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key]), key
    back = _port(quant=quant, multi=multi)
    tfmt.load_svs_folder(back, tmp_path / "jax")
    assert back.index_size == idx.index_size and back.entry_id == idx.entry_id
    assert back.index_label_count == idx.index_label_count and check_integrity(back)
    assert_replies_parity(back.topk_query_batch(q, K), ref, TOL)
    if multi:
        for r in ref:
            assert len(set(r.ids.tolist())) == len(r.ids)


def test_load_rejects_mismatched_params(tmp_path):
    idx = _port()
    _fill(idx)
    tfmt.save_svs_folder(idx, tmp_path / "svs")
    with pytest.raises(RuntimeError, match="dim"):
        tfmt.load_svs_folder(_port(dim=32), tmp_path / "svs")
    with pytest.raises(RuntimeError, match="graph_max_degree"):
        tfmt.load_svs_folder(_port(R=32), tmp_path / "svs")
    with pytest.raises(RuntimeError, match="storedDataSize"):
        tfmt.load_svs_folder(_port(quant="Scalar"), tmp_path / "svs")


def test_load_rejects_bad_version(tmp_path):
    idx = _port()
    _fill(idx, n=20)
    tfmt.save_svs_folder(idx, tmp_path / "svs")
    meta = tmp_path / "svs" / "metadata"
    buf = bytearray(meta.read_bytes())
    buf[0:4] = struct.pack("<i", 9)
    meta.write_bytes(bytes(buf))
    with pytest.raises(RuntimeError, match="bad encoding version"):
        tfmt.load_svs_folder(_port(), tmp_path / "svs")


def test_bindings_surface(tmp_path):
    p = tvs.SVSParams(type=tvs.VecSimType.FLOAT32, dim=16, metric=tvs.VecSimMetric.L2,
                      graph_max_degree=16, construction_window_size=40, search_window_size=16)
    py = PySVSIndex(p, device="cpu")
    data = np.random.default_rng(2).standard_normal((50, 16)).astype(np.float32)
    for i, v in enumerate(data):
        py.add_vector(v, i)
    py.save_index(str(tmp_path / "svs"))
    py2 = PySVSIndex(p, location=str(tmp_path / "svs"), device="cpu")
    assert py2.index_size() == 50
    got = py2.knn_query(data[9], 3)
    assert 9 in [int(x) for x in np.asarray(got[0]).ravel()]
    labels, dists = py2.knn_parallel(data[:4], 3)
    assert labels.shape == dists.shape == (4, 3) and labels[:, 0].tolist() == [0, 1, 2, 3]


def test_tombstoned_row_gets_no_label(tmp_path):
    """128 x 16 L2 in mode NONE, ``mark_delete(5)``, saved and reloaded: the
    port's reload keeps 127 labels and passes ``check_integrity``; the JAX
    package's reload of the same folder maps label 5 to the tombstoned row."""
    idx = _port(dim=16)
    data = _fill(idx, n=128, dim=16)
    assert idx.mark_delete(5)
    assert len(idx.labels) == 127 and check_integrity(idx)
    tfmt.save_svs_folder(idx, tmp_path / "svs")
    back = _port(dim=16)
    tfmt.load_svs_folder(back, tmp_path / "svs")
    assert len(back.labels) == 127 and 5 not in back.labels
    assert back.num_marked_deleted == 1 and check_integrity(back)
    assert 5 not in back.topk_query(data[5], K).ids.tolist()
    jidx = _jax(dim=16)
    jfmt.load_svs_folder(jidx, tmp_path / "svs")
    assert len(jidx.labels) == 128 and not jser.check_integrity(jidx)
