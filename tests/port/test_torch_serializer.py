"""The port's "vstpu-v1" serializer against the JAX package's, on the CPU.

Mirrors ``tests/test_serializer.py`` across the packages. Each case is an
index of one package with deletes behind it (``delete_vector``, and
``mark_delete`` tombstones where the index keeps them):

- flat, single- and multi-value (built by the JAX package);
- HNSW: a copy of the suite's shared JAX build
  (``torch_port_common.jax_hnsw_index``), and a multi-value index built by
  the port;
- SVS in NONE, Scalar and Q4x8 (``torch_port_common.jax_svs_index``), and a
  multi-value NONE index built by the port.

The JAX package saves it and the port loads it, and the port saves that and
the JAX package loads it back: every saved array is equal, and both reloaded
indexes answer ``topk_query_batch`` with the first index's labels (distances
within ``TOL``). The JAX answers are computed once per module.

Also: the tiered classes are refused; ``check_integrity`` is true on a
sound index and false on a corrupted one. And the LeanVec fault of the JAX
package (it never saves ``_P``, so its reloaded index fails at its first
query) is not copied: the port's reload keeps the projection and answers as
the saved index and as the JAX package with ``_P`` set by hand, and a
JAX-written LeanVec file is refused with ``ValueError``.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorsimilarity_tpu as jvs
import vectorsimilarity_tpu_torch as tvs
from torch_port_common import (
    SVS_DIM,
    TOL,
    assert_replies_parity,
    embedding_rows,
    hnsw_params,
    jax_hnsw_index,
    jax_svs_index,
    svs_params,
    unit_rows,
)
from vectorsimilarity_tpu.utils import serializer as jser
from vectorsimilarity_tpu_torch.utils import serializer as tser

K = 10
DIM = 16


def _bf_params(pkg, multi):
    return pkg.VecSimParams(algo=pkg.VecSimAlgo.BF, bfParams=pkg.BFParams(
        type=pkg.VecSimType.FLOAT32, dim=DIM, metric=pkg.VecSimMetric.L2, multi=multi))


def _jax_bf(multi):
    x = np.random.default_rng(3).standard_normal((200, DIM)).astype(np.float32)
    idx = jvs.create_index(_bf_params(jvs, multi))
    idx.add_vector_batch(x, [i // 2 if multi else i for i in range(200)])
    idx.delete_vector(13)
    idx.delete_vector(57)
    return idx, x[:16]


def _jax_hnsw(tmp):
    shared, x = jax_hnsw_index()
    jser.save_index(shared, str(tmp / "shared.npz"))  # a copy: the shared build stays as it is
    idx = jser.load_index(str(tmp / "shared.npz"))
    idx.delete_vector(5)
    idx.delete_vector(int(idx.store.host["label"][idx.entry_id]))
    for lab in (40, 41, 90):
        idx.mark_delete(lab)
    return idx, x[:16]


def _jax_svs(mode):
    idx, x = jax_svs_index(mode)
    idx.delete_vector(7)
    for lab in (30, 31, 200):
        idx.mark_delete(lab)
    return idx, x[:16]


def _port_multi(kind):
    """A multi-value index built by the port (two rows per label), with a
    label deleted and one tombstoned."""
    if kind == "hnsw":
        x = unit_rows(np.random.default_rng(5), 192, DIM)
        idx = tvs.create_index(hnsw_params(tvs, multi=True), device="cpu")
    else:
        x = embedding_rows(np.random.default_rng(5), 192, SVS_DIM)
        idx = tvs.create_index(svs_params(tvs, "NONE", multi=True), device="cpu")
    idx.add_vector_batch(x, [i // 2 for i in range(192)])
    idx.delete_vector(4)
    idx.mark_delete(9)
    return idx, x[:16]


CASES = ["bf", "bf_multi", "hnsw", "hnsw_multi", "svs_NONE", "svs_Scalar", "svs_Q4x8",
         "svs_multi"]


def _arrays(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files if k != "__meta__"}, json.loads(bytes(z["__meta__"]))


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """Per case: the first index's file, its replies, and the files of the
    round trip (JAX -> port -> JAX, or port -> JAX -> port)."""
    tmp = tmp_path_factory.mktemp("ser")
    out = {}
    for case in CASES:
        if case.startswith("bf"):
            idx, q = _jax_bf(case == "bf_multi")
        elif case == "hnsw":
            idx, q = _jax_hnsw(tmp)
        elif case.endswith("multi"):
            idx, q = _port_multi(case.split("_")[0])
        else:
            idx, q = _jax_svs(case.split("_")[1])
        port_first = case in ("hnsw_multi", "svs_multi")
        first, second = (tser, jser) if port_first else (jser, tser)
        p1, p2 = str(tmp / f"{case}_1.npz"), str(tmp / f"{case}_2.npz")
        first.save_index(idx, p1)
        ref = idx.topk_query_batch(q, K)
        other = tser.load_index(p1, device="cpu") if second is tser else jser.load_index(p1)
        second.save_index(other, p2)
        back = tser.load_index(p2, device="cpu") if first is tser else jser.load_index(p2)
        out[case] = {"p1": p1, "p2": p2, "q": q, "ref": ref, "first": first,
                     "other": other.topk_query_batch(q, K), "back": back.topk_query_batch(q, K),
                     "integrity": (jser if first is jser else tser).check_integrity(back)
                     and (jser if second is jser else tser).check_integrity(other)}
    return out


@pytest.mark.parametrize("case", CASES)
def test_files_cross_both_ways(saved, case):
    s = saved[case]
    a1, m1 = _arrays(s["p1"])
    a2, m2 = _arrays(s["p2"])
    assert m1 == m2
    assert set(a1) == set(a2)
    for name in a1:
        assert a1[name].dtype == a2[name].dtype and np.array_equal(a1[name], a2[name]), name
    assert s["integrity"]


@pytest.mark.parametrize("case", CASES)
def test_reloaded_indexes_answer_the_same(saved, case):
    s = saved[case]
    assert_replies_parity(s["other"], s["ref"], TOL)
    assert_replies_parity(s["back"], s["ref"], TOL)
    if "multi" in case:
        for r in s["ref"]:
            assert len(set(r.ids.tolist())) == len(r.ids)


@pytest.mark.parametrize("case", ["bf", "hnsw_multi", "svs_multi"])
def test_port_load_is_exact_and_on_the_asked_device(saved, case):
    """The port's reload holds the saved rows exactly (the label map, the
    tombstones), and with no CUDA a load without ``device`` raises."""
    idx = tser.load_index(saved[case]["p1"], device="cpu")
    assert idx.store.device.type == "cpu"
    assert tser.check_integrity(idx)
    if case.endswith("multi"):
        assert 4 not in idx.labels and 9 not in idx.labels
        assert idx.num_marked_deleted == 2  # both rows of label 9
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tser.load_index(saved[case]["p1"])


def test_tiered_classes_are_refused(tmp_path):
    for algo, inner in ((tvs.VecSimAlgo.HNSWLIB, "hnswParams"), (tvs.VecSimAlgo.SVS, "svsParams")):
        sub = (tvs.HNSWParams(dim=8, M=4, efConstruction=16) if inner == "hnswParams"
               else tvs.SVSParams(dim=8))
        params = tvs.VecSimParams(algo=tvs.VecSimAlgo.TIERED, tieredParams=tvs.TieredIndexParams(
            primaryIndexParams=tvs.VecSimParams(algo=algo, **{inner: sub})))
        idx = tvs.create_index(params, device="cpu")
        with pytest.raises(ValueError, match="serialize the tiers separately"):
            tser.save_index(idx, str(tmp_path / "t.npz"))


@pytest.mark.parametrize("fault", ["sound", "link_past_count", "upper_link_past_count",
                                   "label_off_its_column", "tombstone_with_label"])
def test_check_integrity(fault):
    x = unit_rows(np.random.default_rng(9), 96, DIM)
    idx = tvs.create_index(hnsw_params(tvs), device="cpu")
    idx.add_vector_batch(x, list(range(96)))
    idx.mark_delete(3)
    idx._ensure_host_links()
    count = idx.store.count
    if fault == "link_past_count":
        idx.store.host["links0"][11, 0] = count
    elif fault == "upper_link_past_count":
        idx.upper.host["links"][0, 0, 0] = count
    elif fault == "label_off_its_column":
        idx.labels.label_to_id[20] = 21
    elif fault == "tombstone_with_label":
        idx.labels.label_to_id[3] = int(np.nonzero(idx.store.host["label"][:count] == 3)[0][0])
    assert tser.check_integrity(idx) == (fault == "sound")
    assert jser.check_integrity(idx) == (fault == "sound")


def test_leanvec_projection_is_kept(tmp_path):
    """The port saves and restores ``_P``; its reload answers its first
    query as the saved index does, and as the JAX package's reload of the
    same file with ``_P`` set by hand. The JAX package's own reload fails
    at that query, and its file (without ``_P``) is refused by the port."""
    x = embedding_rows(np.random.default_rng(2), 256, SVS_DIM)
    q = embedding_rows(np.random.default_rng(12), 8, SVS_DIM)
    idx = tvs.create_index(svs_params(tvs, "Q8x8_LeanVec"), device="cpu")
    idx.add_vector_batch(x, list(range(256)))
    ref = idx.topk_query_batch(q, K)
    path = str(tmp_path / "lean.npz")
    tser.save_index(idx, path)

    back = tser.load_index(path, device="cpu")
    assert torch.equal(back._P, idx._P)
    assert_replies_parity(back.topk_query_batch(q, K), ref, 0.0)

    jidx = jser.load_index(path)
    assert jidx._P is None  # the JAX loader drops the projection ...
    with pytest.raises(Exception):
        jidx.topk_query_batch(q, K)  # ... and its first query fails
    P = idx._P.numpy()
    jidx._P_host, jidx._P = P, jnp.asarray(P)
    assert_replies_parity(back.topk_query_batch(q, K), jidx.topk_query_batch(q, K), TOL)

    jpath = str(tmp_path / "lean_jax.npz")
    jser.save_index(jidx, jpath)
    assert "leanvec_P" not in np.load(jpath).files
    with pytest.raises(ValueError, match="_P"):
        tser.load_index(jpath, device="cpu")
