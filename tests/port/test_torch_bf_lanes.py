"""The bf16/fp16/int8/uint8 scoring lanes, the engine gates and the slice as
a whole: the port's flat index against the JAX package's for each new store
type and k band.

The group-min engine's lanes are held against the JAX ``pallas_topk_gm`` in
interpret mode (the fused and big-k engines' lanes are in
``test_torch_bf_fused.py`` and ``test_torch_bf_bigk.py``). For the slice, a
JAX flat index is filled, carried over with ``convert.py`` and queried with k
in each band; the JAX side of each band is the matching ``pallas_*`` function
in interpret mode on the JAX index's own store (its gates need a TPU), and
its streaming scan. Float lanes within 1e-5 with ids equal except at
near-ties; integer lanes equal (Cosine: 1e-6).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vectorsimilarity_tpu.types as jt
import vectorsimilarity_tpu_torch.types as tt
from torch_port_common import TOL, assert_replies_parity, assert_topk_parity, np_of, unit_rows
from vectorsimilarity_tpu import config as jconfig
from vectorsimilarity_tpu.indexes.factory import create_index as jcreate
from vectorsimilarity_tpu.ops.pallas import bf_topk as jbf
from vectorsimilarity_tpu_torch import config as tconfig
from vectorsimilarity_tpu_torch.convert import bruteforce_from_state, export_state
from vectorsimilarity_tpu_torch.core.results import make_reply
from vectorsimilarity_tpu_torch.indexes.brute_force import BruteForceIndex
from vectorsimilarity_tpu_torch.indexes.factory import create_index as tcreate
from vectorsimilarity_tpu_torch.ops.kernels import bf_topk as bfk

T = torch.from_numpy
DIM = 24
_TORCH = {"BFLOAT16": torch.bfloat16, "FLOAT16": torch.float16, "INT8": torch.int8,
          "UINT8": torch.uint8, "FLOAT32": torch.float32, "FLOAT64": torch.float64}


def _rows(rng, n, d, vtype):
    if vtype == "INT8":
        return rng.integers(-127, 128, size=(n, d)).astype(np.int8)
    if vtype == "UINT8":
        return rng.integers(0, 256, size=(n, d)).astype(np.uint8)
    return unit_rows(rng, n, d)


def _norms(a):
    return np.sqrt((a.astype(np.int64) ** 2).sum(1).astype(np.float32))


@pytest.mark.parametrize("vtype,metric", [
    ("BFLOAT16", "Cosine"), ("FLOAT16", "L2"), ("INT8", "L2"), ("INT8", "IP"),
    ("INT8", "Cosine"), ("UINT8", "L2"), ("UINT8", "Cosine")])
def test_gm_bf16_int8_uint8_lanes(vtype, metric):
    rng = np.random.default_rng(13)
    x, q = _rows(rng, 512, 32, vtype), _rows(rng, 4, 32, vtype)
    is_int = vtype in ("INT8", "UINT8")
    aux = qn = None
    if is_int and metric == "Cosine":
        aux, qn = _norms(x), _norms(q)
    jx, jq = jnp.asarray(x), jnp.asarray(q)
    tx, tq = T(x), T(q)
    if not is_int:
        jd = jnp.bfloat16 if vtype == "BFLOAT16" else jnp.float16
        jx, jq, tx, tq = jx.astype(jd), jq.astype(jd), tx.to(_TORCH[vtype]), tq.to(_TORCH[vtype])
        if metric == "L2":
            aux = np_of(tx.float().square().sum(1))
    rd, ri, ru = jbf.pallas_topk_gm(
        jq, jx, None if aux is None else jnp.asarray(aux), jnp.int32(500), 8,
        metric=jt.VecSimMetric[metric], tile_n=64, group_n=16, interpret=True,
        query_norms=None if qn is None else jnp.asarray(qn))
    d, i, u = bfk.topk_gm(tq, tx, None if aux is None else T(aux), 500, 8,
                          metric=tt.VecSimMetric[metric], tile_n=64, group_n=16,
                          query_norms=None if qn is None else T(qn))
    assert np.array_equal(np_of(u), np_of(ru)) and not np_of(u).any()
    if is_int and metric != "Cosine":
        assert np.array_equal(np_of(d), np_of(rd)) and np.array_equal(np_of(i), np_of(ri))
    else:
        assert_topk_parity(d, i, rd, ri, 1e-6 if is_int else TOL)


@pytest.mark.parametrize("metric", ["L2", "Cosine"])
def test_gm_exact_integer_fallback_scores_as_integers(metric):
    # Every row identical: coverage cannot be shown (eps is 0 on the integer
    # lanes and every group minimum ties), so the exact wrapper answers from
    # the streaming scan with the integer formulas and the query norms.
    x = np.tile(np.arange(1, 33, dtype=np.uint8), (256, 1))
    q = x[:2].copy()
    aux, qn = (_norms(x), _norms(q)) if metric == "Cosine" else (None, None)
    opt = lambda a, conv: None if a is None else conv(a)
    rd, ri = jbf.pallas_topk_gm_exact(
        jnp.asarray(q), jnp.asarray(x), opt(aux, jnp.asarray), jnp.int32(256), 8,
        metric=jt.VecSimMetric[metric], kind="int", tile_n=64, group_n=16, interpret=True,
        query_norms=opt(qn, jnp.asarray))
    before = bfk.topk_gm_exact.fallbacks
    d, i = bfk.topk_gm_exact(T(q), T(x), opt(aux, T), 256, 8, metric=tt.VecSimMetric[metric],
                             kind="int", tile_n=64, group_n=16, query_norms=opt(qn, T))
    assert bfk.topk_gm_exact.fallbacks == before + 1
    assert_topk_parity(d, i, rd, ri, 1e-6)
    assert (np_of(i) == np.arange(8)).all()


_KS = [1, 10, 32, 33, 64, 100, 128, 129, 200, 500, 2048, 2049, 5000]


@pytest.mark.parametrize("vtype", ["FLOAT32", "BFLOAT16", "FLOAT16", "INT8", "UINT8", "FLOAT64"])
def test_engine_gates_follow_the_jax_bands(vtype, monkeypatch):
    # The JAX gates with their TPU-only conditions satisfied (on a TPU, batch
    # 1024, dim 768, fp32 at "high") against the port's, over capacities that
    # do and do not tile and every k band.
    monkeypatch.setattr(jconfig, "_on_tpu", lambda: True)
    monkeypatch.setattr(jconfig, "fp32_matmul_precision", "high")
    kind = "int" if vtype in ("INT8", "UINT8") else "float"
    jdtype = np.dtype(jt.numpy_dtype(jt.VecSimType[vtype]))
    seen = set()
    for cap in (1024, 4096, 1 << 16, 1 << 20, 4096 * 3 + 1024):
        for k in _KS:
            kpad = min(1 << max(k - 1, 0).bit_length(), cap)
            want = (jconfig.pallas_gm_enabled(kind, k, cap, jdtype, batch=1024, dim=768),
                    jconfig.pallas_enabled(kind, kpad, cap, jdtype, batch=1024, dim=768),
                    jconfig.pallas_bigk_enabled(kind, kpad, cap, jdtype, batch=1024, dim=768))
            got = (tconfig.gm_enabled(kind, k, cap, _TORCH[vtype]),
                   tconfig.fused_enabled(kind, kpad, cap, _TORCH[vtype]),
                   tconfig.bigk_enabled(kind, kpad, cap, _TORCH[vtype]))
            if vtype == "FLOAT64":  # no lane in the port; the JAX gates have no fp64 store
                assert got == (False, False, False)
            else:
                assert got == want, (cap, k)
            seen.add(got)
    if vtype != "FLOAT64":
        assert {(True, True, False), (False, True, False), (False, False, True),
                (False, False, False)} <= seen


@pytest.fixture
def engines(monkeypatch):
    """Small kernel tiles, and a log of which engine's plain version ran."""
    monkeypatch.setattr(tconfig, "tile_n", 64)
    monkeypatch.setattr(tconfig, "gm_group_n", 16)
    ran = []
    for name in ("group_min_scores_ref", "fused_topk_ref", "tile_topc_ref"):
        def counted(*a, _fn=getattr(bfk, name), _name=name, **kw):
            ran.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(bfk, name, counted)
    return ran


def _jax_engine(j, q, k, engine):
    """The JAX kernel engine of one band, in interpret mode on the JAX index's
    own store, as replies."""
    qh, qn = j.preprocess_queries(q)
    data, aux = j.store_tuple(j.store.device_arrays())
    kw = dict(metric=j.metric, tile_n=64, interpret=True,
              query_norms=None if qn is None else jnp.asarray(qn))
    args = (jnp.asarray(qh), data, aux, jnp.int32(j.store.count), k)
    if engine == "group_min_scores_ref":
        d, i = jbf.pallas_topk_gm_exact(*args, kind=j.store_kind, group_n=16, **kw)
    elif engine == "fused_topk_ref":
        d, i = jbf.pallas_topk(*args, **kw)
    else:
        d, i = jbf.pallas_topk_bigk_exact(*args, kind=j.store_kind, local_c=32, **kw)
    labels = j.store.host["label"]
    return [make_reply(labels[row], dist) for row, dist in zip(np_of(i), np_of(d))]


@pytest.mark.parametrize("vtype,metric", [("BFLOAT16", "Cosine"), ("FLOAT16", "L2"),
                                          ("INT8", "Cosine"), ("UINT8", "L2")])
def test_slice_matches_jax_per_store_type_and_band(vtype, metric, engines):
    rng = np.random.default_rng(["BFLOAT16", "FLOAT16", "INT8", "UINT8"].index(vtype))
    bf = jt.BFParams(type=jt.VecSimType[vtype], dim=DIM, metric=jt.VecSimMetric[metric])
    j = jcreate(jt.VecSimParams(algo=jt.VecSimAlgo.BF, bfParams=bf))
    x = _rows(rng, 900, DIM, vtype)
    j.add_vector_batch(x, range(900))
    for lab in range(0, 900, 9):
        j.delete_vector(lab)
    t = bruteforce_from_state(export_state(j), device="cpu")
    assert t.store.fields["data"].torch_dtype == _TORCH[vtype]
    assert t.store.device_arrays()["data"].dtype == _TORCH[vtype]
    for n, a in export_state(j)["arrays"].items():
        assert np.array_equal(np.asarray(export_state(t)["arrays"][n], a.dtype), a), n
    q = _rows(rng, 5, DIM, vtype)
    tol = 1e-6 if vtype in ("INT8", "UINT8") else TOL
    for k, engine in ((10, "group_min_scores_ref"), (64, "fused_topk_ref"),
                      (200, "tile_topc_ref")):
        del engines[:]
        got = t.topk_query_batch(q, k)
        assert engines == [engine], (k, engines)
        assert_replies_parity(got, _jax_engine(j, q, k, engine), tol)
    # The JAX index's own answer (its streaming scan on the CPU), once.
    want = j.topk_query_batch(q, 64)
    got = t.topk_query_batch(q, 64)
    assert_replies_parity(got, want, tol)
    if vtype == "UINT8":  # integer L2 is exact end to end
        for p, r in zip(got, want):
            assert np.array_equal(p.ids, r.ids) and np.array_equal(p.scores, r.scores)
    qd, qn = (t.to_device(a) for a in t.preprocess_queries(q))
    dd, ii = t.search_knn_device(qd, 2000, qn=qn)
    assert dd.shape == ii.shape == (5, 800)  # k' = min(k, count)


def test_bfloat16_store_without_a_numpy_bfloat16(monkeypatch, engines):
    # Where numpy has no bfloat16 the host mirror is fp32; the device copy and
    # the queries are bfloat16 all the same, the mirror holds bfloat16 values,
    # and the answers are those of the index with a bfloat16 mirror.
    rng = np.random.default_rng(4)
    x, q = unit_rows(rng, 700, DIM), unit_rows(rng, 3, DIM)
    bf = tt.BFParams(type=tt.VecSimType.BFLOAT16, dim=DIM, metric=tt.VecSimMetric.Cosine)
    usual = BruteForceIndex(bf, device="cpu")
    monkeypatch.setitem(tt._NUMPY_DTYPES, tt.VecSimType.BFLOAT16, np.dtype(np.float32))
    plain = BruteForceIndex(bf, device="cpu")
    assert plain.np_dtype == np.float32 and usual.np_dtype != np.float32
    for idx in (usual, plain):
        idx.add_vector_batch(x, range(700))
    dev = plain.store.device_arrays()["data"]
    assert dev.dtype == torch.bfloat16
    assert np.array_equal(plain.store.host["data"][:700], dev[:700].float().numpy())
    for k in (10, 64):
        for p, r in zip(plain.topk_query_batch(q, k), usual.topk_query_batch(q, k)):
            assert np.array_equal(p.ids, r.ids) and np.array_equal(p.scores, r.scores)
    assert abs(plain.get_distance_from(5, q[0]) - usual.get_distance_from(5, q[0])) <= 1e-6
    assert set(engines) == {"group_min_scores_ref", "fused_topk_ref"}


@pytest.mark.parametrize("case", ["FLOAT64", "multi"])
def test_fp64_and_multi_value_stay_on_the_streaming_scan(case, engines):
    rng = np.random.default_rng(3)
    vtype = tt.VecSimType.FLOAT64 if case == "FLOAT64" else tt.VecSimType.FLOAT32
    t = BruteForceIndex(tt.BFParams(type=vtype, dim=DIM, metric=tt.VecSimMetric.L2,
                                    multi=case == "multi"), device="cpu")
    t.add_vector_batch(unit_rows(rng, 700, DIM), range(700))
    for k in (10, 64, 200):
        assert len(t.topk_query(unit_rows(rng, 1, DIM)[0], k)) == k
    assert engines == []


def test_default_device_needs_a_card():
    # The entry points run on the card unless asked for the CPU; where there
    # is no card they refuse instead of falling back.
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is tested on it")
    bf = tt.BFParams(type=tt.VecSimType.FLOAT32, dim=4, metric=tt.VecSimMetric.L2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BruteForceIndex(bf)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tcreate(tt.VecSimParams(algo=tt.VecSimAlgo.BF, bfParams=bf))
    state = export_state(BruteForceIndex(bf, device="cpu"))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bruteforce_from_state(state)
    assert bruteforce_from_state(state, device="cpu").store.device.type == "cpu"


def test_port_imports_no_jax():
    root = Path(__file__).resolve().parents[2]
    files = sorted((root / "vectorsimilarity_tpu_torch").rglob("*.py")) + [root / "chip_smoke.py"]
    assert len(files) > 15
    banned = re.compile(r"^\s*(from|import)\s+(jax|vectorsimilarity_tpu)(\.|\s|$)", re.M)
    for f in files:
        assert not banned.search(f.read_text()), f
