"""The port's host-orchestrated graph builds against the JAX package's, on
the CPU.

With ``config.graph_build_device = False`` in both packages, the same rows
inserted in the same batches build the same graph row for row:

- HNSW, 512 x 16 L2, M = 8, efC = 60 (``tests/test_hnsw_device_build.py``'s
  host-path case), in two batches of 256: the first batch connects through
  its pair distances alone, the second descends the graph of the first
  (level beams, greedy steps, the level-0 beam). ``links0``, ``nlinks0``,
  the levels, the upper store, the entry point and the maximum level are
  equal, and recall@10 reaches the JAX test's 0.9;
- SVS in NONE, Scalar and Q4x8 (``torch_port_common``'s 512 x 32
  embedding-like Cosine rows, R = 16, L = 64, batches of 128): ``links``,
  ``nlinks`` and the medoid entry are equal.

The JAX builds run once per module. Then the quality case of
``tests/test_svs_device_build.py`` (16-d L2 in batches of 256), here 1,280
rows, so the store grows past its first capacity bucket of 1,024 mid-build:
the port's device build reaches recall@10 0.9, and its host build stays
within 0.08 of it. Last, the root's exports are a superset of the JAX
package's (less the sharding names, a later slice), and ``bindings`` and
``models`` hold the JAX package's classes.
"""

import inspect

import numpy as np
import pytest

import vectorsimilarity_tpu as jvs
import vectorsimilarity_tpu_torch as tvs
from torch_port_common import SVS_N, embedding_rows, svs_params
from vectorsimilarity_tpu import config as jconfig
from vectorsimilarity_tpu_torch import config as tconfig
from vectorsimilarity_tpu_torch.convert import export_hnsw_state, export_svs_state

MODES = ["NONE", "Scalar", "Q4x8"]
BATCH = 128


def _hnsw_params(pkg):
    return pkg.VecSimParams(algo=pkg.VecSimAlgo.HNSWLIB, hnswParams=pkg.HNSWParams(
        type=pkg.VecSimType.FLOAT32, dim=16, metric=pkg.VecSimMetric.L2, M=8,
        efConstruction=60, efRuntime=30))


def _svs_l2(pkg):
    return pkg.VecSimParams(algo=pkg.VecSimAlgo.SVS, svsParams=pkg.SVSParams(
        type=pkg.VecSimType.FLOAT32, dim=16, metric=pkg.VecSimMetric.L2,
        graph_max_degree=16, construction_window_size=60))


def _build(idx, x, cfg, device: bool, batch: int) -> None:
    saved, cfg.graph_build_device = cfg.graph_build_device, device
    try:
        for off in range(0, len(x), batch):
            idx.add_vector_batch(x[off:off + batch], list(range(off, min(off + batch, len(x)))))
    finally:
        cfg.graph_build_device = saved


def _recall(idx, data, k=10, nq=32, seed=5, ws=None):
    rng = np.random.default_rng(seed)
    q = data[rng.integers(0, len(data), nq)] + 0.05 * rng.standard_normal(
        (nq, data.shape[1])).astype(np.float32)
    gt = np.argsort(((q[:, None] - data[None]) ** 2).sum(-1), axis=1)[:, :k]
    params = tvs.VecSimQueryParams()
    params.hnswRuntimeParams.efRuntime = 60
    if ws:
        params.svsRuntimeParams.windowSize = ws
    hits = sum(len(set(r.ids.tolist()) & set(g.tolist()))
               for r, g in zip(idx.topk_query_batch(q, k, params), gt))
    return hits / (nq * k)


@pytest.fixture(scope="module")
def jax_builds():
    """The JAX package's host builds of every case, as exported state."""
    out = {}
    x = np.random.default_rng(7).standard_normal((512, 16)).astype(np.float32)
    idx = jvs.create_index(_hnsw_params(jvs))
    _build(idx, x, jconfig, False, 2 * BATCH)
    out["hnsw"] = (export_hnsw_state(idx), x)
    e = embedding_rows(np.random.default_rng(0), SVS_N, 32)
    for mode in MODES:
        idx = jvs.create_index(svs_params(jvs, mode))
        _build(idx, e, jconfig, False, BATCH)
        out[mode] = (export_svs_state(idx), e)
    return out


def test_hnsw_host_build_equals_jax(jax_builds):
    js, x = jax_builds["hnsw"]
    idx = tvs.create_index(_hnsw_params(tvs), device="cpu")
    _build(idx, x, tconfig, False, 2 * BATCH)
    assert not idx._host_links_stale
    ts = export_hnsw_state(idx)
    for name in ("label", "level", "upper_row", "links0", "nlinks0", "flags"):
        assert np.array_equal(ts["arrays"][name], js["arrays"][name]), name
    for name in ("links", "nlinks", "vec"):
        assert np.array_equal(ts["upper"]["arrays"][name], js["upper"]["arrays"][name]), name
    assert (ts["entry_id"], ts["max_level"], ts["lmax"]) == (
        js["entry_id"], js["max_level"], js["lmax"])
    assert js["max_level"] >= 1
    assert _recall(idx, x) >= 0.9


@pytest.mark.parametrize("mode", MODES)
def test_svs_host_build_equals_jax(jax_builds, mode):
    js, x = jax_builds[mode]
    idx = tvs.create_index(svs_params(tvs, mode), device="cpu")
    _build(idx, x, tconfig, False, BATCH)
    ts = export_svs_state(idx)
    assert ts["entry_id"] == js["entry_id"]
    for name in ("links", "nlinks", "data", "label"):
        assert np.array_equal(ts["arrays"][name], js["arrays"][name]), name


def test_svs_host_build_quality_and_growth():
    """``tests/test_svs_device_build.py:83-93`` with 1,280 rows: the fifth
    batch of 256 grows the store past its first capacity bucket."""
    x = np.random.default_rng(1).standard_normal((1280, 16)).astype(np.float32)
    recall = {}
    for device in (True, False):
        idx = tvs.create_index(_svs_l2(tvs), device="cpu")
        _build(idx, x, tconfig, device, 256)
        assert idx.store.capacity == 2048 and idx.index_size == 1280
        recall[device] = _recall(idx, x, nq=24, ws=60)
    assert recall[True] >= 0.9
    assert recall[True] >= recall[False] - 0.08


def test_root_exports_and_bindings_surface():
    def public(mod):
        return {n for n in dir(mod) if not n.startswith("_")
                and not inspect.ismodule(getattr(mod, n))}

    missing = public(jvs) - public(tvs) - {"make_mesh", "ShardedHNSW", "ShardedVamana"}
    assert not missing, missing
    from vectorsimilarity_tpu import bindings as jb
    from vectorsimilarity_tpu import models as jm
    from vectorsimilarity_tpu_torch import bindings as tb
    from vectorsimilarity_tpu_torch import models as tm

    for jmod, tmod in ((jb, tb), (jm, tm)):
        names = {n for n, v in vars(jmod).items() if inspect.isclass(v)
                 and v.__module__.startswith(jmod.__name__.rsplit(".", 1)[0])}
        assert names <= set(vars(tmod)), names - set(vars(tmod))
    labels = tvs.core.labels.MultiLabelMap()
    labels.add(7, 0)
    assert labels.slot_of_label(7) == 0
