"""Shared helpers of the port's parity tests (``tests/port/test_torch_*.py``).

The JAX package is the reference. Both sides compute in fp32 on the CPU in
different summation orders, so distances agree within ``TOL`` and ids agree
except where a distance lies within ``TOL`` of a neighbouring one.
"""

from __future__ import annotations

import numpy as np
import torch

TOL = 1e-5


def unit_rows(rng, n: int, d: int) -> np.ndarray:
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def np_of(x) -> np.ndarray:
    """numpy view of a torch tensor or a JAX array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_topk_parity(d, i, rd, ri, tol: float = TOL) -> None:
    """Port (d, i) against the reference (rd, ri), both [B, k] in
    (distance, id) order: unfilled slots (inf, -1) at the same places,
    distances within ``tol``, ids equal except at slots whose reference
    distance lies within ``tol`` of a neighbouring slot's."""
    d, i, rd, ri = (np_of(x) for x in (d, i, rd, ri))
    assert d.shape == rd.shape and i.shape == ri.shape == d.shape
    fin = np.isfinite(rd)
    assert np.array_equal(np.isfinite(d), fin)
    assert (i[~fin] == -1).all() and (ri[~fin] == -1).all()
    if fin.any():
        assert np.abs(d[fin].astype(np.float64) - rd[fin]).max() <= tol
    with np.errstate(invalid="ignore"):  # inf - inf between unfilled slots
        gap = np.abs(np.diff(rd.astype(np.float64), axis=1)) <= tol
    tied = np.zeros(d.shape, dtype=bool)
    tied[:, 1:] |= gap
    tied[:, :-1] |= gap
    assert ((i == ri) | tied).all(), (i, ri)


def assert_replies_parity(port, ref, tol: float = TOL) -> None:
    """Lists of QueryReply: same codes, and per reply the same labels and
    scores under ``assert_topk_parity`` (unfilled slots padded)."""
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        assert int(p.code) == int(r.code)
        assert len(p) == len(r)
        assert_topk_parity(p.scores[None], p.ids[None], r.scores[None], r.ids[None], tol)


# ---------------------------------------------------------------------------
# HNSW: graphs made with numpy, and the one JAX HNSW build of the tests
# ---------------------------------------------------------------------------


def numpy_graph(rng, n: int, d: int, m0: int, lane: str = "f32", upper_every: int = 6):
    """A two-level graph made with numpy: rows ``x`` [n, d] (unit fp32
    vectors, or int8 values), level-0 links [n, m0] (each node's m0 // 2
    nearest by L2 and random others, 4..m0 of them, distinct, never itself,
    -1 padded) and one upper level over every ``upper_every``-th node:
    ``ulinks`` [ucap, 1, m0 // 2], ``upper_row`` [n] (-1: no upper row) and
    the entry node. Returns a dict of numpy arrays and ints."""
    if lane == "s8":
        x = rng.integers(-128, 128, size=(n, d)).astype(np.int8)
    else:
        x = unit_rows(rng, n, d)
    xf = x.astype(np.float64)
    d2 = ((xf[:, None, :] - xf[None, :, :]) ** 2).sum(-1)
    np.fill_diagonal(d2, np.inf)

    def links_of(nodes, width):
        out = np.full((len(nodes), width), -1, dtype=np.int32)
        sub = d2[np.ix_(nodes, nodes)]
        near = np.argsort(sub, axis=1, kind="stable")
        for r in range(len(nodes)):
            cnt = int(rng.integers(4, width + 1))
            pick = list(near[r, : width // 2])
            others = [j for j in rng.permutation(len(nodes)) if j != r and j not in pick]
            pick = (pick + others)[:cnt]
            out[r, : len(pick)] = np.asarray(nodes)[pick]
        return out

    links0 = links_of(np.arange(n), m0)
    upper = np.arange(0, n, upper_every)
    ucap = 1 << int(np.ceil(np.log2(len(upper) + 1)))
    ulinks = np.full((ucap, 1, m0 // 2), -1, dtype=np.int32)
    ulinks[: len(upper), 0] = links_of(upper, m0 // 2)
    upper_row = np.full(n, -1, dtype=np.int32)
    upper_row[upper] = np.arange(len(upper), dtype=np.int32)
    return {"x": x, "links0": links0, "ulinks": ulinks, "upper_row": upper_row,
            "entry": int(upper[0])}


def lane_aux(x: np.ndarray, metric_name: str, lane: str):
    """(sqnorm, norm) columns a store of ``x`` keeps: sqnorm for L2, norm for
    integer Cosine, else None."""
    xf = x.astype(np.float64 if lane == "s8" else np.float32)
    sq = (xf * xf).sum(1).astype(np.float32)
    sqnorm = sq if metric_name == "L2" else None
    norm = np.sqrt(sq).astype(np.float32) if (lane == "s8" and metric_name == "Cosine") else None
    return sqnorm, norm


HNSW_N, HNSW_DIM, HNSW_BATCH = 384, 16, 128
_JAX_HNSW = None


def jax_hnsw_index():
    """The tests' one JAX HNSW build, made once per process and shared:
    ``HNSW_N`` x ``HNSW_DIM`` fp32 Cosine rows (seed 0), M = 8, efC = 64,
    level seed 200 (the index's default), inserted by one
    ``add_vector_batch`` with ``config.build_batch = HNSW_BATCH``: three
    connect batches of one shape (one compile), the later ones searching the
    graph of the earlier. Returns (index, rows)."""
    global _JAX_HNSW
    if _JAX_HNSW is None:
        import vectorsimilarity_tpu as vs
        from vectorsimilarity_tpu import config

        x = unit_rows(np.random.default_rng(0), HNSW_N, HNSW_DIM)
        idx = vs.create_index(hnsw_params(vs))
        saved, config.build_batch = config.build_batch, HNSW_BATCH
        try:
            idx.add_vector_batch(x, list(range(HNSW_N)))
        finally:
            config.build_batch = saved
        _JAX_HNSW = (idx, x)
    return _JAX_HNSW


def hnsw_params(pkg, multi: bool = False):
    """``VecSimParams`` of the shared HNSW configuration, from either
    package's module (``pkg`` exports the types)."""
    return pkg.VecSimParams(algo=pkg.VecSimAlgo.HNSWLIB, hnswParams=pkg.HNSWParams(
        type=pkg.VecSimType.FLOAT32, dim=HNSW_DIM, metric=pkg.VecSimMetric.Cosine,
        multi=multi, M=8, efConstruction=64))


# ---------------------------------------------------------------------------
# SVS: embedding-like rows and the tests' JAX SVS builds
# ---------------------------------------------------------------------------

SVS_N, SVS_DIM, SVS_BATCH = 512, 32, 128


def embedding_rows(rng, n: int, d: int, intrinsic: int = 8) -> np.ndarray:
    """Unit rows of low intrinsic dimension (``tests/test_svs_quant.py``'s
    ``embedding_like_np``): the regime quantization and LeanVec serve."""
    lat = rng.standard_normal((n, intrinsic)).astype(np.float32)
    proj = rng.standard_normal((intrinsic, d)).astype(np.float32)
    x = lat @ proj + 0.05 * rng.standard_normal((n, d)).astype(np.float32)
    return (x / np.linalg.norm(x, axis=1, keepdims=True)).astype(np.float32)


def svs_params(pkg, quant: str, metric: str = "Cosine", multi: bool = False, **kw):
    """``VecSimParams`` of the tests' SVS configuration (R = 16, L = 64,
    ws = 32 unless ``kw`` says otherwise), from either package's module."""
    sp = dict(type=pkg.VecSimType.FLOAT32, dim=SVS_DIM, metric=pkg.VecSimMetric[metric],
              multi=multi, quantBits=pkg.VecSimSvsQuantBits[quant], graph_max_degree=16,
              construction_window_size=64, search_window_size=32)
    sp.update(kw)
    return pkg.VecSimParams(algo=pkg.VecSimAlgo.SVS, svsParams=pkg.SVSParams(**sp))


def svs_build(idx, x, cfg) -> None:
    """``add_vector_batch`` of rows x with ``cfg.build_batch = SVS_BATCH``:
    connect chunks of one shape, the later ones searching the graph of the
    earlier."""
    saved, cfg.build_batch = cfg.build_batch, SVS_BATCH
    try:
        idx.add_vector_batch(x, list(range(len(x))))
    finally:
        cfg.build_batch = saved


def jax_svs_index(quant: str):
    """A JAX SVS index of ``SVS_N`` x ``SVS_DIM`` embedding-like Cosine rows
    (seed 0) in mode ``quant``, its links pulled to the host. Returns
    (index, rows)."""
    import vectorsimilarity_tpu as vs
    from vectorsimilarity_tpu import config

    x = embedding_rows(np.random.default_rng(0), SVS_N, SVS_DIM)
    idx = vs.create_index(svs_params(vs, quant))
    svs_build(idx, x, config)
    idx._ensure_host_links()
    return idx, x


# ---------------------------------------------------------------------------
# The host-orchestrated build (``config.graph_build_device = False``)
# ---------------------------------------------------------------------------


def host_add(idx, cfg, rows, labels):
    """``add_vector_batch`` with ``cfg.graph_build_device`` off (the
    host-orchestrated construction); returns its result."""
    saved, cfg.graph_build_device = cfg.graph_build_device, False
    try:
        return idx.add_vector_batch(rows, labels)
    finally:
        cfg.graph_build_device = saved


def assert_same_graph(jidx, tidx) -> None:
    """The JAX and port graph indexes (HNSW or SVS) hold the same links,
    labels and entry point, row for row."""
    from vectorsimilarity_tpu_torch import convert

    svs = hasattr(tidx, "R")
    js, ts = ((convert.export_svs_state if svs else convert.export_hnsw_state)(i)
              for i in (jidx, tidx))
    names = ("label", "links", "nlinks") if svs else ("label", "level", "links0", "nlinks0")
    for name in names:
        assert np.array_equal(ts["arrays"][name], js["arrays"][name]), name
    if not svs:
        for name in ("links", "nlinks", "vec"):
            assert np.array_equal(ts["upper"]["arrays"][name], js["upper"]["arrays"][name]), name
    assert ts["entry_id"] == js["entry_id"] and ts["count"] == js["count"]
