"""Batched distance computation and exact streaming top-k.

Counterpart of ``vectorsimilarity_tpu/ops/distances.py``: a batched score
matrix ``scores(queries[B,D], data[N,D]) -> [B,N]`` computed as one matmul.

Distance conventions match the reference exactly:
  - L2     -> squared L2 (no sqrt)          (``spaces/L2/L2.cpp``)
  - IP     -> 1 - <q, v>                    (``spaces/IP/IP.cpp``)
  - Cosine -> 1 - <q, v> on normalized data (floats are normalized at ingest;
              int8/uint8 divide by stored norms — ``IP.cpp:258-287``)

fp32 matmuls run in IEEE fp32 (``config`` disables TF32). Tie order is the
JAX package's: equal distance -> lower id first (``_lex_topk``).
SQ8/SQ4 stores (SVS's quantized codes) are scored asymmetrically against
float queries (``scores_sq8``, ``scores_sq4``).
"""

from __future__ import annotations

from typing import Optional

import torch

from .. import config  # noqa: F401  (sets the fp32 matmul precision)
from ..types import VecSimMetric
from .quantize import unpack4


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    """Accumulation dtype: f64 stays f64, the rest accumulates in f32."""
    return torch.float64 if dtype == torch.float64 else torch.float32


# ---------------------------------------------------------------------------
# Float family: fp32 / fp64 / bf16 / fp16
# ---------------------------------------------------------------------------


def scores_float(
    queries: torch.Tensor,
    data: torch.Tensor,
    metric: VecSimMetric,
    data_sqnorms: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Distance matrix [B, N] for float-typed vectors.

    L2 uses ||q-v||² = ||q||² - 2<q,v> + ||v||² (one matmul plus rank-1
    updates); ``data_sqnorms`` ([N]) may be precomputed by the store. Cosine
    storage and queries are normalized at preprocess time, so Cosine == IP
    here. bf16/fp16 inputs are widened to fp32 first: their products are
    exact in fp32 and the sum accumulates in fp32, as the JAX lane does.
    """
    metric = VecSimMetric(metric)
    acc = _acc_dtype(queries.dtype)
    q = queries.to(acc)
    ip = q @ data.to(acc).T
    if metric in (VecSimMetric.IP, VecSimMetric.Cosine):
        return 1.0 - ip
    q_sq = torch.sum(q * q, dim=-1, keepdim=True)  # [B, 1]
    if data_sqnorms is None:
        d = data.to(acc)
        data_sqnorms = torch.sum(d * d, dim=-1)  # [N]
    return q_sq - 2.0 * ip + data_sqnorms[None, :].to(acc)


# ---------------------------------------------------------------------------
# Integer family: int8 / uint8 (with stored norms for Cosine)
# ---------------------------------------------------------------------------


def _int_dot(queries: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Exact integer dot [B, N] as int64.

    The product runs as an fp64 matmul: every partial sum is an integer
    below 255² · D < 2^53, so fp64 holds it exactly in any summation order
    (integer matmul has no CUDA path in PyTorch).
    """
    ip = queries.to(torch.float64) @ data.to(torch.float64).T
    return ip.to(torch.int64)


def scores_int(
    queries: torch.Tensor,
    data: torch.Tensor,
    metric: VecSimMetric,
    data_norms: Optional[torch.Tensor] = None,
    query_norms: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Distance matrix [B, N] for int8/uint8 vectors.

    Exact integer arithmetic with one cast to fp32 at the end, matching the
    reference (``spaces/IP/IP.cpp:258-287``). Cosine divides the integer dot
    by the product of the stored fp32 norms.
    """
    metric = VecSimMetric(metric)
    ip = _int_dot(queries, data)
    if metric == VecSimMetric.IP:
        return 1.0 - ip.to(torch.float32)
    if metric == VecSimMetric.Cosine:
        denom = query_norms[:, None] * data_norms[None, :]
        return 1.0 - ip.to(torch.float32) / denom
    q = queries.to(torch.int64)
    d = data.to(torch.int64)
    q_sq = torch.sum(q * q, dim=-1, keepdim=True)
    d_sq = torch.sum(d * d, dim=-1)
    return (q_sq - 2 * ip + d_sq[None, :]).to(torch.float32)


# ---------------------------------------------------------------------------
# SQ8 / SQ4 asymmetric: uint8 storage codes vs float queries
# ---------------------------------------------------------------------------


def scores_sq8(
    queries: torch.Tensor,
    codes: torch.Tensor,
    vmin: torch.Tensor,
    delta: torch.Tensor,
    xsumsq: Optional[torch.Tensor],
    metric: VecSimMetric,
) -> torch.Tensor:
    """Asymmetric SQ8 distance matrix [B, N].

    Storage: ``codes`` u8 [N, D] with per-row ``vmin`` / ``delta`` /
    ``xsumsq`` (f32 [N]), the SoA form of the reference's inline
    ``[u8[dim] | min | delta | sum x | sum x^2]`` blob
    (``spaces/computer/preprocessors.h:150-162``). Queries stay float:

      IP(x, y) = min * sum y + delta * sum(q_i * y_i)   (IP.cpp:35-71)
      IP dist  = 1 - IP(x, y)
      L2 dist  = sum x^2 - 2 IP(x, y) + sum y^2         (L2.cpp:30-46)

    The product is one fp32 matmul over the codes (IEEE fp32, TF32 off).
    """
    metric = VecSimMetric(metric)
    q = queries.to(torch.float32)
    qdot = q @ codes.to(torch.float32).T  # [B, N]
    ysum = torch.sum(q, dim=-1, keepdim=True)
    ip = vmin[None, :] * ysum + delta[None, :] * qdot
    if metric in (VecSimMetric.IP, VecSimMetric.Cosine):
        return 1.0 - ip
    ysumsq = torch.sum(q * q, dim=-1, keepdim=True)
    return xsumsq[None, :] - 2.0 * ip + ysumsq


def scores_sq4(
    queries: torch.Tensor,
    packed: torch.Tensor,
    vmin: torch.Tensor,
    delta: torch.Tensor,
    xsumsq: Optional[torch.Tensor],
    metric: VecSimMetric,
) -> torch.Tensor:
    """Asymmetric 4-bit (LVQ level 1) distance matrix [B, N]: the split-packed
    codes (``quantize.pack4``) unpacked, then ``scores_sq8``. An odd dim pads
    the query with a zero column to the codes' even width."""
    codes = unpack4(packed)
    pad = codes.shape[-1] - queries.shape[-1]
    if pad:
        queries = torch.cat([queries, queries.new_zeros((queries.shape[0], pad))], dim=1)
    return scores_sq8(queries, codes, vmin, delta, xsumsq, metric)


# ---------------------------------------------------------------------------
# Pairwise distance between two single vectors (GetDistanceFrom parity)
# ---------------------------------------------------------------------------


def one_to_one(
    a: torch.Tensor,
    b: torch.Tensor,
    metric: VecSimMetric,
    a_norm: Optional[torch.Tensor] = None,
    b_norm: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Single-pair distance matching ``VecSimIndex_GetDistanceFrom_Unsafe``."""
    if not a.dtype.is_floating_point:
        return scores_int(
            a[None, :],
            b[None, :],
            metric,
            data_norms=None if b_norm is None else torch.as_tensor(b_norm).reshape(1),
            query_norms=None if a_norm is None else torch.as_tensor(a_norm).reshape(1),
        )[0, 0]
    return scores_float(a[None, :], b[None, :], metric)[0, 0]


# ---------------------------------------------------------------------------
# Exact selection in (distance, position) order
# ---------------------------------------------------------------------------


def _lex_topk(d: torch.Tensor, k: int):
    """Exact smallest-k per row in (value, position) order.

    Equal values come out lower position first, as the JAX ``_lex_topk``
    and ``lax.top_k`` order them (``torch.topk`` promises no tie order).
    fp32 rows select on a unique int64 key: the value's order-preserving
    bit pattern in the high 32 bits, the position in the low 32 — so
    ``torch.topk`` on the key is exact and tie-free. fp64 rows take a
    stable sort. Returns (vals [B, k], positions [B, k] int64); exhausted
    slots are +inf.
    """
    B, L = d.shape
    if k > L:
        raise ValueError(f"k={k} exceeds row width {L}")
    if d.dtype == torch.float32:
        bits = (d + 0.0).view(torch.int32)  # + 0.0 folds -0.0 into +0.0
        ordered = bits ^ ((bits >> 31) & 0x7FFFFFFF)
        pos = torch.arange(L, device=d.device, dtype=torch.int64)
        key = (ordered.to(torch.int64) << 32) | pos
        _, idx = torch.topk(key, k, dim=1, largest=False, sorted=True)
    else:
        idx = torch.sort(d, dim=1, stable=True).indices[:, :k]
    return torch.gather(d, 1, idx), idx


def _merge_topk(best_d, best_i, new_d, new_i, k: int):
    """Merge running top-k (smallest distances) with fresh candidates;
    ties keep the running entries first, as ``lax.top_k`` does."""
    d = torch.cat([best_d, new_d], dim=1)
    i = torch.cat([best_i, new_i], dim=1)
    vals, pos = _lex_topk(d, k)
    return vals, torch.gather(i, 1, pos)


# ---------------------------------------------------------------------------
# Streaming top-k over a large store (chunked scan; avoids [B, N] at once)
# ---------------------------------------------------------------------------


def _score_chunk(queries, store, lo, hi, metric, kind, query_norms):
    def view(x):
        return None if x is None else x[lo:hi]

    if kind == "float":
        data, sqn = store
        return scores_float(queries, view(data), metric, view(sqn))
    if kind == "int":
        data, norms = store
        return scores_int(queries, view(data), metric, view(norms), query_norms)
    if kind in ("sq8", "sq4"):
        codes, vmin, delta, xsumsq = store
        fn = scores_sq8 if kind == "sq8" else scores_sq4
        return fn(queries, view(codes), view(vmin), view(delta), view(xsumsq), metric)
    raise ValueError(f"unknown store kind {kind!r}")


def streaming_topk(
    queries: torch.Tensor,
    store: tuple,
    count: int,
    k: int,
    *,
    metric: VecSimMetric,
    kind: str,
    chunk: int = 1 << 16,
    query_norms: Optional[torch.Tensor] = None,
    seg_chunks: Optional[int] = None,
    start_chunk: int = 0,
    best_init: Optional[tuple] = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN over a device-resident store without materializing [B, N].

    Scans the store in ``chunk``-row slices; each step is one matmul and a
    merge into the running ``(dists[B,k], ids[B,k])`` — the replacement for
    the reference's per-vector loop + bounded heap
    (``algorithms/brute_force/brute_force.h:242-291``).

    ``store`` is ("float") ``(data[N,D], sqnorms[N] or None)``, ("int")
    ``(data[N,D], norms[N] or None)`` or ("sq8", "sq4") ``(codes, vmin[N],
    delta[N], xsumsq[N] or None)``. Rows with index >= count are masked
    to +inf; unfilled slots (k > count) are (+inf, -1).

    Timeout segmentation: ``seg_chunks`` chunks starting at ``start_chunk``,
    continuing from ``best_init`` (the previous segment's result), so the
    caller can poll its timeout callback between segments.
    """
    metric = VecSimMetric(metric)
    B = queries.shape[0]
    N = store[0].shape[0]
    n_chunks = max(1, -(-N // chunk))
    if seg_chunks is not None:
        n_chunks = min(seg_chunks, n_chunks)
    sdtype = torch.float64 if store[0].dtype == torch.float64 else torch.float32
    if best_init is not None:
        best_d, best_i = best_init
    else:
        best_d = torch.full((B, k), float("inf"), dtype=sdtype, device=queries.device)
        best_i = torch.full((B, k), -1, dtype=torch.int64, device=queries.device)
    for c in range(start_chunk, start_chunk + n_chunks):
        lo = c * chunk
        hi = min(lo + chunk, N, count)
        if lo >= hi:
            continue  # every row of the chunk is dead or past the store
        d = _score_chunk(queries, store, lo, hi, metric, kind, query_norms).to(sdtype)
        vals, pos = _lex_topk(d, min(k, hi - lo))
        best_d, best_i = _merge_topk(best_d, best_i, vals, pos + lo, k)
    best_i = torch.where(torch.isfinite(best_d), best_i, -1)
    return best_d, best_i


def full_scores(
    queries: torch.Tensor,
    store: tuple,
    count: int,
    *,
    metric: VecSimMetric,
    kind: str,
    query_norms: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """All-pairs distance matrix [B, N] with rows >= count masked to +inf.

    Used by the BF batch iterator (compute-all-scores-once design,
    ``bf_batch_iterator.h:176-199``) and range queries.
    """
    N = store[0].shape[0]
    d = _score_chunk(queries, store, 0, N, VecSimMetric(metric), kind, query_norms)
    sdtype = torch.float64 if store[0].dtype == torch.float64 else torch.float32
    ids = torch.arange(N, device=d.device)
    return torch.where(ids[None, :] < count, d.to(sdtype), float("inf"))
