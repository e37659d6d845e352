"""HNSW and Vamana (SVS) construction on the device, one insert batch at a
time.

Counterpart of ``vectorsimilarity_tpu/ops/graph_build.py`` (the reference's
``insertElementToGraph``, ``mutuallyConnectNewElement`` and
``revisitNeighborConnections``, ``hnsw.h:1548-1583``, ``:870-944``,
``:781-868``). An HNSW batch of already-stored vectors is connected by:

  - an upper-level descent, level by level (a host loop where the JAX
    package has a ``lax.scan``): the nodes living at a level run the
    candidate beam, the others descend greedily;
  - the level-0 candidate beam, intra-batch pair distances and the diversity
    prune (heuristic 2 with m = M at every level; only reverse edges grow a
    level-0 row toward M0);
  - reverse edges as a sort-segment scatter: pairs (target row, new node)
    sorted by row, ranked within segments, appended where the row has room,
    and every overflowing row re-pruned over (existing links | new nodes).

The graph tensors are updated in place. The batch, the level sampling, the
entry point and the maximum level are known on the host, so the JAX
program's masks over inactive rows become row subsets here: a beam or prune
runs only on the rows whose result is kept, which gives the same rows the
same result (rows are independent). The only host reads are the loops'
polls (``graph_search``) and the row subsets of the reverse-edge re-prune.

A Vamana batch (``vamana_connect``) is the single-level case: a beam from
the medoid entry, the intra-batch pairs, the prune with the robust-alpha
rule, and the same reverse-edge pass with ``alpha``. Quantized stores are
built from their primary-space decode (``anchor_queries``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..types import VecSimMetric
from .quantize import unpack4
from .graph_search import (
    StoreCtx,
    beam_search,
    diversity_prune_chunked,
    dists_to_ids,
    greedy_level,
)


@dataclass
class GraphState:
    """Device graph tensors threaded through construction; the entry point
    and the maximum level are host ints (the host mirrors them anyway)."""

    links0: torch.Tensor  # [cap, M0] int32, -1 padded
    nlinks0: torch.Tensor  # [cap] int32
    ulinks: torch.Tensor  # [ucap, LU, M] int32, -1 padded
    unlinks: torch.Tensor  # [ucap, LU] int32
    upper_row: torch.Tensor  # [cap] int32 vector id -> row in ulinks (-1: none)
    entry: int  # entry vector id (-1: empty graph)
    max_level: int  # (-1: empty graph)


def anchor_queries(ctx: StoreCtx, ids: torch.Tensor, kind: str, metric):
    """(q, q_norm, q_meta) for stored rows used as distance anchors: the new
    node, or the owner of a row being re-pruned. For the quantized kinds the
    anchor is the primary-space decode of the stored codes, with (sum q,
    sum q^2) recomputed: construction never sees the original float row, as
    the reference's SVS build works on the compressed dataset."""
    if kind in ("sq8", "sq4"):
        codes = ctx.data[ids]
        if kind == "sq4":
            codes = unpack4(codes)
        q = ctx.vmin[ids][:, None] + ctx.delta[ids][:, None] * codes.to(torch.float32)
        return q, None, (torch.sum(q, dim=-1), torch.sum(q * q, dim=-1))
    q = ctx.data[ids]
    qn = None
    if kind == "int" and VecSimMetric(metric) == VecSimMetric.Cosine:
        qn = ctx.norm[ids]
    return q, qn, None


def _segment_ranks(key: torch.Tensor):
    """Per-element segment bookkeeping for a sorted key array.

    Returns (is_start, rank, seg_count, seg_id): rank within the run of
    equal keys, the run length, and a dense run index. Invalid entries must
    share one sentinel key sorted last, so they form their own trailing
    segment."""
    P = key.shape[0]
    iota = torch.arange(P, device=key.device)
    is_start = torch.ones((P,), dtype=torch.bool, device=key.device)
    is_start[1:] = key[1:] != key[:-1]
    seg_start = torch.cummax(torch.where(is_start, iota, 0), dim=0).values
    rank = iota - seg_start
    starts = torch.where(is_start, iota, P)
    min_suffix = torch.flip(torch.cummin(torch.flip(starts, (0,)), dim=0).values, (0,))
    next_start = torch.cat([min_suffix[1:], min_suffix.new_full((1,), P)])
    seg_count = next_start[seg_start] - seg_start
    seg_id = torch.cumsum(is_start.to(torch.int64), dim=0) - 1
    return is_start, rank, seg_count, seg_id


def _put(dst: torch.Tensor, index: tuple, values: torch.Tensor, ok: torch.Tensor) -> None:
    """``dst[index] = values`` where ``ok``, in place; the JAX package's
    ``.at[].set(mode="drop")`` with the array size as the drop index. Masked
    writes go to a scratch row appended to ``dst`` for the call."""
    R = dst.shape[0]
    ext = torch.cat([dst, dst[:1]])
    rows = torch.where(ok, index[0], R)
    rest = tuple(torch.where(ok, i, 0) for i in index[1:])
    ext.index_put_((rows, *rest), values)
    dst.copy_(ext[:R])


def apply_reverse_edges_device(
    links: torch.Tensor,  # [R, mcap], updated in place
    nlinks: torch.Tensor,  # [R], updated in place
    rows: torch.Tensor,  # [P] target row in links, -1 or >= R invalid
    dst_ids: torch.Tensor,  # [P] target vector id (distance anchor), -1 invalid
    src_ids: torch.Tensor,  # [P] new-node vector id
    ctx: StoreCtx,
    *,
    m_cap: int,
    a_cap: int,
    metric: VecSimMetric,
    kind: str,
    alpha: float = 1.0,
):
    """Append src -> row back-edges; re-prune rows that overflow.

    A row with room appends; a full row re-runs heuristic 2 over (existing
    neighbours | new nodes), anchored at the row owner's vector. At most
    ``a_cap`` new nodes per row join the re-prune; the surplus pairs are
    returned as a residual (rows == R marks handled slots) for a further
    pass. Returns (res_rows, res_dst, res_src) in sorted-pair order.
    """
    R = links.shape[0]
    P = rows.shape[0]
    valid = (rows >= 0) & (rows < R) & (src_ids >= 0)
    key = torch.where(valid, rows, R).to(torch.int64)
    key_s, order = torch.sort(key, stable=True)
    src_s = src_ids[order].to(torch.int32)
    dst_s = dst_ids[order].to(torch.int32)
    valid_s = key_s < R
    is_start, rank, seg_count, seg_id = _segment_ranks(key_s)
    safe_key = torch.clamp(key_s, max=R - 1)
    base = nlinks[safe_key].to(torch.int64)
    total = base + seg_count
    fits = total <= m_cap

    # --- appends into rows with room ---
    app_ok = valid_s & fits
    _put(links, (key_s, base + rank), src_s, app_ok)
    _put(nlinks, (key_s,), total.to(nlinks.dtype), app_ok & is_start)

    # --- overflowing rows: heuristic re-prune over old | new, computed only
    # for the rows it is applied to (the segment starts) ---
    newmat = torch.full((P, a_cap), -1, dtype=torch.int32, device=links.device)
    put = valid_s & (rank < a_cap)
    _put(newmat, (seg_id, rank), src_s, put)
    leftover = valid_s & ~fits & (rank >= a_cap)
    starts = torch.nonzero(is_start & valid_s & ~fits).squeeze(1)
    if starts.numel():
        r_rows = key_s[starts]
        old = links[r_rows]
        cand = torch.cat([old, newmat[seg_id[starts]]], dim=1)
        owner = dst_s[starts]
        qv, qn, qm = anchor_queries(ctx, torch.clamp(owner, min=0), kind, metric)
        # A row never keeps its owner.
        cand = torch.where(cand == owner[:, None], -1, cand)
        pruned = diversity_prune_chunked(
            qv, cand, None, ctx, m=m_cap, metric=metric, kind=kind, alpha=alpha, q_norm=qn,
            q_meta=qm,
        )
        links[r_rows] = pruned.to(links.dtype)
        nlinks[r_rows] = (pruned >= 0).sum(dim=1).to(nlinks.dtype)
    res_rows = torch.where(leftover, key_s, R)
    res_dst = torch.where(leftover, dst_s, -1)
    res_src = torch.where(leftover, src_s, -1)
    return res_rows, res_dst, res_src


def apply_reverse_edges_multi(
    links, nlinks, rows, dst_ids, src_ids, ctx, *,
    m_cap, a_cap, metric, kind, alpha=1.0, passes=2,
):
    """Reverse-edge application with residual passes: each pass admits up to
    ``a_cap`` new back-edges per row, and the surplus is compacted to a
    small bucket and re-applied. Pairs left after the last pass are counted.

    Returns the dropped count (a device scalar)."""
    R = links.shape[0]
    dropped = torch.zeros((), dtype=torch.int64, device=links.device)
    for p in range(passes):
        rows, dst_ids, src_ids = apply_reverse_edges_device(
            links, nlinks, rows, dst_ids, src_ids, ctx,
            m_cap=m_cap, a_cap=a_cap, metric=metric, kind=kind, alpha=alpha,
        )
        if p + 1 < passes:
            # Residuals are rare (hub rows only): compact to P/8 slots.
            P = rows.shape[0]
            bucket = max(min(P, 256), P // 8)
            if bucket < P:
                n_res = (rows < R).sum()
                order = torch.argsort((rows >= R).to(torch.int8), stable=True)[:bucket]
                rows, dst_ids, src_ids = rows[order], dst_ids[order], src_ids[order]
                dropped = dropped + n_res - (rows < R).sum()
    return dropped + (rows < R).sum()


def connect_batch(
    state: GraphState,
    ctx: StoreCtx,
    ids: np.ndarray,  # [n] int new-node row ids (contiguous ascending)
    levels: np.ndarray,  # [n] int sampled levels
    urows: np.ndarray,  # [n] int upper-store row (-1 for level-0 nodes)
    *,
    efc: int,
    M: int,
    M0: int,
    metric: VecSimMetric,
    kind: str,
    a_cap: int = 16,
    rev_passes: int = 2,
    beam_expand: int = 4,
):
    """Insert one batch of already-stored vectors into the graph.

    The batch's vectors must already be in ``ctx.data`` at ``ids``. Updates
    ``state`` in place and returns it with the dropped reverse-edge count (a
    device scalar, 0 in healthy builds)."""
    metric = VecSimMetric(metric)
    dev = state.links0.device
    ids = np.asarray(ids, dtype=np.int64)
    levels = np.asarray(levels, dtype=np.int64)
    n = len(ids)
    cap = state.links0.shape[0]
    LU = state.ulinks.shape[1]
    ids_t = torch.from_numpy(ids).to(dev)
    state.upper_row[ids_t] = torch.from_numpy(np.asarray(urows, dtype=np.int32)).to(dev)

    q, qn, _ = anchor_queries(ctx, ids_t, kind, metric)
    has_graph = state.entry >= 0
    max_level = state.max_level
    cur = torch.full((n,), max(state.entry, 0), dtype=torch.int32, device=dev)
    cur_d = dists_to_ids(q, cur[:, None], ctx, metric=metric, kind=kind, q_norm=qn)[:, 0]

    # --- intra-batch pair distances (new nodes are invisible to the graph;
    # their mutual candidates come from this exact [n, n] block) ---
    ids32 = ids_t.to(torch.int32)
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    if n > 1:
        pair = dists_to_ids(q, ids32[None, :].expand(n, n), ctx, metric=metric, kind=kind,
                            q_norm=qn)
        pair = torch.where(eye, torch.inf, pair)
    else:
        pair = torch.full((1, 1), torch.inf, device=dev)

    def sub(x, r):
        return None if x is None else x[r]

    # --- upper-level descent + per-level candidates + own-row selection ---
    selU = torch.full((n, LU, M), -1, dtype=torch.int32, device=dev)
    for lvl in range(LU, 0, -1):
        in_graph = has_graph and lvl <= max_level
        beam_rows = np.nonzero(levels >= lvl)[0] if in_graph else np.empty(0, np.int64)
        greedy_rows = np.nonzero(levels < lvl)[0] if in_graph else np.empty(0, np.int64)
        at_level = np.nonzero(levels >= lvl)[0]
        bd = torch.full((len(at_level), efc), torch.inf, device=dev)
        bi = torch.full((len(at_level), efc), -1, dtype=torch.int32, device=dev)
        if len(beam_rows):
            # beam_rows == at_level here: every node at this level runs it.
            r = torch.from_numpy(beam_rows).to(dev)
            bd, bi = beam_search(
                q[r], ctx, state.ulinks, state.upper_row, cur[r], cur_d[r], cap, level=lvl,
                ef=efc, metric=metric, kind=kind, q_norm=sub(qn, r), expand=beam_expand,
            )
            took = bi[:, 0] >= 0
            cur[r] = torch.where(took, bi[:, 0], cur[r])
            cur_d[r] = torch.where(took, bd[:, 0], cur_d[r])
        if len(greedy_rows):
            r = torch.from_numpy(greedy_rows).to(dev)
            cur[r], cur_d[r] = greedy_level(
                q[r], ctx, state.ulinks, state.upper_row, cur[r], cur_d[r], level=lvl,
                metric=metric, kind=kind, q_norm=sub(qn, r),
            )
        if len(at_level):
            # Own-row selection for the nodes living at this level: graph
            # candidates (beam) | batch peers at this level (exact pairs).
            r = torch.from_numpy(at_level).to(dev)
            lv = torch.from_numpy(levels >= lvl).to(dev)
            peer = lv[None, :] & ~eye[r]
            ci = torch.cat([bi, torch.where(peer, ids32[None, :], -1)], dim=1)
            cd = torch.cat([bd, torch.where(peer, pair[r], torch.inf)], dim=1)
            selU[r, lvl - 1] = diversity_prune_chunked(
                q[r], ci, cd, ctx, m=M, metric=metric, kind=kind, q_norm=sub(qn, r),
            )

    # --- level 0: beam + prune (own rows get M links; the capacity M0 is
    # for reverse-edge growth, hnsw.h:874-886) ---
    if has_graph:
        b0d, b0i = beam_search(
            q, ctx, state.links0, None, cur, cur_d, cap,
            ef=efc, metric=metric, kind=kind, q_norm=qn, expand=beam_expand,
        )
    else:
        b0d = torch.full((n, efc), torch.inf, device=dev)
        b0i = torch.full((n, efc), -1, dtype=torch.int32, device=dev)
    ci0 = torch.cat([b0i, torch.where(~eye, ids32[None, :], -1)], dim=1)
    cd0 = torch.cat([b0d, torch.where(~eye, pair, torch.inf)], dim=1)
    sel0_m = diversity_prune_chunked(q, ci0, cd0, ctx, m=M, metric=metric, kind=kind, q_norm=qn)
    sel0 = torch.full((n, M0), -1, dtype=torch.int32, device=dev)
    sel0[:, :M] = sel0_m

    # --- write own rows ---
    state.links0[ids_t] = sel0
    state.nlinks0[ids_t] = (sel0 >= 0).sum(dim=1).to(state.nlinks0.dtype)
    up = np.nonzero(np.asarray(urows) >= 0)[0]
    if len(up):
        ur = torch.from_numpy(np.asarray(urows, dtype=np.int64)[up]).to(dev)
        own = selU[torch.from_numpy(up).to(dev)]
        state.ulinks[ur] = own
        state.unlinks[ur] = (own >= 0).sum(dim=2).to(state.unlinks.dtype)

    # --- reverse edges, level 0 ---
    # Drop pairs whose target is a batch peer that already selected src in
    # its own freshly written row (mutual intra-batch edge).
    base_id = int(ids[0])

    def drop_mutual(dst, src, own_sel):
        in_batch = (dst >= base_id) & (dst < base_id + n)
        row = torch.clamp(dst - base_id, 0, n - 1).long()
        dup = (own_sel[row] == src[:, None]).any(dim=1) & in_batch
        return torch.where(dup, -1, dst)

    dst0 = sel0_m.reshape(-1)
    src0 = ids32.repeat_interleave(M)
    dst0 = drop_mutual(dst0, src0, sel0)
    drop0 = apply_reverse_edges_multi(
        state.links0, state.nlinks0, dst0, dst0, src0, ctx,
        m_cap=M0, a_cap=a_cap, metric=metric, kind=kind, passes=rev_passes,
    )

    # --- reverse edges, upper levels (flattened [ucap*LU, M] view) ---
    ucap = state.ulinks.shape[0]
    uflat = state.ulinks.view(ucap * LU, M)
    unflat = state.unlinks.view(ucap * LU)
    # Pair (i, l): dst = selU[i, l-1, j]; row = upper_row[dst] * LU + (l - 1).
    lvlU = torch.arange(LU, device=dev)[None, :, None].expand(n, LU, M).reshape(-1)
    dstU = selU.reshape(-1)
    srcU = ids32.repeat_interleave(LU * M)
    # Mutual intra-batch dedup per level: own rows at the same level.
    selU_flat = selU.reshape(n * LU, M)
    in_batch = (dstU >= base_id) & (dstU < base_id + n) & (dstU >= 0)
    rowU = torch.clamp(dstU - base_id, 0, n - 1).long() * LU + lvlU
    dupU = (selU_flat[rowU] == srcU[:, None]).any(dim=1) & in_batch
    dstU = torch.where(dupU, -1, dstU)
    target_urow = state.upper_row[torch.clamp(dstU, min=0)].to(torch.int64)
    flat_row = torch.where((dstU >= 0) & (target_urow >= 0), target_urow * LU + lvlU, -1)
    # Upper pairs are sparse: compact to a fixed bucket before the
    # prune-heavy reverse application (the LU*M floor keeps small batches
    # from overflowing it).
    PU = min(max(8 * n, LU * M), flat_row.shape[0])
    order = torch.argsort((flat_row < 0).to(torch.int8), stable=True)[:PU]
    dropU_compact = (flat_row >= 0).sum() - (flat_row[order] >= 0).sum()
    dropU = apply_reverse_edges_multi(
        uflat, unflat, flat_row[order], dstU[order], srcU[order], ctx,
        m_cap=M, a_cap=a_cap, metric=metric, kind=kind, passes=rev_passes,
    )

    # --- entry point / max level (first occurrence of the highest level) ---
    top_row = int(np.argmax(levels))
    top = int(levels[top_row])
    if state.entry < 0 or top > state.max_level:
        state.entry = int(ids[top_row])
    state.max_level = max(state.max_level, top)
    return state, drop0 + dropU + dropU_compact


def build_scan(
    state: GraphState,
    ctx: StoreCtx,
    offsets: np.ndarray,  # [T] first row id of each batch
    levels: np.ndarray,  # [T, n]
    urows: np.ndarray,  # [T, n]
    **kw,
):
    """Insert T consecutive batches (the JAX package's ``lax.scan`` over
    ``connect_batch``, here a host loop with no read between batches).
    Returns (state, dropped [T] device tensor)."""
    n = levels.shape[1]
    dropped = []
    for off, lv, ur in zip(offsets, levels, urows):
        state, d = connect_batch(
            state, ctx, np.arange(off, off + n), lv, ur, **kw
        )
        dropped.append(d)
    return state, torch.stack(dropped)


# ---------------------------------------------------------------------------
# Vamana (SVS): single-level connect with alpha pruning
# ---------------------------------------------------------------------------


@dataclass
class VamanaState:
    """Device Vamana graph tensors threaded through construction; the
    medoid entry is a host int."""

    links: torch.Tensor  # [cap, R] int32, -1 padded
    nlinks: torch.Tensor  # [cap] int32
    entry: int  # medoid vector id (-1: empty graph)


def vamana_connect(
    state: VamanaState,
    ctx: StoreCtx,
    ids: np.ndarray,  # [n] int new-node row ids (contiguous ascending)
    *,
    L: int,  # construction window (beam ef)
    deg: int,  # graph_max_degree R
    metric: VecSimMetric,
    kind: str,
    alpha: float = 1.0,
    a_cap: int = 16,
    rev_passes: int = 2,
    beam_expand: int = 4,
):
    """Insert one batch of already-stored rows into a Vamana graph: a
    candidate beam from the medoid entry, the intra-batch pair distances,
    the robust-alpha prune (DiskANN's rule, which also reaches every
    overflowing reverse-edge row) and the sort-segment reverse edges.

    The entry stays fixed during the batch (the caller refreshes the medoid
    between batches); an empty graph adopts ``ids[0]``, and its first batch
    connects through the pair distances alone. Updates ``state`` in place
    and returns it with the dropped reverse-edge count (a device scalar)."""
    metric = VecSimMetric(metric)
    dev = state.links.device
    ids = np.asarray(ids, dtype=np.int64)
    n = len(ids)
    cap = state.links.shape[0]
    ids_t = torch.from_numpy(ids).to(dev)
    ids32 = ids_t.to(torch.int32)
    q, qn, qm = anchor_queries(ctx, ids_t, kind, metric)

    if state.entry >= 0:
        e = torch.full((n,), state.entry, dtype=torch.int32, device=dev)
        ed = dists_to_ids(q, e[:, None], ctx, metric=metric, kind=kind, q_norm=qn,
                          q_meta=qm)[:, 0]
        bd, bi = beam_search(
            q, ctx, state.links, None, e, ed, cap,
            ef=L, metric=metric, kind=kind, q_norm=qn, q_meta=qm, expand=beam_expand,
        )
    else:
        bd = torch.full((n, L), torch.inf, device=dev)
        bi = torch.full((n, L), -1, dtype=torch.int32, device=dev)

    eye = torch.eye(n, dtype=torch.bool, device=dev)
    if n > 1:
        pair = dists_to_ids(q, ids32[None, :].expand(n, n), ctx, metric=metric, kind=kind,
                            q_norm=qn, q_meta=qm)
        pair = torch.where(eye, torch.inf, pair)
    else:
        pair = torch.full((1, 1), torch.inf, device=dev)
    ci = torch.cat([bi, torch.where(~eye, ids32[None, :], -1)], dim=1)
    cd = torch.cat([bd, torch.where(~eye, pair, torch.inf)], dim=1)
    sel = diversity_prune_chunked(
        q, ci, cd, ctx, m=deg, metric=metric, kind=kind, alpha=alpha, q_norm=qn,
    )
    state.links[ids_t] = sel.to(state.links.dtype)
    state.nlinks[ids_t] = (sel >= 0).sum(dim=1).to(state.nlinks.dtype)

    # Reverse edges; pairs already mutual inside the batch are dropped.
    base_id = int(ids[0])
    dst = sel.reshape(-1)
    src = ids32.repeat_interleave(deg)
    in_batch = (dst >= base_id) & (dst < base_id + n)
    row = torch.clamp(dst - base_id, 0, n - 1).long()
    dup = (sel[row] == src[:, None]).any(dim=1) & in_batch
    dst = torch.where(dup, -1, dst)
    dropped = apply_reverse_edges_multi(
        state.links, state.nlinks, dst, dst, src, ctx,
        m_cap=deg, a_cap=a_cap, metric=metric, kind=kind, alpha=alpha, passes=rev_passes,
    )
    if state.entry < 0:
        state.entry = base_id
    return state, dropped


def vamana_build_scan(
    state: VamanaState,
    ctx: StoreCtx,
    offsets: np.ndarray,  # [T] first row id of each batch
    *,
    n: int,  # rows per batch
    **kw,
):
    """Insert T consecutive Vamana batches (the JAX package's ``lax.scan``
    over ``vamana_connect``, here a host loop with no read between
    batches). Returns (state, dropped [T] device tensor)."""
    dropped = []
    for off in offsets:
        state, d = vamana_connect(state, ctx, np.arange(off, off + n), **kw)
        dropped.append(d)
    return state, torch.stack(dropped)
