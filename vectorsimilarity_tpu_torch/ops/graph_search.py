"""Graph-search loops on the device: batched greedy descent, ef-beam search
and diversity pruning.

Counterpart of ``vectorsimilarity_tpu/ops/graph_search.py`` (the reference's
``greedySearchLevel``, ``searchLayer`` and ``getNeighborsByHeuristic2``,
``algorithms/hnsw/hnsw.h:1192``, ``:664-703``, ``:725-779``), for the
``float``, ``int``, ``sq8`` and ``sq4`` store kinds (the last two are SVS's
quantized stores, scored asymmetrically with the query metadata ``q_meta``).
The loop bodies are the JAX package's, step for step; what changes is how a
loop runs:

- A ``lax.while_loop`` runs on the device until its condition reads false.
  Here the host drives the body over the whole batch: it launches up to
  ``config.timeout_poll_iters`` iterations, then reads whether every row is
  done (one device-to-host read, counted in ``host_reads``). A done row's
  state does not change in later iterations (every update is masked by
  it), so running a row on after it finished gives the same result as the
  JAX loop, which stops only when every row is done. The beam never runs
  more than the JAX cap of iterations.
- On a CUDA device, a chunk of iterations between two reads is replayed as
  one captured CUDA graph (``_ChunkGraphs``) once its key, everything the
  chunk's kernels read in place, has been seen in an earlier call; the
  first sighting runs eagerly, so one-off shapes never pay a capture. The
  replayed kernels are the eager ones in the same order, so the results
  are bit for bit the eager path's; the read between chunks stays on the
  host.
- The ``fori_loop`` of the diversity prune has a fixed trip count: a host
  loop of launches, with no read.

Ties: the beam merge is a stable sort on distance (beam entries stay ahead
of equal new candidates, as ``lax.sort(is_stable=True)`` keeps them), the
rerank a (distance, id) order made of two stable sorts, and argmin takes the
first minimum, as ``jnp.argmin`` does.

The visited set is a bitmap of ``int32`` words (the JAX package's are
``uint32``): bit 31 is the sign bit, and bits are set by ``scatter_add_``,
which equals an OR because a row's neighbour ids are distinct and set bits
are masked out before the add. Writes that the JAX package drops with
``mode="drop"`` add 0 here, or go to a scratch row that is thrown away.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import NamedTuple, Optional

import torch

from .. import config
from ..types import VecSimMetric
from .quantize import unpack4

# Device-to-host reads made by the graph loops to learn which rows are done
# (one per poll), and loop iterations launched, since the last reset; the
# benchmark scripts read and reset them.
host_reads = 0
iterations = 0
# Chunks captured as CUDA graphs, and loop iterations run inside replays.
graph_captures = 0
graph_replay_iters = 0

_INT_MAX = 2**31 - 1


class StoreCtx(NamedTuple):
    """Device score context: data plus optional per-row extras.

    kind="float": data [N, D] float; sqnorm [N] (L2 only, else None)
    kind="int":   data [N, D] int8/uint8; sqnorm [N] f32 (L2), norm [N] f32
                  (Cosine), else None
    kind="sq8":   data [N, D] uint8 codes; vmin / delta [N] f32 scales;
                  sqnorm [N] = sum x^2 (L2). Queries stay float and carry
                  (sum y, sum y^2) as ``q_meta`` (asymmetric distance,
                  spaces/IP/IP.cpp:35-71)
    kind="sq4":   data [N, ceil(D/2)] split-packed 4-bit codes
                  (``ops.quantize.pack4``); otherwise as sq8

    ``nav`` is an optional bf16 shadow of ``data`` (fp32 stores only): graph
    NAVIGATION gathers read it instead of the fp32 rows, half the bytes; the
    ~1e-3 relative distance error only perturbs candidate ordering, and the
    exact paths (``exact_rerank``, the prune's anchor leg) rescore in fp32.
    """

    data: torch.Tensor
    sqnorm: Optional[torch.Tensor] = None
    norm: Optional[torch.Tensor] = None
    vmin: Optional[torch.Tensor] = None
    delta: Optional[torch.Tensor] = None
    nav: Optional[torch.Tensor] = None


def _bdot(q: torch.Tensor, vecs: torch.Tensor, acc: torch.dtype) -> torch.Tensor:
    """<q[b], vecs[b, m]> as [B, M] in ``acc``: one batched matmul."""
    return torch.bmm(vecs.to(acc), q.to(acc).unsqueeze(-1)).squeeze(-1)


def gathered_dists(
    q: torch.Tensor,
    ids: torch.Tensor,
    ctx: StoreCtx,
    metric: VecSimMetric,
    kind: str,
    q_norm: Optional[torch.Tensor] = None,
    q_meta: Optional[tuple] = None,
) -> torch.Tensor:
    """Distances from per-query vectors to gathered rows.

    q: [B, D]; ids: [B, M] (valid row indices; mask afterwards). Returns
    [B, M] f32, with the algebra of ``ops.distances`` so beam scores match
    full-scan scores. Integer products are exact (an fp64 product of
    integers below 2^53). ``q_meta`` = (sum y [B], sum y^2 [B]) for the
    quantized kinds."""
    metric = VecSimMetric(metric)
    if ctx.nav is not None and kind == "float":
        vecs = ctx.nav[ids]  # [B, M, D] bf16 shadow
        ip = _bdot(q.to(vecs.dtype), vecs, torch.float32)
        if metric in (VecSimMetric.IP, VecSimMetric.Cosine):
            return 1.0 - ip
        qf = q.float()
        qsq = torch.sum(qf * qf, dim=-1)
        return qsq[:, None] - 2.0 * ip + ctx.sqnorm[ids]
    vecs = ctx.data[ids]  # [B, M, D]
    if kind in ("sq8", "sq4"):
        if kind == "sq4":
            vecs = unpack4(vecs)  # [B, M, 2H] codes in [0, 15]
            if q.shape[-1] != vecs.shape[-1]:  # odd dim: zero-pad the query
                q = torch.cat([q, q.new_zeros((q.shape[0], vecs.shape[-1] - q.shape[-1]))], 1)
        ysum, ysumsq = q_meta
        qdot = _bdot(q, vecs, torch.float32)
        ip = ctx.vmin[ids] * ysum[:, None] + ctx.delta[ids] * qdot
        if metric in (VecSimMetric.IP, VecSimMetric.Cosine):
            return 1.0 - ip
        return ctx.sqnorm[ids] - 2.0 * ip + ysumsq[:, None]
    if kind == "int":
        ip = _bdot(q, vecs, torch.float64).to(torch.float32)
        if metric == VecSimMetric.IP:
            return 1.0 - ip
        if metric == VecSimMetric.Cosine:
            return 1.0 - ip / (ctx.norm[ids] * q_norm[:, None])
        qi = q.to(torch.int64)
        qsq = torch.sum(qi * qi, dim=-1).to(torch.float32)
        return qsq[:, None] - 2.0 * ip + ctx.sqnorm[ids]
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    ip = _bdot(q, vecs, acc)
    if metric in (VecSimMetric.IP, VecSimMetric.Cosine):
        return (1.0 - ip).to(torch.float32)
    qa = q.to(acc)
    qsq = torch.sum(qa * qa, dim=-1)
    return (qsq[:, None] - 2.0 * ip + ctx.sqnorm[ids]).to(torch.float32)


def _neighbor_gather(links: torch.Tensor, row_of: Optional[torch.Tensor], level):
    """Neighbour-row gather for 2-D ([rows, M]) or 3-D ([rows, L, M] with
    ``level``: level l >= 1 lives at index l - 1) link arrays. A row id of
    -1 reads the last row, as ``jnp.take`` wraps it."""

    def nbrs_of(ids):
        rows = ids if row_of is None else row_of[ids]
        if links.dim() == 3:
            return links[rows, level - 1]
        return links[rows]

    return nbrs_of


def _meta(meta) -> Optional[tuple]:
    """``q_meta`` from its two entries of a loop's inputs (None, None: none)."""
    return None if meta[0] is None else tuple(meta)


def _all_set(flags: torch.Tensor) -> bool:
    """One device-to-host read: whether every row's flag is set."""
    global host_reads
    host_reads += 1
    return bool(flags.all())


def _chunks(first: int):
    """Iterations between two reads: ``first``, doubling up to
    ``config.timeout_poll_iters``."""
    poll = max(config.timeout_poll_iters, 1)
    n = min(first, poll)
    while True:
        yield n
        n = min(2 * n, poll)


# ---------------------------------------------------------------------------
# Chunks of iterations replayed as CUDA graphs
# ---------------------------------------------------------------------------


def _ident(t: Optional[torch.Tensor]):
    """What a captured kernel holds of a tensor it reads in place."""
    return None if t is None else (t.data_ptr(), tuple(t.shape), t.stride(), t.dtype)


def _form(t: Optional[torch.Tensor]):
    return None if t is None else (tuple(t.shape), t.dtype)


def chunk_key(loop: str, params: tuple, args: tuple, state: tuple, held: tuple) -> tuple:
    """The key of a loop's chunks, without their length: the loop's name and
    parameters, the device, the shapes and dtypes of the per-call inputs
    ``args`` (copied into a graph's buffers) and of the loop ``state``, the
    identity of each tensor in ``held`` (read in place by the captured
    kernels: the links, ``row_of``, the store context) and the fp32 matmul
    precision that the captured products were planned under."""
    return (loop, params, state[0].device, tuple(_form(a) for a in args),
            tuple(_form(t) for t in state), tuple(_ident(t) for t in held),
            torch.get_float32_matmul_precision())


def _run_steps(step, args: tuple, state: tuple, steps: int) -> tuple:
    for _ in range(steps):
        state = step(args, state)
    return state


class _Graph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    args: tuple  # the buffers a replay copies the call's inputs into
    state: tuple  # ... and the loop state into
    out: tuple  # the state after the chunk, in the graph's pool
    held: tuple  # the tensors read in place, kept alive with the graph


class _ChunkGraphs:
    """CUDA graphs of loop chunks by key, least recently used first out.

    ``run`` replays a chunk whose key was seen in an earlier call (a key
    holds the chunk's length), capturing it at that second sighting; the
    first sighting, every sighting within one call, and every chunk off a
    CUDA device run eagerly. A captured graph keeps its buffers, a private
    pool of one iteration's intermediates, and references to the tensors it
    reads in place, so no address it reads is reused while it lives;
    evicting it frees the pool. One lock orders captures and replays: a
    replay's copies in, launch and copy out are enqueued together."""

    def __init__(self, slots: int, seen_slots: int):
        self.slots, self.seen_slots = slots, seen_slots
        self.graphs: OrderedDict = OrderedDict()
        self.seen: OrderedDict = OrderedDict()  # key -> the call that last ran it eagerly
        self.streams: dict = {}  # device -> capture stream
        self.lock = threading.Lock()

    def run(self, key, step, args: tuple, state: tuple, steps: int, held: tuple, call) -> tuple:
        """``steps`` calls of ``step(args, state)`` from ``state``; returns
        the new state. ``call`` is a token of the calling loop."""
        global graph_captures, graph_replay_iters
        if state[0].device.type != "cuda":
            return _run_steps(step, args, state, steps)
        with self.lock:
            g = self.graphs.get(key)
            if g is not None:
                self.graphs.move_to_end(key)
            elif self.seen.get(key, call) is not call:
                g = self._capture(key, step, args, state, steps, held)
                graph_captures += 1
            else:
                self.seen[key] = call
                self.seen.move_to_end(key)
                if len(self.seen) > self.seen_slots:
                    self.seen.popitem(last=False)
            if g is not None:
                with torch.cuda.device(state[0].device):
                    for buf, a in zip(g.args + g.state, args + state):
                        if buf is not None:
                            buf.copy_(a)
                    g.graph.replay()
                    out = tuple(t.clone() for t in g.out)
                graph_replay_iters += steps
                return out
        return _run_steps(step, args, state, steps)

    def _capture(self, key, step, args, state, steps, held) -> _Graph:
        dev = state[0].device
        with torch.cuda.device(dev):
            s_args = tuple(None if a is None else a.clone() for a in args)
            s_state = tuple(t.clone() for t in state)
            stream = self.streams.get(dev)
            if stream is None:
                stream = self.streams[dev] = torch.cuda.Stream(dev)
            # A warm-up step on the capture stream, so that what the kernels
            # set up at first use on a stream (the matmul workspace) is not
            # made inside the graph's pool.
            stream.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(stream):
                step(s_args, s_state)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
                out = _run_steps(step, s_args, s_state, steps)
            torch.cuda.current_stream(dev).wait_stream(stream)
        g = self.graphs[key] = _Graph(graph, s_args, s_state, out, held)
        if len(self.graphs) > self.slots:
            self.graphs.popitem(last=False)
        return g


# An HNSW search's chunks (the greedy descent's 4, 8, ... per upper level,
# and the beam's) take ~8 graphs; an HNSW build's, whose upper levels run
# over row counts that recur from batch to batch, ~150 at 100k x 768. 64
# slots hold the search's and the build's most used: at 16 the build
# evicted what it would reuse, capturing 440 chunks at ~30 ms each on an
# H100 (148 at 64).
_GRAPHS = _ChunkGraphs(slots=64, seen_slots=256)


# ---------------------------------------------------------------------------
# Greedy descent (one level)
# ---------------------------------------------------------------------------


def greedy_level(
    q: torch.Tensor,
    ctx: StoreCtx,
    links: torch.Tensor,  # [rows, M] or [rows, L, M] neighbour vector ids, -1 padded
    row_of: Optional[torch.Tensor],  # [cap] vector id -> row in ``links`` (None: identity)
    cur: torch.Tensor,  # [B] current vector ids
    cur_d: torch.Tensor,  # [B] their distances
    level: Optional[int] = None,  # level of 3-D links
    active: Optional[torch.Tensor] = None,  # [B] bool: queries to advance
    *,
    metric: VecSimMetric,
    kind: str,
    q_norm: Optional[torch.Tensor] = None,
    q_meta: Optional[tuple] = None,
):
    """Batched greedy hill-descent on one level until no query improves.
    Returns new (cur, cur_d); the inputs are not modified. The first read
    comes after 4 iterations, the next after 8, and so on up to
    ``config.timeout_poll_iters`` (a descent takes a few hops)."""
    global iterations
    B = q.shape[0]
    metric = VecSimMetric(metric)
    nbrs_of = _neighbor_gather(links, row_of, level)
    imp = torch.ones((B,), dtype=torch.bool, device=q.device) if active is None else active

    def step(args, state):
        q, q_norm, *meta = args
        imp, c, cd = state
        nbrs = nbrs_of(torch.where(imp, c, 0))  # [B, M]
        valid = (nbrs >= 0) & imp[:, None]
        safe = torch.where(valid, nbrs, 0)
        nd = gathered_dists(q, safe, ctx, metric, kind, q_norm, _meta(meta))
        nd = torch.where(valid, nd, torch.inf)
        j = torch.argmin(nd, dim=1, keepdim=True)
        best_d = nd.gather(1, j)[:, 0]
        best_i = safe.gather(1, j)[:, 0]
        imp = best_d < cd
        return imp, torch.where(imp, best_i, c), torch.where(imp, best_d, cd)

    args = (q, q_norm) + (q_meta or (None, None))
    state = (imp, cur, cur_d)
    held = (links, row_of) + tuple(ctx)
    key = chunk_key("greedy", (metric, kind, level), args, state, held)
    call = object()
    for steps in _chunks(4):
        if _all_set(~state[0]):
            break
        state = _GRAPHS.run(key + (steps,), step, args, state, steps, held, call)
        iterations += steps
    return state[1], state[2]


# ---------------------------------------------------------------------------
# Beam search (searchLayer)
# ---------------------------------------------------------------------------


def beam_search(
    q: torch.Tensor,  # [B, D]
    ctx: StoreCtx,
    links: torch.Tensor,  # [rows, M] or [rows, L, M]
    row_of: Optional[torch.Tensor],  # [cap] or None
    entry_ids: torch.Tensor,  # [B] entry vector ids
    entry_dists: torch.Tensor,  # [B]
    visited_cap: int,
    level: Optional[int] = None,  # level of 3-D links
    active: Optional[torch.Tensor] = None,  # [B] bool: rows to search (None: all)
    *,
    ef: int,
    metric: VecSimMetric,
    kind: str,
    q_norm: Optional[torch.Tensor] = None,
    q_meta: Optional[tuple] = None,
    max_iters: int = 0,
    expand: int = 1,
    init_state: Optional[tuple] = None,
    return_state: bool = False,
    iter_budget: Optional[int] = None,
):
    """Best-first ef-beam search from per-query entry points.

    Returns (beam_d [B, ef], beam_i [B, ef]) sorted ascending; empty slots
    have d = +inf, id = -1. ``expand=1`` is step-for-step ``searchLayer``;
    ``expand=E`` pops the E best unexpanded candidates per iteration, all
    within the result window. Inactive rows (``active=False``) return empty
    beams.

    ``init_state`` / ``return_state`` make the search resumable: the state
    is ``(beam_d [B, W'], beam_i, beam_e, visited)`` of an earlier call
    (possibly at a smaller ef), and resuming continues expansion with the
    carried visited bitmap. ``iter_budget`` caps this call's iterations
    below ``max_iters``. With ``return_state`` the result is
    ``(beam_d, beam_i, state, completed, iterations)``, ``completed`` False
    iff the cap stopped the loop before every row converged.
    """
    global iterations
    B = q.shape[0]
    dev = q.device
    if not max_iters:
        max_iters = max((config.beam_iter_factor * ef + config.beam_iter_base) // expand, 64)
    nbrs_of = _neighbor_gather(links, row_of, level)
    # Working width: the reference's candidate heap keeps nodes that fall out
    # of the ef-sized result heap and can still be expanded; the extra slots
    # emulate that candidate memory.
    W = ef + max(min(ef, 128), 16)
    W32 = (visited_cap + 31) // 32

    active_rows = torch.ones((B,), dtype=torch.bool, device=dev) if active is None else active
    if init_state is not None:
        beam_d, beam_i, beam_e, visited = (t.clone() for t in init_state)
        w0 = beam_d.shape[1]
        if w0 < W:
            pad = W - w0
            beam_d = torch.cat([beam_d, beam_d.new_full((B, pad), torch.inf)], 1)
            beam_i = torch.cat([beam_i, beam_i.new_full((B, pad), -1)], 1)
            beam_e = torch.cat([beam_e, beam_e.new_zeros((B, pad))], 1)
        elif w0 > W:
            beam_d, beam_i, beam_e = beam_d[:, :W], beam_i[:, :W], beam_e[:, :W]
    else:
        entry_ids = torch.where(active_rows, entry_ids.to(torch.int32), -1)
        beam_d = torch.full((B, W), torch.inf, dtype=torch.float32, device=dev)
        beam_i = torch.full((B, W), -1, dtype=torch.int32, device=dev)
        beam_e = torch.zeros((B, W), dtype=torch.bool, device=dev)
        beam_d[:, 0] = torch.where(active_rows, entry_dists.to(torch.float32), torch.inf)
        beam_i[:, 0] = entry_ids
        # Visited set as a bitmap ([B, cap/32] int32 words, 1 bit per node).
        visited = torch.zeros((B, W32), dtype=torch.int32, device=dev)
        has = entry_ids >= 0
        safe = torch.where(has, entry_ids, 0)
        bit = torch.where(has, torch.ones_like(safe) << (safe & 31), 0)
        visited.scatter_add_(1, (safe >> 5).long()[:, None], bit[:, None])
    done = ~active_rows
    cap_iters = max_iters if iter_budget is None else min(max_iters, int(iter_budget))

    E = expand
    C = E * links.shape[-1]  # new-candidate block width per iteration
    metric = VecSimMetric(metric)

    def body(args, state):
        q, q_norm, *meta, iw = args
        beam_d, beam_i, beam_e, visited, done, *count = state
        if count:  # iterations in which some row was still searching
            count = [count[0] + (~done).any()]
        # The E best unexpanded candidates: the beam is sorted, so they are
        # the first E unexpanded slots.
        unexp = (~beam_e) & (beam_i >= 0)
        u = unexp.to(torch.int32)
        rank = torch.cumsum(u, dim=1) - u
        pos_l, d_l = [], []
        for e in range(E):
            sel = unexp & (rank == e)
            p = torch.where(sel, iw, 0).sum(dim=1)
            pos_l.append(p)
            d_l.append(torch.where(sel.any(dim=1), beam_d.gather(1, p[:, None])[:, 0], torch.inf))
        pos = torch.stack(pos_l, dim=1)  # [B, E]
        cur_d = torch.stack(d_l, dim=1)
        worst = beam_d[:, ef - 1]  # worst of the RESULT window
        # Stop when no unexpanded candidate is left, or the best one cannot
        # improve a full window (searchLayer's termination).
        newly_done = (cur_d[:, 0] == torch.inf) | (cur_d[:, 0] > worst)
        done = done | newly_done
        # Secondary pops only while they can still improve the window.
        exp_ok = (~done)[:, None] & (cur_d < torch.inf) & (cur_d <= worst[:, None])
        cur_i = beam_i.gather(1, pos)  # [B, E]
        beam_e = beam_e | ((iw == pos[:, :, None]) & exp_ok[:, :, None]).any(dim=1)
        # One neighbour round per pop, so a node reached by two pops of one
        # iteration is deduplicated by the visited re-check between rounds.
        blocks = []
        for e in range(E):
            ok = exp_ok[:, e]
            nbrs = nbrs_of(torch.where(ok, cur_i[:, e], 0))  # [B, M]
            valid = (nbrs >= 0) & ok[:, None]
            safe = torch.where(valid, nbrs, 0)
            word = (safe >> 5).long()
            shift = safe & 31
            seen = ((visited.gather(1, word) >> shift) & 1) != 0
            valid = valid & ~seen
            visited = visited.scatter_add(1, word, torch.where(valid, 1 << shift, 0))
            blocks.append(torch.where(valid, safe, -1))
        new_i = torch.cat(blocks, dim=1) if E > 1 else blocks[0]
        nd = gathered_dists(q, new_i.clamp(min=0), ctx, metric, kind, q_norm, _meta(meta))
        nd = torch.where(new_i >= 0, nd, torch.inf)
        # Merge: one stable sort on distance keeps beam entries ahead of equal
        # new candidates (searchLayer's tie behaviour).
        all_d = torch.cat([beam_d, nd], dim=1)
        out_d, order = torch.sort(all_d, dim=1, stable=True)
        order = order[:, :W]
        out_i = torch.cat([beam_i, new_i], dim=1).gather(1, order)
        out_e = torch.cat([beam_e, beam_e.new_zeros((B, C))], dim=1).gather(1, order)
        return (out_d[:, :W], out_i, out_e, visited, done, *count)

    args = (q, q_norm) + (q_meta or (None, None)) + (torch.arange(W, device=dev),)
    state = (beam_d, beam_i, beam_e, visited, done)
    if return_state:
        state += (torch.zeros((), dtype=torch.int64, device=dev),)
    held = (links, row_of) + tuple(ctx)
    key = chunk_key("beam", (ef, W, E, metric, kind, level), args, state, held)
    call = object()
    poll = max(config.timeout_poll_iters, 1)
    it = 0
    completed = False
    while True:
        if _all_set(state[4]):
            completed = True
            break
        if it >= cap_iters:
            break
        steps = min(poll, cap_iters - it)
        state = _GRAPHS.run(key + (steps,), body, args, state, steps, held, call)
        it += steps
        iterations += steps
    beam_d, beam_i, beam_e, visited, done, *count = state
    if return_state:
        return beam_d[:, :ef], beam_i[:, :ef], (beam_d, beam_i, beam_e, visited), completed, count[0]
    return beam_d[:, :ef], beam_i[:, :ef]


# ---------------------------------------------------------------------------
# Diversity pruning (getNeighborsByHeuristic2)
# ---------------------------------------------------------------------------


def diversity_prune(
    q: torch.Tensor,  # [B, D] target vectors (new node / repaired node)
    cand_ids: torch.Tensor,  # [B, C] candidate vector ids, -1 padded
    cand_dists: torch.Tensor,  # [B, C] distances to q, +inf for padded
    ctx: StoreCtx,
    *,
    m: int,
    metric: VecSimMetric,
    kind: str,
    alpha: float = 1.0,
    q_norm: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Select up to m diverse neighbours per row; returns ids [B, m] (-1 pad).

    The reference's greedy rule (hnsw.h:725-779): scan candidates in
    ascending distance-to-q order; keep c unless some already-kept k has
    alpha * dist(c, k) < dist(c, q). The scan runs over the best
    min(C, max(8m, 64)) candidates; candidate-candidate distances are one
    batched [B, c, c] product, and the keep scan is a fixed loop of masked
    column steps (the JAX ``fori_loop``), launched with no host read.
    """
    B, C = cand_ids.shape
    c_eff = min(C, max(8 * m, 64))
    order = torch.argsort(cand_dists, dim=1, stable=True)[:, :c_eff]
    s_ids = cand_ids.gather(1, order)
    s_d = cand_dists.gather(1, order)
    valid = (s_ids >= 0) & torch.isfinite(s_d)
    safe = torch.where(valid, s_ids, 0)
    metric_v = VecSimMetric(metric)

    v = ctx.data[safe]  # [B, c_eff, D]
    if kind in ("sq8", "sq4"):
        if kind == "sq4":
            v = unpack4(v)
        v = ctx.vmin[safe][:, :, None] + ctx.delta[safe][:, :, None] * v.to(torch.float32)
    else:
        v = v.to(torch.float32)
    if kind == "float" and ctx.nav is not None:
        # Caller distances may come from the bf16 shadow; recompute the
        # anchor->candidate leg exactly from the gathered fp32 rows so the
        # greedy compare is precision-consistent with the fp32 pair matrix
        # (candidate ORDER keeps the caller's ranking).
        qf = q.to(torch.float32)
        ipq = _bdot(qf, v, torch.float32)
        if metric_v == VecSimMetric.L2:
            s_d = torch.sum(qf * qf, dim=-1)[:, None] - 2.0 * ipq + torch.sum(v * v, dim=-1)
        else:
            s_d = 1.0 - ipq
        s_d = torch.where(valid, s_d, torch.inf)
    ip = torch.bmm(v, v.transpose(1, 2))
    if metric_v == VecSimMetric.L2:
        aux = torch.sum(v * v, dim=-1)  # [B, c_eff] |v|^2
        pd = aux[:, :, None] - 2.0 * ip + aux[:, None, :]
    elif kind == "int" and metric_v == VecSimMetric.Cosine:
        norms = ctx.norm[safe]
        pd = 1.0 - ip / (norms[:, :, None] * norms[:, None, :])
    else:
        pd = 1.0 - ip

    kept = torch.zeros((B, c_eff), dtype=torch.bool, device=q.device)
    count = torch.zeros((B,), dtype=torch.int32, device=q.device)
    for c in range(c_eff):
        viol = ((alpha * pd[:, c] < s_d[:, c, None]) & kept).any(dim=-1)
        take = valid[:, c] & ~viol & (count < m)
        kept[:, c] = take
        count += take.to(torch.int32)
    # Compact kept ids to the front, pad with -1.
    key = torch.where(kept, s_d, torch.inf)
    sel = torch.argsort(key, dim=1, stable=True)[:, :m]
    out = torch.where(kept, s_ids, -1).gather(1, sel)
    if out.shape[1] < m:
        out = torch.cat([out, out.new_full((B, m - out.shape[1]), -1)], dim=1)
    return out


# Working set (candidate rows and pair matrix) of one diversity-prune chunk.
_PRUNE_CHUNK_BYTES = 1 << 30


def diversity_prune_chunked(
    q, cand_ids, cand_dists, ctx, *, m, metric, kind, alpha=1.0, q_norm=None,
    q_meta=None, chunk_rows: Optional[int] = None,
):
    """``diversity_prune`` over many rows, ``chunk_rows`` at a time (by
    default as many as ``_PRUNE_CHUNK_BYTES`` of working set holds, at
    least 128): the prune holds each row's candidate vectors and pair
    matrix, GBs at reverse-edge scale. Rows are independent, so the chunks
    give the unchunked result.

    ``cand_dists=None`` computes the anchor->candidate distances inside each
    chunk (``dists_to_ids``, with ``q_meta`` for the quantized kinds), so
    the [rows, C, D] gather behind them is chunked too."""
    B = q.shape[0]
    c_eff = min(cand_ids.shape[1], max(8 * m, 64))
    D = ctx.data.shape[-1] * (2 if kind == "sq4" else 1)
    C = cand_ids.shape[1] if cand_dists is None else 0
    per_row = 4 * c_eff * (2 * D + c_eff) + 4 * C * D
    chunk = chunk_rows or max(_PRUNE_CHUNK_BYTES // max(per_row, 1), 128)
    parts = []
    for s in range(0, B, chunk):
        sl = slice(s, s + chunk)
        qc, ci = q[sl], cand_ids[sl]
        qnc = None if q_norm is None else q_norm[sl]
        qmc = None if q_meta is None else tuple(x[sl] for x in q_meta)
        cd = (
            dists_to_ids(qc, ci, ctx, metric=metric, kind=kind, q_norm=qnc, q_meta=qmc)
            if cand_dists is None else cand_dists[sl]
        )
        parts.append(diversity_prune(
            qc, ci, cd, ctx, m=m, metric=metric, kind=kind, alpha=alpha, q_norm=qnc,
        ))
    if not parts:
        return cand_ids.new_full((0, m), -1)
    return torch.cat(parts) if len(parts) > 1 else parts[0]


def dists_to_ids(q, ids, ctx: StoreCtx, *, metric, kind, q_norm=None,
                 q_meta=None) -> torch.Tensor:
    """Masked distances from q[b] to ids[b, :] (-1 -> +inf)."""
    valid = ids >= 0
    safe = torch.where(valid, ids, 0)
    d = gathered_dists(q, safe, ctx, metric, kind, q_norm, q_meta)
    return torch.where(valid, d, torch.inf)


def lex_sort(d: torch.Tensor, ids: torch.Tensor):
    """Rows of (d, ids) in (distance, id) order, id -1 behind every id at an
    equal distance: two stable sorts, the minor key first."""
    key = torch.where(ids >= 0, ids, _INT_MAX)
    o1 = torch.argsort(key, dim=1, stable=True)
    d1, i1 = d.gather(1, o1), ids.gather(1, o1)
    o2 = torch.argsort(d1, dim=1, stable=True)
    return d1.gather(1, o2), i1.gather(1, o2)


def exact_rerank(q, ids, ctx: StoreCtx, *, metric, kind, q_norm=None, q_meta=None):
    """Re-score a result window exactly and re-sort by (distance, id).

    Traversal may rank candidates with the bf16 shadow
    (``config.search_nav_bf16``); this recomputes the returned rows'
    distances against the exact store (shadow stripped) and orders them
    lexicographically, so callers always see exact fp32 scores. Padded slots
    (id -1, d = +inf) sort last."""
    ctx = ctx._replace(nav=None)
    d = dists_to_ids(q, ids, ctx, metric=metric, kind=kind, q_norm=q_norm, q_meta=q_meta)
    return lex_sort(d, ids)
