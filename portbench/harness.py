"""One run of one cell: set-up, the window, the judgement, the metrics.

``run_cell`` is the whole run but the look for a card, so tests drive it on
the CPU through the port's plain versions at a tiny size. Its steps:

1. Set-up: the cell's rows, query pool and labels from the seed
   (``gen.make_data``, on the device), the index built by the
   configuration's set-up module, and warm-up requests through the same
   closed loop, which load the kernels (building them at the checkout's
   first run) and touch every shape the window uses.
2. The window: ``traffic["clients"]`` closed-loop clients for ``seconds``,
   with ``trace`` under ``torch.profiler``. The program counters that the
   cell's readers name are read before and after it. A traced run whose
   readers include one marked ``WINDOW = "untraced"`` (a host-clock reading,
   which the profiler's activity records would slow) first runs an
   untraced window of the same length for it.
3. The peak device memory is read, the program's state freed, and the
   float64 reference judges every kept reply of both windows (``judge``).
4. Each metric's reader turns the run into its number.
"""

from __future__ import annotations

import gc
import time
from types import SimpleNamespace

import numpy as np
import torch

from . import cells, gen, judge
from .trace import Trace, profiler
from .window import ClosedLoop

FORBIDDEN = ("jax", "jaxlib", "flax", "vectorsimilarity_tpu")


def forbidden_modules(modules) -> list[str]:
    """Top-level names among ``modules`` that the benchmark may not load,
    compared whole: ``vectorsimilarity_tpu_torch`` is not
    ``vectorsimilarity_tpu``."""
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def set_up(cell: dict, seed: int, device):
    """The cell's inputs from ``seed`` and its index, built by the
    configuration's set-up module: a namespace of ``rows`` and ``queries``
    (numpy, in the configuration's type, as made), ``labels``, ``index``,
    ``setup`` (the module) and ``built`` (the build's figures)."""
    cfg = cell["config"]
    data = gen.make_data(cfg, cell["traffic"], seed, device)
    rows, queries = data["rows"].cpu().numpy(), data["queries"].cpu().numpy()
    setup = cells.load_setup(cfg["setup"])
    index, built = setup.build(cfg, rows, data["rows"], data["labels"], device)
    labels = data["labels"]
    del data
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return SimpleNamespace(rows=rows, queries=queries, labels=labels, index=index,
                           setup=setup, built=built)


def client_loop(index, queries: np.ndarray, traffic: dict, setup) -> ClosedLoop:
    """The traffic's closed loop over ``index``: request p is one
    ``topk_query_batch`` of pool batch p."""
    if traffic["loop"] != "closed":
        raise ValueError(f"no generator for a {traffic['loop']!r} loop")
    B, k = int(traffic["batch"]), int(traffic["k"])
    params = setup.query_params(traffic)

    def request(pool: int):
        return index.topk_query_batch(queries[pool * B : (pool + 1) * B], k, params)

    return ClosedLoop(request, traffic["clients"], traffic["pool_batches"])


def judged(traffic: dict, seed: int):
    """keep(i): whether request i's replies are kept and judged. Every
    request's, or a share (``judged_share`` of the traffic) drawn from the
    seed."""
    share = float(traffic.get("judged_share", 1.0))
    if share >= 1.0:
        return lambda i: True
    draw = np.random.default_rng(seed).random(1 << 20) < share
    return lambda i: i < len(draw) and bool(draw[i])


def latency_ms(records, q: float):
    """The q-th percentile of the records' latency, issue to last reply."""
    lat = [r["done"] - r["issued"] for r in records]
    return 1e3 * float(np.percentile(lat, q)) if lat else None


def slice_qps(records, t_open: float, t_end: float, width: float = 5.0) -> list:
    """Queries answered per second in each whole ``width``-second slice of a
    window, each request counted in the slice in which it returned."""
    counts = np.zeros(int((t_end - t_open) // width))
    for r in records:
        j = int((r["done"] - t_open) // width)
        if j < len(counts):
            counts[j] += r.get("answered", 0)
    return (counts / width).tolist()


def run_cell(workload: str, seed: int, seconds: float, trace: bool, metrics: list[dict], *,
             device, t_start: float, cell: dict | None = None):
    """(result, notes): the JSON line's object, and what stderr reports
    beside it (request errors, the build's figures, latency quantiles, the
    reference's seconds). ``cell`` stands in for the cell's files (tests
    shrink it)."""
    device = torch.device(device)
    cell = cell or cells.load_cell(workload)
    cfg, traffic = cell["config"], cell["traffic"]
    readers = {m["name"]: cells.load_reader(m["name"]) for m in metrics}
    counters = {}
    for r in readers.values():
        counters.update(getattr(r, "COUNTERS", {}))

    # 1. Set-up.
    st = set_up(cell, seed, device)
    loop = client_loop(st.index, st.queries, traffic, st.setup)
    warm = loop.run_count(int(traffic["warmup_requests"]), keep=lambda i: False)
    _sync(device)
    errors = [r["error"] for r in warm if "error" in r]
    if errors:
        raise RuntimeError(f"a warm-up request failed:\n{errors[0]}")

    # 2. The window, after an untraced one where a reader asks for it.
    untraced = None
    if trace and any(getattr(r, "WINDOW", None) == "untraced" for r in readers.values()):
        u_records, u_open, _, u_end = loop.run_window(seconds, judged(traffic, seed))
        _sync(device)
        untraced = SimpleNamespace(records=u_records, t_open=u_open, t_end=u_end)
    before = {n: cells.read_counter(p) for n, p in counters.items()}
    prof = profiler(device) if trace else None
    if prof is not None:
        prof.__enter__()
    try:
        w0 = time.time_ns()
        records, t_open, t_close, t_end = loop.run_window(seconds, judged(traffic, seed))
        _sync(device)
        w1 = time.time_ns()
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    after = {n: cells.read_counter(p) for n, p in counters.items()}
    setup_s = t_open - t_start
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    t_trace = time.perf_counter()
    reduced = Trace(prof, w0, w1) if prof is not None else None
    trace_s = time.perf_counter() - t_trace

    # 3. The program's state freed, then the reference's judgement.
    rows, queries, labels, built = st.rows, st.queries, st.labels, st.built
    del st, loop, warm, prof
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    issued = records + (untraced.records if untraced is not None else [])
    kept = [r for r in issued if "replies" in r]
    verdict = judge.judge_requests(kept, rows, labels, queries, traffic, cfg["checks"], device)
    failed = [r["error"] for r in issued if "error" in r]

    # 4. The metrics.
    run = SimpleNamespace(
        cell=cell, config=cfg, traffic=traffic, records=records,
        t_open=t_open, t_close=t_close, t_end=t_end, untraced=untraced, setup_s=setup_s,
        built=built,
        counters={n: after[n] - before[n] for n in counters}, trace=reduced, verdict=verdict)
    values = {}
    for m in metrics:
        v = readers[m["name"]].read(run)
        if v is not None:
            values[m["name"]] = {"value": float(v), "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if reduced is not None:
        dev.update(busy_s=reduced.busy_s, window_s=reduced.window_s)
    result = {"correct": verdict["correct"] and not failed, "attempted": len(issued),
              "failed": len(failed), "metrics": values, "device": dev}
    if reduced is not None:
        result["breakdown"] = reduced.breakdown()
    result["checks"] = verdict["checks"]  # the last key
    notes = {"errors": failed[:3], **built, "requests": len(records), "judged": len(kept),
             "p50_ms": latency_ms(records, 50), "p90_ms": latency_ms(records, 90),
             "p95_ms": latency_ms(records, 95), "window_s": t_end - t_open,
             "slice_qps": slice_qps(records, t_open, t_end),
             "untraced": None if untraced is None else {
                 "requests": len(untraced.records), "p90_ms": latency_ms(untraced.records, 90),
                 "slice_qps": slice_qps(untraced.records, untraced.t_open, untraced.t_end)},
             "reference_s": time.perf_counter() - t_ref, "distinct_replies": verdict["variants"],
             "trace_s": trace_s,
             "trace_off_window": None if reduced is None else reduced.outside}
    return result, notes


def check_lines(result: dict) -> list[str]:
    """One line per number compared, with its limit."""
    out = []
    for name, c in result["checks"].items():
        lim = f"max {c['max']!r}" if "max" in c else f"min {c['min']!r}"
        out.append(f"check {name} {c['value']!r} {lim} {'ok' if c['ok'] else 'FAILED'}")
    return out
