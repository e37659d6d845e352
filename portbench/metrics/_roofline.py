"""The share of its roofline that a flat kernel reached over the traced
window: the least time of the window's scans (``roofline.bound_ms`` of one
request's batch over the live rows, times the requests) over the device
time of the kernel's events. Shared by the ``k*.roofline_pct`` readers."""

from portbench.roofline import LANES, bound_ms

_K = "vectorsimilarity_tpu_torch.ops.kernels.bf_topk:"
ENGINE_COUNTERS = {"k3_launches": _K + "fused_topk.tc_launches",
                   "k4_launches": _K + "tile_topc.tc_launches"}


def share(run, kernel: str):
    """Percent of the roofline for device events named ``kernel``; None
    where the trace holds none."""
    if run.trace is None:
        return None
    launches, seconds = run.trace.seconds_of(kernel)
    if not launches or seconds <= 0:
        return None
    cfg, tr = run.config, run.traffic
    least_ms, _ = bound_ms(LANES[cfg["type"]], int(tr["batch"]), int(cfg["n_rows"]),
                           int(cfg["dim"]), int(tr["k"]))
    scans = sum("answered" in r for r in run.records)
    return 100.0 * scans * least_ms / 1e3 / seconds
