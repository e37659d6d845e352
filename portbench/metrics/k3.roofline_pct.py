"""K3's share of its roofline: ``fused_tc_kernel`` launched as the fused
top-k (``bf_topk_fused_tc``). K4 runs the same device function, so the
reading stands only where K4 did not launch in the window."""

from portbench.metrics._roofline import ENGINE_COUNTERS, share

COUNTERS = ENGINE_COUNTERS


def read(run):
    if run.counters["k3_launches"] <= 0 or run.counters["k4_launches"] > 0:
        return None
    return share(run, "fused_tc_kernel<")
