"""K4's share of its roofline: ``fused_tc_kernel`` launched as the per-tile
top-c (``bf_topk_topc_tc``). K3 runs the same device function, so the
reading stands only where K3 did not launch in the window."""

from portbench.metrics._roofline import ENGINE_COUNTERS, share

COUNTERS = ENGINE_COUNTERS


def read(run):
    if run.counters["k4_launches"] <= 0 or run.counters["k3_launches"] > 0:
        return None
    return share(run, "fused_tc_kernel<")
