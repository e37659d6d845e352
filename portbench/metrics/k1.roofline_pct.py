"""K1's share of its roofline: ``gm_tc_kernel`` (``csrc/bf_topk_gm_tc.cu``)."""

from portbench.metrics._roofline import share


def read(run):
    return share(run, "gm_tc_kernel<")
