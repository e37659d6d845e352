"""Device kernels launched in the traced window per graph-loop iteration
(the change in ``graph_search.iterations``)."""

COUNTERS = {"graph_iterations": "vectorsimilarity_tpu_torch.ops.graph_search:iterations"}


def read(run):
    iters = run.counters["graph_iterations"]
    if run.trace is None or iters <= 0:
        return None
    launches = run.trace.kernel_launches()
    return launches / iters if launches else None
