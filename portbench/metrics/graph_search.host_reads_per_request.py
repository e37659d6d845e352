"""Host reads of the graph loops' device flags per request over the window
(the change in ``graph_search.host_reads``)."""

COUNTERS = {"graph_host_reads": "vectorsimilarity_tpu_torch.ops.graph_search:host_reads"}


def read(run):
    n = len(run.records)
    return run.counters["graph_host_reads"] / n if n else None
