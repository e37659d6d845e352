"""Share of the graph loops' iterations over the window that ran inside
replays of captured CUDA graphs: the change in
``graph_search.graph_replay_iters`` over the change in
``graph_search.iterations``. A program without the replay counter reads
nothing."""

import importlib

_GS = "vectorsimilarity_tpu_torch.ops.graph_search"
COUNTERS = {"graph_iterations": _GS + ":iterations"}
if hasattr(importlib.import_module(_GS), "graph_replay_iters"):
    COUNTERS["graph_replay_iters"] = _GS + ":graph_replay_iters"


def read(run):
    iters = run.counters["graph_iterations"]
    replayed = run.counters.get("graph_replay_iters")
    if replayed is None or iters <= 0:
        return None
    return replayed / iters
