"""The graph search's replay share: what it reads where no chunk is replayed."""

import json
import time
from pathlib import Path
from types import SimpleNamespace

from portbench import cells, harness
from portbench.tests.common import tiny_cell

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_replay_share_reads_zero_on_the_cpu():
    """No chunk is replayed off a CUDA device; a program without the replay
    counter (the counter absent from the run) reads nothing."""
    name = "hnsw-ef200-k10"
    metrics = [m for m in cells.metrics_for(BENCH, name, True)
               if m["name"] == "graph_search.replay_share"]
    result, _ = harness.run_cell(name, 5, 0.5, True, metrics, device="cpu",
                                 t_start=time.perf_counter(), cell=tiny_cell(name, n_rows=2000))
    assert result["correct"], result["checks"]
    assert result["metrics"]["graph_search.replay_share"]["value"] == 0.0
    reader = cells.load_reader("graph_search.replay_share")
    assert reader.read(SimpleNamespace(counters={"graph_iterations": 64})) is None
