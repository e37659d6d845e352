"""A run whose timed path is broken underneath comes out not correct.

Each case drives the whole of ``harness.run_cell`` but its look for a card,
on the CPU at a tiny size, with the index class's ``topk_query_batch``
patched: half of each batch left unanswered, or one answer altered where
it is produced. (The cells are on one chip and serve no training step, so
the faults of an exchange between chips and of a state left unchanged do
not arise.)"""

import json
import time
from pathlib import Path

import pytest

from portbench import cells, harness
from portbench.tests.common import tiny_cell

BENCH = json.loads((Path(__file__).resolve().parents[2] / "BENCHMARK.json").read_text())
INDEX = {"flat-f32-k10": "vectorsimilarity_tpu_torch.indexes.brute_force.BruteForceIndex",
         "hnsw-ef200-k10": "vectorsimilarity_tpu_torch.indexes.hnsw.HNSWIndex",
         "flat-s8-k10": "vectorsimilarity_tpu_torch.indexes.brute_force.BruteForceIndex"}
TRAFFIC = {"flat-s8-k10": {"batch": 64}}  # the integer cell at D 1,024, B 64


def _half_left_out(replies):
    from vectorsimilarity_tpu_torch.core.results import make_reply

    return replies[: len(replies) // 2] + [make_reply([], []) for _ in replies[len(replies) // 2:]]


def _one_altered(replies):
    r = replies[len(replies) // 3]
    r.ids = r.ids.copy()
    r.ids[0] = r.ids[-1] + 1 if r.ids[-1] + 1 < 2000 else 0
    return replies


def _run(cell_name):
    cell = tiny_cell(cell_name, n_rows=2000)
    cell["traffic"].update(TRAFFIC.get(cell_name, {}))
    result, _ = harness.run_cell(cell_name, 5, 0.5, False, cells.metrics_for(BENCH, cell_name, False),
                                 device="cpu", t_start=time.perf_counter(), cell=cell)
    return result


@pytest.mark.parametrize("cell_name", list(INDEX))
@pytest.mark.parametrize("fault", [None, _half_left_out, _one_altered],
                         ids=["sound", "half_left_out", "one_altered"])
def test_a_broken_path_is_not_correct(monkeypatch, cell_name, fault):
    if fault is not None:
        mod, _, cls = INDEX[cell_name].rpartition(".")
        klass = getattr(__import__(mod, fromlist=[cls]), cls)
        real = klass.topk_query_batch
        monkeypatch.setattr(klass, "topk_query_batch",
                            lambda self, *a, **kw: fault(real(self, *a, **kw)))
    result = _run(cell_name)
    assert result["correct"] is (fault is None), result["checks"]
