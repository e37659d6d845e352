"""Cells, configurations, traffic mixes and metrics are files found by name."""

import json
import shutil
import time
from pathlib import Path

import pytest

from portbench import cells, harness
from portbench.tests.common import tiny_cell

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_workload_is_its_cell_file(w):
    cell = cells.load_cell(w["name"])
    assert (cell["config_name"], cell["traffic_name"]) == (w["config"], w["traffic"])
    cfg = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert (ROOT / cfg["file"]).resolve() == (cells.BASE / "configs" / f"{w['config']}.json")
    assert cells.load_setup(cell["config"]["setup"]).build


@pytest.mark.parametrize("m", BENCH["end_to_end"] + BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_metric_has_a_reader(m):
    reader = cells.load_reader(m["name"])
    assert callable(reader.read)
    for path in getattr(reader, "COUNTERS", {}).values():
        assert isinstance(cells.read_counter(path), int)


def test_a_cell_added_as_files_is_found_with_no_edit(tmp_path):
    for d in ("cells", "configs", "traffic", "setups", "metrics"):
        shutil.copytree(cells.BASE / d, tmp_path / d)
    traffic = json.loads((tmp_path / "traffic" / "closed-b1024-k10-c4.json").read_text())
    traffic.update(k=64, clients=2)
    (tmp_path / "traffic" / "closed-b1024-k64-c2.json").write_text(json.dumps(traffic))
    (tmp_path / "cells" / "flat-f32-k64.json").write_text(
        json.dumps({"config": "dbpedia1m-flat-f32", "traffic": "closed-b1024-k64-c2"}))
    (tmp_path / "metrics" / "replies_per_request.py").write_text(
        "def read(run):\n    return 1.0\n")
    cell = cells.load_cell("flat-f32-k64", tmp_path)
    assert cell["traffic"]["k"] == 64 and cell["config"]["n_rows"] == 1_000_000
    assert cells.load_reader("replies_per_request", tmp_path).read(None) == 1.0
    bench = {"end_to_end": [{"name": "qps"}, {"name": "x", "workloads": ["other"]}],
             "per_layer": []}
    assert [m["name"] for m in cells.metrics_for(bench, "flat-f32-k64", False)] == ["qps"]


@pytest.mark.parametrize("name,untraced", [("hnsw-ef200-k10", True), ("flat-f32-k10", False),
                                           ("flat-s8-k10", False)])
def test_a_host_clock_reader_reads_an_untraced_window(name, untraced):
    result, notes = harness.run_cell(name, 3, 0.5, True, cells.metrics_for(BENCH, name, True),
                                     device="cpu", t_start=time.perf_counter(),
                                     cell=tiny_cell(name, n_rows=2000))
    assert result["correct"], result["checks"]
    if not untraced:
        assert notes["untraced"] is None
        return
    assert notes["untraced"]["requests"] > 0
    assert result["metrics"]["hnsw.request_p90_ms"]["value"] == notes["untraced"]["p90_ms"]
    assert result["attempted"] == notes["requests"] + notes["untraced"]["requests"]
