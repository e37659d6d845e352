"""The harness and its reference load neither JAX nor the JAX package.

Each check runs in a fresh interpreter, so what this test process has
imported cannot hide or fake a load. Names are compared whole by their
top-level part: ``vectorsimilarity_tpu_torch`` is the port and is allowed
on the program's side; ``vectorsimilarity_tpu`` is the JAX package."""

import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]

RUN_CELL = """
import json, sys, time
sys.path.insert(0, {root!r})
from portbench import cells, harness
from portbench.tests.common import tiny_cell
bench = json.load(open({bench!r}))
for trace in (False, True):
    result, _ = harness.run_cell({cell!r}, 7, 0.5, trace, cells.metrics_for(bench, {cell!r}, trace),
                                 device="cpu", t_start=time.perf_counter(),
                                 cell=tiny_cell({cell!r}))
    assert result["correct"], result
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


def _top_level_names(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


@pytest.mark.parametrize("cell", ["flat-f32-k10", "hnsw-ef200-k10"])
def test_a_run_of_the_cell_code_loads_no_jax(cell):
    names = _top_level_names(RUN_CELL.format(root=str(ROOT), bench=str(ROOT / "BENCHMARK.json"),
                                             cell=cell))
    assert "vectorsimilarity_tpu_torch" in names  # the port did run
    assert not names & {"jax", "jaxlib", "flax", "vectorsimilarity_tpu"}


def test_the_reference_and_judge_import_nothing_of_the_port():
    names = _top_level_names(
        f"import json, sys; sys.path.insert(0, {str(ROOT)!r}); "
        "import portbench.reference, portbench.judge, portbench.gen, portbench.roofline; "
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    assert not names & {"vectorsimilarity_tpu_torch", "jax", "jaxlib", "flax",
                        "vectorsimilarity_tpu"}


def test_forbidden_names_compare_whole():
    from portbench.harness import forbidden_modules

    assert forbidden_modules(["vectorsimilarity_tpu_torch.ops", "jaxtyping", "numpy"]) == []
    assert forbidden_modules(["vectorsimilarity_tpu.ops", "jax.numpy"]) == [
        "jax", "vectorsimilarity_tpu"]
