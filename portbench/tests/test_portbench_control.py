"""The control: the float64 reference put in the program's place in TF32,
the precision below the configurations' FLOAT32, must come out not
correct, while the program's own replies at the same sizes come out
correct. On the CPU at a tiny size (the port's plain versions); on the card
at 262,144 rows, the cells' widths and batch, three seeds."""

import pytest
import torch

from portbench import calibrate, cells
from portbench.tests.common import tiny_cell


def _check(lines):
    for line in lines:
        want = line["side"] == "program"
        assert line["correct"] is want, line


@pytest.mark.parametrize("names", [("flat-f32-k10", "flat-f32-k100"), ("hnsw-ef200-k10",)],
                         ids=lambda n: "+".join(n))
def test_control_fails_and_program_passes_on_cpu(names):
    extra = {"n_rows": 2000} if names[0].startswith("hnsw") else {}
    lines = calibrate.readings([tiny_cell(n, **extra) for n in names], 11,
                               torch.device("cpu"), control=True)
    _check(lines)


@pytest.mark.cuda
def test_control_fails_and_program_passes_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    names = ("flat-f32-k10", "flat-f32-k100", "flat-f32-k500")
    group = []
    for n in names:
        c = cells.load_cell(n)
        c["config"].update(n_rows=262_144, capacity=262_144)
        c["traffic"].update(pool_batches=2)
        group.append(c)
    for seed in (2147483701, 2147483702, 2147483703):
        _check(calibrate.readings(group, seed, torch.device("cuda", 0), control=True))
