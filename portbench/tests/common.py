"""Shared by the benchmark's tests: a cell shrunk to a size a CPU test holds."""

from __future__ import annotations

import copy

from portbench import cells

TINY = {"n_rows": 3000, "capacity": 4096}  # the configuration's scale; widths stay
TINY_TRAFFIC = {"batch": 32, "pool_batches": 4, "warmup_requests": 4}


def tiny_cell(name: str, **config) -> dict:
    cell = copy.deepcopy(cells.load_cell(name))
    cell["config"].update(TINY, **config)
    cell["traffic"].update(TINY_TRAFFIC)
    return cell
