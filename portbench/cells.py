"""Finding a cell's files by name.

A cell is ``cells/<name>.json``, naming a configuration
(``configs/<name>.json``) and a traffic mix (``traffic/<name>.json``). A
configuration names its set-up module (``setups/<name>.py``). A metric is a
reader, ``metrics/<name>.py``, with ``read(run)`` returning its value or
None where it finds nothing to read, and optionally ``COUNTERS``: the
program counters (``"module:attribute.path"``) whose change over the window
it reads, and ``WINDOW = "untraced"``: a per-layer reading of the host's
clock, which a traced run takes from an untraced window of its own. A later
cell or metric is added as files, with no edit here.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

BASE = Path(__file__).resolve().parent


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, base: Path = BASE) -> dict:
    """{"name", "config", "traffic"}, the last two the files' contents."""
    cell = _json(base / "cells" / f"{name}.json")
    return {"name": name, "config": _json(base / "configs" / f"{cell['config']}.json"),
            "traffic": _json(base / "traffic" / f"{cell['traffic']}.json"),
            "config_name": cell["config"], "traffic_name": cell["traffic"]}


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(f"no {path}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_setup(name: str):
    return _module(BASE / "setups" / f"{name}.py", f"portbench_setup_{name}")


def load_reader(name: str, base: Path = BASE):
    return _module(base / "metrics" / f"{name}.py", f"portbench_metric_{name}")


def metrics_for(bench: dict, workload: str, trace: bool) -> list[dict]:
    """The metrics a run of ``workload`` reports: with ``trace`` the
    per-layer ones, else the end-to-end ones; a metric with a
    ``workloads`` list only in those cells."""
    return [m for m in bench["per_layer" if trace else "end_to_end"]
            if workload in m.get("workloads", [workload])]


def read_counter(path: str):
    """The value of a program counter ``"module:attr.attr"``."""
    mod, _, attrs = path.partition(":")
    obj = importlib.import_module(mod)
    for a in attrs.split("."):
        obj = getattr(obj, a)
    return obj
