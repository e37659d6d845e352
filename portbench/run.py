"""Run one cell of ``BENCHMARK.json`` on the card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Prints as its last line of standard output one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``:
each number compared with its limit), and the same checks as the last lines
of standard error. ``--trace 0`` reports the cell's end-to-end metrics,
``--trace 1`` its per-layer ones, read from ``torch.profiler``. Exits
nonzero, printing no result, without as many CUDA cards as the cell asks
for, or if JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path[0] = ROOT  # the checkout, not this folder: its module names are not top-level
    import torch

    from portbench import cells, harness

    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    entry = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"portbench: no workload {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    cell = cells.load_cell(args.workload)
    if (cell["config_name"], cell["traffic_name"]) != (entry["config"], entry["traffic"]):
        print(f"portbench: cells/{args.workload}.json names {cell['config_name']}, "
              f"{cell['traffic_name']}; BENCHMARK.json {entry['config']}, {entry['traffic']}",
              file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(entry["chips"]):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {entry['chips']} CUDA card(s), found {have}; "
              "nothing was run", file=sys.stderr)
        return 2

    result, notes = harness.run_cell(
        args.workload, args.seed, args.seconds, bool(args.trace),
        cells.metrics_for(bench, args.workload, bool(args.trace)),
        device=torch.device("cuda", 0), t_start=T_START, cell=cell)
    found = harness.forbidden_modules(sys.modules)
    if found:
        print(f"portbench: the run loaded {found}; no result", file=sys.stderr)
        return 3
    for err in notes.pop("errors"):
        print(f"portbench: a request failed:\n{err}", file=sys.stderr)
    print("portbench: " + json.dumps(notes), file=sys.stderr)
    print("\n".join(harness.check_lines(result)), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
