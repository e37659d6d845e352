"""The readings that the limits of ``correct`` are set from (card only).

    python3 portbench/calibrate.py --cells flat-f32-k10,flat-f32-k100 --seeds 11,12,13 [--control]

For each seed: the first cell's configuration is set up once (every cell
named must share it), each cell's traffic answers every pool batch twice
through its closed loop at the cell's own load (its clients, its batch),
the program's state is freed, and the float64 reference judges the
replies, as a run judges its window. With ``--control`` the reference in
TF32 (``reference.Reference(..., "tf32")``) is put in the program's place
and judged the same way: it has to come out not correct. Prints one JSON
line per seed, cell and side with every number of the configuration's
checks; the benchmark's runs never run this.
"""

import argparse
import gc
import json
import os
import sys
import time
from types import SimpleNamespace

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def control_requests(ref, labels, queries, traffic) -> list:
    """The control's replies, one request per pool batch, in the form the
    program's take."""
    B, k = int(traffic["batch"]), int(traffic["k"])
    d, rows = ref.topk(queries, k)
    out = []
    for p in range(int(traffic["pool_batches"])):
        sl = slice(p * B, (p + 1) * B)
        out.append({"pool": p, "replies": [SimpleNamespace(ids=labels[r], scores=dd)
                                           for r, dd in zip(rows[sl], d[sl])]})
    return out


def readings(all_cells: list, seed: int, device, control: bool) -> list[dict]:
    """Every number of the configuration's checks, per cell and side
    (``program``, and with ``control`` the TF32 reference in its place)."""
    import torch

    from portbench import harness, judge
    from portbench.reference import Reference

    st = harness.set_up(all_cells[0], seed, device)
    answers = {}
    for c in all_cells:
        loop = harness.client_loop(st.index, st.queries, c["traffic"], st.setup)
        recs = loop.run_count(2 * int(c["traffic"]["pool_batches"]))
        bad = [r["error"] for r in recs if "error" in r]
        if bad:
            raise RuntimeError(bad[0])
        answers[c["name"]] = recs
    rows, queries, labels = st.rows, st.queries, st.labels
    del st, loop
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    sides = [("program", answers)]
    if control:
        ref = Reference(rows, device, "tf32")
        sides.append(("control", {c["name"]: control_requests(ref, labels, queries, c["traffic"])
                                  for c in all_cells}))
        del ref
    k_truth = max(max(int(c["traffic"]["k"]), 10) for c in all_cells)
    truth = judge.Truth(rows, labels, queries, k_truth, device)
    out = []
    for side, by_cell in sides:
        for c in all_cells:
            k = int(c["traffic"]["k"])
            v = judge.judge(judge.distinct_variants(by_cell[c["name"]], k), truth,
                            int(c["traffic"]["batch"]), k, c["config"]["checks"])
            out.append({"seed": seed, "cell": c["name"], "side": side, "correct": v["correct"],
                        "numbers": {n: x["value"] for n, x in v["checks"].items()},
                        "recall_at_10": v["recall_at_10"]})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    sys.path[0] = ROOT  # the checkout, not this folder: its module names are not top-level
    import torch

    from portbench import cells

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    all_cells = [cells.load_cell(n) for n in args.cells.split(",")]
    if len({c["config_name"] for c in all_cells}) != 1:
        print("calibrate: the cells must share one configuration", file=sys.stderr)
        return 2
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        for line in readings(all_cells, seed, torch.device("cuda", 0), args.control):
            print(json.dumps(line), flush=True)
        print(f"# seed {seed} done in {time.perf_counter() - t0:.1f} s", file=sys.stderr,
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
