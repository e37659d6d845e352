#!/usr/bin/env python3
"""One lane of ``chip_smoke.py``'s phase 5, from the checkout given, on one
CUDA card: for comparing two trees' kernel times in turns in one call.

    python3 tools/lane_turns.py TREE [LANE] [ROUNDS]

``TREE`` is a checkout (for example an unpacked ``git archive`` of a
commit); its ``chip_smoke.py`` and package are imported, its kernels built,
the headline store (1M x 768 embedding-like fp32 rows, seed 0) generated on
the card and cast or scaled to ``LANE`` (``f32``, ``f16``, ``bf16``, ``s8``
or ``u8``; default ``s8``) as the smoke does, and the smoke's
``full_width`` run ``ROUNDS`` times (default 1). Each round prints one line
``LANE_TURNS {"tree": ..., "lane": ..., "round": ..., "ms": {kernel: ms}}``,
and the card's name and power limit come first. Run it once per tree, in
turns (parent, change, change, parent, ...), in one call.
"""

from __future__ import annotations

import collections
import importlib.util
import json
import os
import subprocess
import sys

import torch


def main() -> int:
    if not torch.cuda.is_available():
        print("lane_turns: no CUDA device", file=sys.stderr)
        return 1
    tree = os.path.abspath(sys.argv[1])
    lane = sys.argv[2] if len(sys.argv) > 2 else "s8"
    rounds = int(sys.argv[3]) if len(sys.argv) > 3 else 1
    sys.path.insert(0, tree)
    spec = importlib.util.spec_from_file_location("smoke", os.path.join(tree, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from vectorsimilarity_tpu_torch.utils.synthetic import embedding_like

    dev = torch.device("cuda:0")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"# {smi}", flush=True)
    cs.phase_build()
    gen = torch.Generator(device=dev).manual_seed(cs.SEED)
    store = torch.zeros((cs.CAP, cs.DIM), dtype=torch.float32, device=dev)
    embedding_like(gen, cs.N, cs.DIM, out=store)
    qgen = torch.Generator(device=dev).manual_seed(cs.SEED + 100)
    queries = embedding_like(gen, cs.BATCH, cs.DIM, latent_generator=qgen)
    if lane in ("s8", "u8"):
        scale = 127.0 / float(store.abs().max())
        shift = 0 if lane == "s8" else 128
        quantize = lambda t: (t * scale).round().clamp(-127, 127).add(shift)  # noqa: E731
        data = torch.cat([quantize(c).to(cs.DTYPES[lane]) for c in store.split(1 << 17)])
        q, norms = quantize(queries), cs.int_norms(data)
    else:
        data, q, norms = store.to(cs.DTYPES[lane]), queries, None
    del store
    small = collections.defaultdict(float)
    for r in range(rounds):
        rows = cs.full_width(lane, data, norms, q, smi, small)
        print("LANE_TURNS " + json.dumps({"tree": os.path.basename(tree), "lane": lane,
                                          "round": r, "ms": {x["name"]: x["ms"] for x in rows}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
