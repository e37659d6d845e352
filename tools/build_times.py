#!/usr/bin/env python3
"""Seconds nvcc takes for each kernel source, one source at a time.

    python3 tools/build_times.py [CSRC_DIR ...]

Builds every ``*.cu`` under each given directory (default: the package's
``vectorsimilarity_tpu_torch/csrc``) with the package's nvcc flags
(``ops/kernels/bf_topk.py``), one process at a time, into a temporary
directory under ``build/``, and prints one line per source and one total per
directory. ``load_kernel`` starts one nvcc per source at once, so its time is
the slowest source's; this shows each source's own. Give the sources of
another tree too (an unpacked parent commit) to compare two trees in one
call. Needs nvcc, so it runs on the card's machine.
"""

from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from vectorsimilarity_tpu_torch.ops.kernels import bf_topk as bfk  # noqa: E402


def main(argv: list) -> int:
    dirs = [Path(a).resolve() for a in argv] or [bfk._CSRC]
    (REPO / "build").mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=REPO / "build") as out:
        for d in dirs:
            total = 0.0
            for src in sorted(d.glob("*.cu")):
                t0 = time.perf_counter()
                subprocess.run([bfk._nvcc(), *bfk._NVCC_FLAGS, "-o", f"{out}/{src.stem}.so",
                                str(src)], check=True, capture_output=True)
                seconds = time.perf_counter() - t0
                total += seconds
                print(f"# nvcc {os.path.relpath(src, REPO)}: {seconds:.1f} s", flush=True)
            print(f"# nvcc {os.path.relpath(d, REPO)}: {total:.1f} s for its sources in turn",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
