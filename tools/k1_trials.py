#!/usr/bin/env python3
"""Trials of the group-min kernel K1 on one CUDA card: what its time is made of.

    python3 tools/k1_trials.py

Builds the kernels once per trial switch of the tensor-core K1
(``vectorsimilarity_tpu_torch/csrc/bf_topk_gm_tc.cu``, ``-DK1_TRIAL=n``,
through ``load_kernel(defines=...)``) and times each build at 1M rows x 768,
B = 1024, tile_n = 4096, G = 256, against the same random stores:

- ``as_is`` (0): the kernel as the package builds it;
- ``epilogue_ip`` (1): the metric epilogue cut to ``1 - ip`` for every lane
  and metric (what `finish`, the mask and the loads cost);
- ``aux_late`` (2): the rows' floats (float L2's sqnorms, integer Cosine's
  norms) loaded in the epilogue, next to their use, instead of one per
  thread before the sub-tile's products and through shared memory;
- ``f32_one_pass`` (3): fp32 in one TF32 pass instead of the 3xTF32 split
  (what the split and the two extra passes cost; not fp32-exact);
- ``ring_4`` (4): the integer and half lanes with a 4-stage ring instead of 6;
- ``query_slowest`` (5): the grid in the other block order, one query block
  walking the whole store before the next (what the default order's L2
  reuse of the store is worth).

Then, for the kernel as it is, a sweep of the row width D (256, 768, 1536)
and of the sub-tiles per block (G = 128, 256: L = 32, 16) in int8 and bf16,
which separates the cost per sub-tile from the cost per 128-byte slice.

Every line ends with the card's name and power limit. The trials are
measurements, not paths of the index: nothing in the package reads them.
"""

from __future__ import annotations

import re
import statistics
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
N, B, TILE_N, G = 1 << 20, 1024, 4096, 256
TRIALS = ("as_is", "epilogue_ip", "aux_late", "f32_one_pass", "ring_4", "query_slowest")


def time_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def gm_tc(bfk, kern, q, x, sqnorms, metric, group_n=G, query_norms=None):
    """One launch of ``kern``'s tensor-core K1, as ``group_min_scores``
    makes it (every shape here is one the gate admits)."""
    if not bfk.gm_tc_admits(q, x):
        raise AssertionError(f"D={q.shape[1]} {x.dtype}: not a tensor-core shape")
    n_tiles = N // TILE_N
    qf, qi, rf = bfk._lane_aux(q, sqnorms, metric, query_norms)
    out = torch.empty((B, n_tiles * group_n), dtype=torch.float32, device=x.device)
    dsq = None
    if not x.dtype.is_floating_point and metric == type(metric).L2:
        dsq = torch.empty((N,), dtype=torch.int32, device=x.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    err = kern.gm_tc(q.data_ptr(), x.data_ptr(), ptr(qf), ptr(qi), ptr(rf), ptr(dsq),
                     out.data_ptr(), bfk._LANES[x.dtype], B, q.shape[1], n_tiles, TILE_N,
                     group_n, N, int(metric), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"bf_topk_gm_tc launch failed: cudaError_t {err}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_trials: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from vectorsimilarity_tpu_torch.ops.kernels import bf_topk as bfk
    from vectorsimilarity_tpu_torch.types import VecSimMetric as M

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)

    def store(dtype, D):
        if dtype == torch.int8:
            return (torch.randint(-128, 128, (N, D), generator=gen, device=dev).to(dtype),
                    torch.randint(-128, 128, (B, D), generator=gen, device=dev).to(dtype))
        unit = lambda n: torch.nn.functional.normalize(
            torch.randn((n, D), generator=gen, device=dev), dim=1).to(dtype)
        return unit(N), unit(B)

    norm = lambda t: t.double().square().sum(1).float().sqrt().clamp(min=1.0)
    stores = {"f32": store(torch.float32, 768), "bf16": store(torch.bfloat16, 768),
              "s8": store(torch.int8, 768)}
    s8_norms = tuple(norm(t) for t in stores["s8"])
    kernels = {}
    for n, trial in enumerate(TRIALS):
        kern = kernels[trial] = bfk.load_kernel(defines=() if n == 0 else (f"K1_TRIAL={n}",))
        spills = sorted({int(s) for s in re.findall(r"(\d+) bytes spill stores",
                                                     kern.build_logs["bf_topk_gm_tc"])})
        print(f"# trial {trial}: built in {kern.build_seconds:.1f} s, spill stores per kernel "
              f"{spills} bytes", flush=True)
        for lane, (x, q) in stores.items():
            for metric in (M.IP, M.Cosine):
                aux, qn = s8_norms if (lane == "s8" and metric == M.Cosine) else (None, None)
                ms = time_ms(lambda: gm_tc(bfk, kern, q, x, aux, metric, query_norms=qn))
                print(f"# trial {trial} {lane} {metric.name}: {ms:.3f} ms at {N} x 768, B={B}; "
                      f"card {smi}", flush=True)
    del stores, s8_norms
    torch.cuda.empty_cache()

    for lane, dtype in (("s8", torch.int8), ("bf16", torch.bfloat16)):
        for D in (256, 768, 1536):
            x, q = store(dtype, D)
            for group_n in (128, 256):
                ms = time_ms(lambda: gm_tc(bfk, kernels["as_is"], q, x, None, M.IP, group_n))
                print(f"# sweep {lane} IP D={D} G={group_n} (L={TILE_N // group_n}, "
                      f"{-(-D * x.element_size() // 128)} slices a sub-tile): {ms:.3f} ms; "
                      f"card {smi}", flush=True)
            del x, q
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
