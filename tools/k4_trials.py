#!/usr/bin/env python3
"""Trials of the tensor-core per-tile top-c kernel K4 on one CUDA card: what
its per-tile list resets cost, and what bounds that cost.

    python3 tools/k4_trials.py

K4 (``bf_topk_topc_tc``) is the tensor-core K3's kernel
(``vectorsimilarity_tpu_torch/csrc/bf_topk_fused_tc.cu``) writing one list
per 4096-row tile; each tile starts from an empty list. For every build of
that source's trial switch (``-DTC_TRIAL=n``, through
``load_kernel(defines=...)``) it times, at the smoke's headline (1M x 768
embedding-like rows, cosine, B = 1024, c = 32, the wrapper's split of 8
ranges of whole tiles), the kernel writing one list per tile (K4) and the
same launch writing one list per range (K3's configuration, m = 32): their
difference is what the resets cost.

- ``as_is`` (0): the kernel as the package builds it;
- ``full_merge`` (1): merges rank every candidate against all 128 list
  slots a warp holds, not only the 32 that a list of m <= 32 fills;
- ``half_rounds`` (2): a merge round starts when a candidate buffer is half
  full, not full;
- ``both`` (3): both, the selection as the tensor-core K3 first shipped it.

Lanes fp32, bf16 and int8 (the fp32 rows cast or scaled to int8 as
``chip_smoke.py`` does). Every line ends with the card's name and power
limit. The trials are measurements: nothing in the package reads them.
"""

from __future__ import annotations

import statistics
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
N, CAP, D, B, TILE_N, C = 1_000_000, 1 << 20, 768, 1024, 4096, 32
TRIALS = ("as_is", "full_merge", "half_rounds", "both")


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


def main() -> int:
    if not torch.cuda.is_available():
        print("k4_trials: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    from vectorsimilarity_tpu_torch.ops.kernels import bf_topk as bfk
    from vectorsimilarity_tpu_torch.types import VecSimMetric
    from vectorsimilarity_tpu_torch.utils.synthetic import embedding_like

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda:0")
    gen = torch.Generator(device=dev).manual_seed(0)
    x = torch.zeros((CAP, D), dtype=torch.float32, device=dev)
    embedding_like(gen, N, D, out=x)
    q = embedding_like(gen, B, D, latent_generator=torch.Generator(device=dev).manual_seed(100))
    scale = 127.0 / float(x.abs().max())
    s8 = lambda t: (t * scale).round().clamp(-127, 127).to(torch.int8)
    norm = lambda t: torch.cat([c.double().square().sum(1).float().sqrt().clamp(min=1.0)
                                for c in t.split(1 << 17)])
    stores = {"f32": (x, q, None, None), "bf16": (x.bfloat16(), q.bfloat16(), None, None)}
    xs, qs = s8(x), s8(q)
    stores["s8"] = (xs, qs, norm(xs), norm(qs))

    metric = VecSimMetric.Cosine
    n_tiles = CAP // TILE_N
    tiles, n_ranges = bfk._topc_tc_ranges(B, -(-N // TILE_N), bfk._sms(dev))
    out_d = torch.empty((B, n_tiles, C), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, n_tiles, C), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream

    def ok(err):
        if err != 0:
            raise RuntimeError(f"launch failed: cudaError_t {err}")

    for n, trial in enumerate(TRIALS):
        kern = bfk.load_kernel(defines=() if n == 0 else (f"TC_TRIAL={n}",))
        print(f"# trial {trial}: built in {kern.build_seconds:.1f} s", flush=True)
        for lane, (xx, qq, norms, qnorms) in stores.items():
            qf, qi, rf = (bfk._ptr(t) for t in bfk._lane_aux(qq, norms, metric, qnorms))
            head = (qq.data_ptr(), xx.data_ptr(), qf, qi, rf, None)
            code = bfk._LANES[xx.dtype]
            per_tile = lambda: ok(kern.topc_tc(*head, out_d.data_ptr(), out_i.data_ptr(), code,
                                               B, D, n_tiles, TILE_N, C, N, tiles, n_ranges,
                                               int(metric), stream))
            per_range = lambda: ok(kern.fused_tc(*head, None, None, out_d.data_ptr(),
                                                 out_i.data_ptr(), code, B, D, CAP,
                                                 tiles * TILE_N, n_ranges, C, N, int(metric),
                                                 stream))
            r0, t0, t1, r1 = (time_ms(f) for f in (per_range, per_tile, per_tile, per_range))
            tile_ms, range_ms = (t0 + t1) / 2, (r0 + r1) / 2
            print(f"# trial {trial} {lane} cosine at {N} x {D}, B={B}, c={C}: a list per tile "
                  f"{tile_ms:.3f} ms ({t0:.3f}, {t1:.3f}), a list per range {range_ms:.3f} ms "
                  f"({r0:.3f}, {r1:.3f}); the resets cost {tile_ms - range_ms:.3f} ms; "
                  f"card {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
