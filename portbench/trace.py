"""The traced run: ``torch.profiler`` over the window, reduced to what the
per-layer readers and the result's ``breakdown`` need.

Only the card's timeline is recorded (CUPTI's activity records): recording
every host op of a launch-bound loop slowed the HNSW cell 3x on the card, so
the host is not traced. The window is given on the host's wall clock
(``time.time_ns``), the clock the profiler's events carry. Device activity
is every event on the card's timeline: kernels, copies, sets. ``busy_s`` is
the length of their union inside the window; an idle gap is a stretch of
the window that none covers, named by the device op that ended it (what
the host was preparing while the card waited), or by the window's end.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np
import torch

TOP = 10  # entries of each breakdown list


def profiler(device: torch.device):
    """A profiler of the card's timeline (of nothing on the CPU)."""
    if device.type == "cuda":
        return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def short_name(name: str) -> str:
    """A device op's name without its return type and arguments:
    ``gm_tc_kernel<bfs::LaneF32, 2>``."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    cut = name.find("(")
    return (name[:cut] if cut > 0 else name).strip()[:120]


class Trace:
    """A reduced trace of the window [w0, w1) (``time.time_ns`` values): per
    device op name its launches and seconds inside the window, the busy and
    window seconds, and idle seconds by the op that ended each gap."""

    def __init__(self, prof, w0: int, w1: int):
        cuda = torch.autograd.DeviceType.CUDA
        starts, ends, codes, names = [], [], [], {}
        for e in prof.profiler.kineto_results.events():
            if e.device_type() == cuda:
                starts.append(e.start_ns())
                ends.append(e.end_ns())
                codes.append(names.setdefault(e.name(), len(names)))
        names = list(names)
        self.window_s = (w1 - w0) / 1e9
        s, t = np.asarray(starts, dtype=np.int64), np.asarray(ends, dtype=np.int64)
        code = np.asarray(codes, dtype=np.int64)
        inside = (s >= w0) & (s < w1)
        self.outside = int((~inside).sum())  # events off the window: a clock mismatch shows here
        launches = np.bincount(code[inside], minlength=len(names))
        secs = np.bincount(code[inside], weights=(np.minimum(t, w1) - s)[inside] / 1e9,
                           minlength=len(names))
        # full name -> [launches, seconds]
        self.ops = {n: [int(launches[j]), float(secs[j])] for j, n in enumerate(names)
                    if launches[j]}
        # The union of the device intervals inside the window, and its gaps.
        cs, ce = np.clip(s, w0, w1), np.clip(t, w0, w1)
        keep = np.nonzero(ce > cs)[0]
        order = keep[np.argsort(cs[keep], kind="stable")]
        cs, ce = cs[order], ce[order]
        self.idle: dict = defaultdict(float)
        if not len(cs):
            self.busy_s = 0.0
            self.idle["window's end"] += self.window_s
            return
        reach = np.maximum.accumulate(ce)
        new = np.concatenate([[True], cs[1:] > reach[:-1]])
        seg_start, first = cs[new], code[order[new]]
        seg_end = np.concatenate([reach[np.nonzero(new)[0][1:] - 1], reach[-1:]])
        self.busy_s = float((seg_end - seg_start).sum()) / 1e9
        gaps = (seg_start - np.concatenate([[w0], seg_end[:-1]])) / 1e9
        by_next = np.bincount(first, weights=gaps, minlength=len(names))
        for j in np.nonzero(by_next > 0)[0]:
            self.idle["before " + short_name(names[j])] += float(by_next[j])
        if w1 > seg_end[-1]:
            self.idle["window's end"] += (w1 - seg_end[-1]) / 1e9

    def seconds_of(self, fragment: str) -> tuple:
        """(launches, device seconds) of the ops whose name holds ``fragment``."""
        hits = [v for n, v in self.ops.items() if fragment in n]
        return sum(v[0] for v in hits), sum(v[1] for v in hits)

    def kernel_launches(self) -> int:
        return sum(v[0] for n, v in self.ops.items() if not n.startswith(("Memcpy", "Memset")))

    def breakdown(self) -> dict:
        by_op: dict = defaultdict(float)
        for n, (_, s) in self.ops.items():
            by_op[short_name(n)] += s
        top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(by_op), "idle_gaps": top(self.idle)}
