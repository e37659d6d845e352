"""The least time one NVIDIA H100 SXM could take for a scan, and the peaks.

A frozen copy of ``chip_smoke.py``'s ``PEAK_OPS``, ``PASSES`` and
``bound_ms``, counted from the shapes alone, so it reads the same work
whatever kernel does it. Peaks are NVIDIA's data sheet (SXM, dense, 700 W).
Scoring B queries against N rows of width D in a lane costs ``PASSES``
products of 2 B N D operations at the lane's tensor-core peak: fp32 is
three bf16 passes (bf16x3), the cheapest split that keeps fp32's accuracy.
The bytes are each input read once (queries, rows, per-row auxiliaries)
and the top-k written once (a distance and an id, 8 bytes each).
"""

from __future__ import annotations

PEAK_OPS = {"f32": 989e12, "f16": 989e12, "bf16": 989e12, "s8": 1979e12, "u8": 1979e12}
PASSES = {"f32": 3, "f16": 1, "bf16": 1, "s8": 1, "u8": 1}
ELEM_BYTES = {"f32": 4, "f16": 2, "bf16": 2, "s8": 1, "u8": 1}
PEAK_BYTES = 3.35e12
LANES = {"FLOAT32": "f32", "FLOAT16": "f16", "BFLOAT16": "bf16", "INT8": "s8", "UINT8": "u8"}


def bound_ms(lane: str, batch: int, rows: int, dim: int, k: int, aux_bytes: int = 0):
    """(least ms, "operations" or "bytes") of one top-k scan of ``batch``
    queries over ``rows`` live rows of width ``dim``."""
    byte_ms = 1e3 * ((batch + rows) * dim * ELEM_BYTES[lane] + aux_bytes
                     + batch * k * 8) / PEAK_BYTES
    op_ms = 1e3 * PASSES[lane] * 2.0 * batch * rows * dim / PEAK_OPS[lane]
    return (op_ms, "operations") if op_ms >= byte_ms else (byte_ms, "bytes")
