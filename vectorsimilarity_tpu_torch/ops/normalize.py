"""Cosine normalization — counterpart of ``vectorsimilarity_tpu/ops/normalize.py``.

Float types are normalized (computed at fp32/f64, cast back to the storage
dtype — ``normalize_naive.h:22-80``). Integer types are NOT mutated: the
reference appends the fp32 norm after the int vector
(``integer_normalizeVector``, ``normalize_naive.h:80-90``); the SoA store
keeps a norms column instead.
"""

from __future__ import annotations

import numpy as np
import torch

from ..types import VecSimMetric, VecSimType, numpy_dtype


def normalize_batch(vecs: torch.Tensor) -> torch.Tensor:
    """L2-normalize rows of a float batch [B, D], preserving dtype.

    fp64 accumulates in f64 (``normalize_naive.h:25-27``); bf16/fp16
    accumulate in f32 (``bfloat16_normalizeVector`` / ``float16_normalizeVector``).
    """
    acc = torch.float64 if vecs.dtype == torch.float64 else torch.float32
    v = vecs.to(acc)
    norm = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    return (v / norm).to(vecs.dtype)


def int_norms(vecs: torch.Tensor) -> torch.Tensor:
    """fp32 L2 norms of int8/uint8 rows [B, D] -> [B].

    Matches ``IntegralType_ComputeNorm`` (``spaces/normalize/compute_norm.h``):
    exact integer sum of squares, then fp32 sqrt.
    """
    v = vecs.to(torch.int64)
    return torch.sqrt(torch.sum(v * v, dim=-1).to(torch.float32))


def normalize_blob(blob: np.ndarray, vtype: VecSimType) -> np.ndarray:
    """``VecSim_Normalize`` parity (``vec_sim.cpp:237-254``).

    Floats: returns the normalized vector (same dtype). int8/uint8: returns
    the vector with the fp32 norm appended as 4 extra bytes, mirroring the
    reference's in-buffer layout so host integrations round-trip.
    """
    vtype = VecSimType(vtype)
    dt = numpy_dtype(vtype)
    if vtype in (VecSimType.INT8, VecSimType.UINT8):
        v = np.asarray(blob, dtype=dt).reshape(-1)
        norm = np.float32(np.sqrt(np.sum(v.astype(np.int64) ** 2, dtype=np.int64)))
        out = np.empty(v.nbytes + 4, dtype=np.uint8)
        out[: v.nbytes] = v.view(np.uint8)
        out[v.nbytes :] = np.frombuffer(np.float32(norm).tobytes(), dtype=np.uint8)
        return out
    v = np.asarray(blob, dtype=dt).reshape(-1)
    acc = np.float64 if dt == np.float64 else np.float32
    vv = v.astype(acc)
    norm = np.sqrt(np.sum(vv * vv))
    return (vv / norm).astype(dt)


def needs_query_normalize(vtype: VecSimType, metric: VecSimMetric) -> bool:
    """Whether queries get normalized at preprocess time.

    Cosine float types normalize both storage and query
    (``CosinePreprocessor``, ``spaces/computer/preprocessors.h:27-80``);
    int8/uint8 cosine keeps raw values + norms instead.
    """
    return VecSimMetric(metric) == VecSimMetric.Cosine and VecSimType(vtype) not in (
        VecSimType.INT8,
        VecSimType.UINT8,
    )
