"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``).

The JAX package is the reference. Both sides compute in fp32 on the CPU in
different summation orders, so distances agree within ``TOL`` and ids agree
except where a distance lies within ``TOL`` of a neighbouring one.
"""

from __future__ import annotations

import numpy as np
import torch

TOL = 1e-5


def unit_rows(rng, n: int, d: int) -> np.ndarray:
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def np_of(x) -> np.ndarray:
    """numpy view of a torch tensor or a JAX array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_topk_parity(d, i, rd, ri, tol: float = TOL) -> None:
    """Port (d, i) against the reference (rd, ri), both [B, k] in
    (distance, id) order: unfilled slots (inf, -1) at the same places,
    distances within ``tol``, ids equal except at slots whose reference
    distance lies within ``tol`` of a neighbouring slot's."""
    d, i, rd, ri = (np_of(x) for x in (d, i, rd, ri))
    assert d.shape == rd.shape and i.shape == ri.shape == d.shape
    fin = np.isfinite(rd)
    assert np.array_equal(np.isfinite(d), fin)
    assert (i[~fin] == -1).all() and (ri[~fin] == -1).all()
    if fin.any():
        assert np.abs(d[fin].astype(np.float64) - rd[fin]).max() <= tol
    with np.errstate(invalid="ignore"):  # inf - inf between unfilled slots
        gap = np.abs(np.diff(rd.astype(np.float64), axis=1)) <= tol
    tied = np.zeros(d.shape, dtype=bool)
    tied[:, 1:] |= gap
    tied[:, :-1] |= gap
    assert ((i == ri) | tied).all(), (i, ri)


def assert_replies_parity(port, ref, tol: float = TOL) -> None:
    """Lists of QueryReply: same codes, and per reply the same labels and
    scores under ``assert_topk_parity`` (unfilled slots padded)."""
    assert len(port) == len(ref)
    for p, r in zip(port, ref):
        assert int(p.code) == int(r.code)
        assert len(p) == len(r)
        assert_topk_parity(p.scores[None], p.ids[None], r.scores[None], r.ids[None], tol)
