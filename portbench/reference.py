"""The plain reference: exact Cosine top-k in float64, and its TF32 control.

Plain PyTorch over the benchmark's own rows (``gen.make_data``), with no
code of the program. Distances follow the reference library's convention
for Cosine, 1 - <x / |x|, q / |q|>, with every row and query normalized
here again. Ties order as (distance, row), lower row first. The control is
the same computation with both operands rounded to TF32 (10 mantissa bits,
round to nearest, as the tensor cores read fp32 in TF32 mode) and the
products summed in fp32: the next precision below the configuration's
FLOAT32, which the judge must refuse.
"""

from __future__ import annotations

import numpy as np
import torch

PRECISIONS = ("float64", "tf32")


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32's 10-bit mantissa, to nearest, ties away
    from zero (the tensor cores' conversion)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _normalized(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "float64":
        x = x.to(torch.float64)
        return x / torch.linalg.vector_norm(x, dim=1, keepdim=True)
    x = x.to(torch.float32)
    return to_tf32(x / torch.linalg.vector_norm(x, dim=1, keepdim=True))


def lex_smallest(d: torch.Tensor, k: int):
    """The k smallest of each row of ``d`` [m, L] in (value, position)
    order: (values [m, k], positions [m, k]). ``torch.topk`` picks any of the
    entries tied at the k-th value; here the lowest positions among them
    are taken, and the result is sorted by value, then position."""
    k = min(k, d.shape[1])
    kth = torch.topk(d, k, dim=1, largest=False, sorted=True).values[:, -1:]
    below = d < kth
    tied = d == kth
    need = k - below.sum(dim=1, keepdim=True)
    if bool((tied.sum(dim=1, keepdim=True) > need).any()):
        tied &= torch.cumsum(tied, dim=1, dtype=torch.int32) <= need
    pos = torch.nonzero(below | tied)[:, 1].reshape(d.shape[0], k)
    vals = torch.gather(d, 1, pos)
    order = torch.sort(vals, dim=1, stable=True).indices  # positions ascend already
    return torch.gather(vals, 1, order), torch.gather(pos, 1, order)


def _merge(best_d, best_i, new_d, new_i, k: int):
    """Lexicographic (distance, row) merge of two candidate lists."""
    d = torch.cat([best_d, new_d], dim=1)
    i = torch.cat([best_i, new_i], dim=1)
    o = torch.sort(i, dim=1, stable=True).indices
    d, i = torch.gather(d, 1, o), torch.gather(i, 1, o)
    o = torch.sort(d, dim=1, stable=True).indices[:, :k]
    return torch.gather(d, 1, o), torch.gather(i, 1, o)


class Reference:
    """Exact top-k and per-row distances over ``rows`` (numpy fp32 [n, D],
    the benchmark's rows as made) in ``precision``, computed on ``device``
    in blocks of rows and of queries."""

    def __init__(self, rows: np.ndarray, device, precision: str = "float64",
                 row_block: int = 1 << 17, query_block: int = 4096):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        self.precision = precision
        self.device = torch.device(device)
        self.row_block, self.query_block = row_block, query_block
        self.rows = torch.cat([
            _normalized(torch.from_numpy(rows[lo : lo + row_block]).to(self.device), precision)
            for lo in range(0, rows.shape[0], row_block)])

    def _dot(self, q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        return q @ x.T  # float64, or fp32 sums of TF32 operands (config turns TF32 off)

    def topk(self, queries: np.ndarray, k: int):
        """(distances [m, k] float64, rows [m, k] int64) of the exact top-k,
        numpy, in (distance, row) order."""
        out_d, out_i = [], []
        for qlo in range(0, queries.shape[0], self.query_block):
            q = _normalized(torch.from_numpy(queries[qlo : qlo + self.query_block]).to(self.device),
                            self.precision)
            best_d = best_i = None
            for lo in range(0, self.rows.shape[0], self.row_block):
                d = 1.0 - self._dot(q, self.rows[lo : lo + self.row_block])
                bd, bi = lex_smallest(d, k)
                bi = bi + lo
                if best_d is None:
                    best_d, best_i = bd, bi
                else:
                    best_d, best_i = _merge(best_d, best_i, bd, bi, k)
            out_d.append(best_d.double().cpu().numpy())
            out_i.append(best_i.cpu().numpy())
        return np.concatenate(out_d), np.concatenate(out_i)

    def distances(self, queries: np.ndarray, rows: np.ndarray, block: int = 1 << 16) -> np.ndarray:
        """Distances [m, j] float64 of query i to row ``rows[i, j]`` (numpy
        int64, every entry a valid row)."""
        out = np.empty(rows.shape, dtype=np.float64)
        per = max(1, block // max(rows.shape[1], 1))
        for lo in range(0, rows.shape[0], per):
            q = _normalized(torch.from_numpy(queries[lo : lo + per]).to(self.device), self.precision)
            r = torch.from_numpy(rows[lo : lo + per]).to(self.device)
            x = self.rows[r]  # [b, j, D]
            d = 1.0 - torch.einsum("bd,bjd->bj", q, x)
            out[lo : lo + per] = d.double().cpu().numpy()
        return out
