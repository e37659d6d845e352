"""The plain reference: exact Cosine top-k in float64, and its controls.

Plain PyTorch over the benchmark's own rows (``gen.make_data``), with no
code of the program. Distances follow the reference library's convention
for Cosine, 1 - <x / |x|, q / |q|>, with every row and query normalized
here again in float64. On int8 rows and queries that is the library's
integer Cosine (``integer_normalizeVector``): an exact integer dot product
over the two norms. Ties order as (distance, row), lower row first.

Each control is the next precision below the one a configuration states,
which the judge must refuse (``control_precision``):

- ``tf32`` for FLOAT32: both operands rounded to TF32 (10 mantissa bits,
  round to nearest, as the tensor cores read fp32 in TF32 mode) and the
  products summed in fp32.
- ``int_fp16`` for INT8, whose norms and quotient the library keeps in
  fp32: the dot product exact, each norm and the quotient rounded to fp16.
"""

from __future__ import annotations

import numpy as np
import torch

PRECISIONS = ("float64", "tf32", "int_fp16")


def control_precision(vtype: str) -> str:
    """The control's precision for a configuration of type ``vtype``."""
    return "int_fp16" if vtype == "INT8" else "tf32"


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32's 10-bit mantissa, to nearest, ties away
    from zero (the tensor cores' conversion)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _fp16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float16).to(torch.float64)


def _prepared(x: torch.Tensor, precision: str):
    """(operand, norms): rows or queries as ``precision`` scores them. The
    integer control keeps the raw values (float64 holds their dot products
    exactly) and fp16 norms; the others normalize and need no norms."""
    if precision == "int_fp16":
        x = x.to(torch.float64)
        return x, _fp16(torch.linalg.vector_norm(x, dim=1))
    return _normalized(x, precision), None


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
    """Exact top-k and per-row distances over ``rows`` (numpy fp32 or int8
    [n, D], the benchmark's rows as made) in ``precision``, computed on
    ``device`` in blocks of rows and of queries."""

    def __init__(self, rows: np.ndarray, device, precision: str = "float64",
                 row_block: int = 1 << 17, query_block: int = 4096):
        if precision not in PRECISIONS:
            raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
        self.precision = precision
        self.device = torch.device(device)
        self.row_block, self.query_block = row_block, query_block
        blocks = [_prepared(torch.from_numpy(rows[lo : lo + row_block]).to(self.device), precision)
                  for lo in range(0, rows.shape[0], row_block)]
        self.rows = torch.cat([b[0] for b in blocks])
        self.norms = None if blocks[0][1] is None else torch.cat([b[1] for b in blocks])

    def _queries(self, queries: np.ndarray):
        return _prepared(torch.from_numpy(queries).to(self.device), self.precision)

    @staticmethod
    def _distance(ip: torch.Tensor, denom) -> torch.Tensor:
        """1 - cosine from the dot products ``ip`` (float64; or fp32 sums of
        TF32 operands, config turning TF32 off) of normalized operands, or of
        raw ones over the product ``denom`` of their fp16 norms."""
        if denom is None:
            return 1.0 - ip
        return 1.0 - _fp16(ip / denom)

    def topk(self, queries: np.ndarray, k: int):
        """(distances [m, k] float64, rows [m, k] int64) of the exact top-k,
        numpy, in (distance, row) order."""
        out_d, out_i = [], []
        for qlo in range(0, queries.shape[0], self.query_block):
            q, qn = self._queries(queries[qlo : qlo + self.query_block])
            best_d = best_i = None
            for lo in range(0, self.rows.shape[0], self.row_block):
                hi = lo + self.row_block
                denom = None if qn is None else qn[:, None] * self.norms[None, lo:hi]
                d = self._distance(q @ self.rows[lo:hi].T, denom)
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
            q, qn = self._queries(queries[lo : lo + per])
            r = torch.from_numpy(rows[lo : lo + per]).to(self.device)
            x = self.rows[r]  # [b, j, D]
            denom = None if qn is None else qn[:, None] * self.norms[r]
            d = self._distance(torch.einsum("bd,bjd->bj", q, x), denom)
            out[lo : lo + per] = d.double().cpu().numpy()
        return out
