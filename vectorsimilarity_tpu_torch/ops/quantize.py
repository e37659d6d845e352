"""Scalar and LVQ-style quantization of stored rows, and the rerank that
scores against their decode.

Counterpart of ``vectorsimilarity_tpu/ops/quantize.py`` (the reference's
``QuantPreprocessor``, ``spaces/computer/preprocessors.h:150-330``, and the
SVS ``quantBits`` modes, ``vec_sim_common.h:170-179``). Stored rows become
uint8 codes with per-row (min, delta) scales kept as separate columns;
queries stay float and carry (sum y, sum y^2) for the asymmetric distance.

- SQ8: 255 steps per row, ``round((x - min) * (1 / delta))``;
- SQ4 (LVQ level 1): 15 steps, ``round((x - min) / delta)``, two codes per
  byte in the SPLIT layout: byte i holds code i in its low nibble and code
  i + ceil(D/2) in its high nibble (odd D pads the tail with code 0), so an
  unpack is a mask, a shift and a concatenation;
- a residual level re-quantizes the level-1 error at 4 or 8 bits (the
  two-level modes); LeanVec projects rows onto the top principal directions
  of a sample first.

Each operation keeps the JAX package's order (a multiply by ``1 / delta`` for
SQ8, a divide for SQ4 and the residual), and ``torch.round`` rounds half to
even as ``jnp.round`` does, so codes computed on the CPU are bit-equal to the
JAX package's.
"""

from __future__ import annotations

from typing import Optional

import torch


def sq8_quantize(vecs: torch.Tensor, with_sumsq: bool = True):
    """Float rows [B, D] -> (codes u8, vmin, delta, xsum, xsumsq): delta =
    (max - min) / 255, or 1 where max == min; xsum and xsumsq are over the
    original fp32 values (``xsumsq`` only with ``with_sumsq``)."""
    x = vecs.to(torch.float32)
    vmin = torch.amin(x, dim=-1)
    vmax = torch.amax(x, dim=-1)
    diff = vmax - vmin
    delta = torch.where(diff == 0.0, torch.ones_like(diff), diff / 255.0)
    inv_delta = 1.0 / delta
    codes = torch.round((x - vmin[:, None]) * inv_delta[:, None])
    codes = torch.clamp(codes, 0.0, 255.0).to(torch.uint8)
    xsum = torch.sum(x, dim=-1)
    xsumsq = torch.sum(x * x, dim=-1) if with_sumsq else None
    return codes, vmin, delta, xsum, xsumsq


def sq8_query_meta(queries: torch.Tensor):
    """(sum y, sum y^2) of float queries, for the asymmetric distance."""
    q = queries.to(torch.float32)
    return torch.sum(q, dim=-1), torch.sum(q * q, dim=-1)


def sq8_reconstruct(codes: torch.Tensor, vmin: torch.Tensor, delta: torch.Tensor) -> torch.Tensor:
    """Decode: x_i ~ min + delta * q_i."""
    return vmin[:, None] + delta[:, None] * codes.to(torch.float32)


def pack4(codes: torch.Tensor) -> torch.Tensor:
    """Codes in [0, 15] [..., D] -> split-packed bytes [..., ceil(D/2)]; an
    odd D pads the tail with code 0."""
    d = codes.shape[-1]
    half = (d + 1) // 2
    pad = 2 * half - d
    if pad:
        codes = torch.cat([codes, codes.new_zeros((*codes.shape[:-1], pad))], dim=-1)
    lo = codes[..., :half]
    hi = codes[..., half:]
    return (lo | (hi << 4)).to(torch.uint8)


def unpack4(packed: torch.Tensor) -> torch.Tensor:
    """Split-packed bytes [..., H] -> codes [..., 2H] in [0, 15]."""
    return torch.cat([packed & 0x0F, packed >> 4], dim=-1)


def sq4_quantize(vecs: torch.Tensor, with_sumsq: bool = True):
    """Float rows [B, D] -> (packed u8 [B, ceil(D/2)], vmin, delta, xsum,
    xsumsq): ``sq8_quantize``'s scheme with 15 steps."""
    x = vecs.to(torch.float32)
    vmin = torch.amin(x, dim=-1)
    vmax = torch.amax(x, dim=-1)
    diff = vmax - vmin
    delta = torch.where(diff == 0.0, torch.ones_like(diff), diff / 15.0)
    codes = torch.round((x - vmin[:, None]) / delta[:, None])
    codes = torch.clamp(codes, 0.0, 15.0).to(torch.uint8)
    xsum = torch.sum(x, dim=-1)
    xsumsq = torch.sum(x * x, dim=-1) if with_sumsq else None
    return pack4(codes), vmin, delta, xsum, xsumsq


def sq4_reconstruct(packed: torch.Tensor, vmin: torch.Tensor, delta: torch.Tensor,
                    dim: int) -> torch.Tensor:
    """Decode packed 4-bit rows to float [B, dim]."""
    codes = unpack4(packed)[..., :dim]
    return vmin[:, None] + delta[:, None] * codes.to(torch.float32)


def residual_quantize(vecs: torch.Tensor, recon: torch.Tensor, bits: int):
    """Quantize the level-1 error ``vecs - recon`` at ``bits`` (4 or 8).
    Returns (codes, rvmin, rdelta), codes packed for 4 bits; the two-level
    decode is (vmin + delta * c1) + (rvmin + rdelta * c2)."""
    r = vecs.to(torch.float32) - recon.to(torch.float32)
    levels = float((1 << bits) - 1)
    rvmin = torch.amin(r, dim=-1)
    rmax = torch.amax(r, dim=-1)
    diff = rmax - rvmin
    rdelta = torch.where(diff == 0.0, torch.ones_like(diff), diff / levels)
    codes = torch.round((r - rvmin[:, None]) / rdelta[:, None])
    codes = torch.clamp(codes, 0.0, levels).to(torch.uint8)
    if bits == 4:
        codes = pack4(codes)
    return codes, rvmin, rdelta


def leanvec_train(sample: torch.Tensor, ldim: int) -> torch.Tensor:
    """Projection P [D, ldim] with orthonormal columns: the top-``ldim``
    eigenvectors of the uncentered second-moment matrix of ``sample``
    (stored rows are normalized or IP-scored, so the origin is meaningful).
    Each column is defined up to its sign, and within near-equal eigenvalues
    up to a rotation: two eigensolvers agree on the projector P P^T, not on
    P itself."""
    x = sample.to(torch.float32)
    cov = x.T @ x
    _, vecs = torch.linalg.eigh(cov)  # ascending eigenvalues
    return torch.flip(vecs, dims=(1,))[:, :ldim].contiguous()


def leanvec_project(vecs: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Rows into the primary space: [B, D] @ [D, L] -> [B, L]."""
    return vecs.to(torch.float32) @ p


def gathered_recon_dists(
    q: torch.Tensor,  # [B, D] float queries in the layers' space
    ids: torch.Tensor,  # [B, M] valid row indices (mask outside)
    layers: tuple,  # ((codes [N, *], vmin [N], delta [N]), ...)
    xsumsq: Optional[torch.Tensor],  # [N] sum x^2 in q's space (L2 only)
    *,
    metric_is_l2: bool,
    packed_flags: tuple,  # per layer: codes are 4-bit packed
) -> torch.Tensor:
    """Asymmetric distances [B, M] against a multi-layer quantized decode.

    Row r decodes to sum over layers of (vmin_l[r] + delta_l[r] * codes_l[r]),
    so its inner product with y telescopes into per-layer
    ``vmin * sum(y) + delta * (c . y)`` terms: one gather and one batched
    product per layer, never a float decode of the rows. One layer is the
    LeanVec secondary rerank, two the two-level LVQ rerank."""
    qf = q.to(torch.float32)
    ysum = torch.sum(qf, dim=-1)
    ip = None
    for (codes, vmin, delta), packed in zip(layers, packed_flags):
        c = codes[ids]  # [B, M, *]
        if packed:
            c = unpack4(c)
        qp = qf
        if qp.shape[-1] != c.shape[-1]:  # odd-dim pack padding
            qp = torch.cat([qp, qp.new_zeros((qp.shape[0], c.shape[-1] - qp.shape[-1]))], dim=1)
        qdot = torch.bmm(c.to(torch.float32), qp.unsqueeze(-1)).squeeze(-1)
        term = vmin[ids] * ysum[:, None] + delta[ids] * qdot
        ip = term if ip is None else ip + term
    if not metric_is_l2:
        return 1.0 - ip
    ysumsq = torch.sum(qf * qf, dim=-1)
    return xsumsq[ids] - 2.0 * ip + ysumsq[:, None]
