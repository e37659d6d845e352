"""Synthetic embedding-like datasets, generated on the device.

Counterpart of ``vectorsimilarity_tpu/utils/synthetic.py``. Uniform random
high-dimensional vectors are a pathological ANN benchmark; real embedding
corpora (dbpedia-768, the reference's primary benchmark) have intrinsic
dimension around 30-100. The generator models that: ambient dimension D,
intrinsic dimension d, Gaussian latent, random linear map, small ambient
noise. It draws from explicit ``torch.Generator``s, so a seed fixes the data
(the bits differ from the JAX generator's for the same seed).
"""

from __future__ import annotations

from typing import Optional

import torch


def embedding_like(generator: torch.Generator, n: int, dim: int, intrinsic_dim: int = 48,
                   noise: float = 0.05, *, out: Optional[torch.Tensor] = None,
                   normalize: bool = True, latent_generator: Optional[torch.Generator] = None,
                   chunk: int = 1 << 16) -> torch.Tensor:
    """[n, dim] fp32 embedding-like vectors on ``generator``'s device.

    The projection comes from ``generator``; the latent and the noise come
    from ``latent_generator`` when given (held-out QUERIES on the corpus's
    manifold without regenerating the corpus), else from ``generator``.
    Rows are made ``chunk`` at a time into ``out`` (allocated when None; a
    larger, zero-padded buffer may be passed, of which the first n rows are
    filled), so no full-size temporary is held beside the result.
    """
    device = generator.device
    proj = torch.randn((intrinsic_dim, dim), generator=generator, device=device)
    proj /= float(intrinsic_dim) ** 0.5
    lat = latent_generator if latent_generator is not None else generator
    if out is None:
        out = torch.empty((n, dim), dtype=torch.float32, device=device)
    for lo in range(0, n, chunk):
        m = min(chunk, n - lo)
        z = torch.randn((m, intrinsic_dim), generator=lat, device=device)
        x = z @ proj
        if noise:
            x += noise * torch.randn((m, dim), generator=lat, device=device)
        if normalize:
            x /= torch.linalg.vector_norm(x, dim=1, keepdim=True)
        out[lo : lo + m] = x
    return out
