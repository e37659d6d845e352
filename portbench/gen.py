"""Seeded embedding-like rows, made on the device.

A frozen copy of the port's ``utils/synthetic.py`` ``embedding_like``, so
that a change to the program cannot change the data it is measured on.
Ambient dimension D, intrinsic dimension d (48, the middle of the 30-100
that real embedding corpora such as dbpedia-768 show), a Gaussian latent, a
random linear map and small ambient noise, each row normalized.

A configuration's ``type`` decides what the rows and queries are: FLOAT32
the unit rows as made; INT8 the same rows quantized with the
configuration's one global ``quant_scale`` (``quantize``), as an embedding
model that returns int8 does.
"""

from __future__ import annotations

import torch

QUERY_SEED_OFFSET = 0x9E3779B9  # the query latents' seed: apart from the corpus's
LABEL_SEED_OFFSET = 0x7F4A7C15  # the label permutation's seed
QUANT_LIMIT = 127  # int8 codes lie in [-127, 127], symmetric about 0


def quantize(x: torch.Tensor, scale: float) -> torch.Tensor:
    """int8 ``clamp(round(x * scale), -127, 127)`` (round half to even)."""
    return torch.clamp(torch.round(x * scale), -QUANT_LIMIT, QUANT_LIMIT).to(torch.int8)


def clip_share(x: torch.Tensor, scale: float) -> float:
    """The share of the components of fp32 ``x`` that ``quantize`` clips."""
    return float((torch.round(x * scale).abs() > QUANT_LIMIT).double().mean())


def embedding_like(generator: torch.Generator, n: int, dim: int, intrinsic_dim: int = 48,
                   noise: float = 0.05, *, latent_generator: torch.Generator | None = None,
                   chunk: int = 1 << 16, quant_scale: float | None = None) -> torch.Tensor:
    """[n, dim] fp32 unit rows on ``generator``'s device, or with
    ``quant_scale`` the same rows quantized to int8. The projection comes
    from ``generator``; the latents and the noise from ``latent_generator``
    when given (rows on the same manifold), else from ``generator``. Made
    ``chunk`` rows at a time into one buffer, each chunk quantized as it is
    made, so the fp32 rows of an int8 corpus are never whole on the device."""
    device = generator.device
    proj = torch.randn((intrinsic_dim, dim), generator=generator, device=device)
    proj /= float(intrinsic_dim) ** 0.5
    lat = latent_generator if latent_generator is not None else generator
    out = torch.empty((n, dim), dtype=torch.float32 if quant_scale is None else torch.int8,
                      device=device)
    for lo in range(0, n, chunk):
        m = min(chunk, n - lo)
        z = torch.randn((m, intrinsic_dim), generator=lat, device=device)
        x = z @ proj
        if noise:
            x += noise * torch.randn((m, dim), generator=lat, device=device)
        x /= torch.linalg.vector_norm(x, dim=1, keepdim=True)
        out[lo : lo + m] = x if quant_scale is None else quantize(x, quant_scale)
    return out


def _generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def make_data(cfg: dict, traffic: dict, seed: int, device) -> dict:
    """The cell's inputs from ``seed``: the corpus rows [n, D], a held-out
    query pool [pool_batches * batch, D] on the corpus's manifold (the same
    projection, latents seeded apart) and a label per row (a seeded
    permutation of 0..n-1, so labels are not row ids). Rows and queries stay
    on ``device``: fp32 for a FLOAT32 configuration; for an INT8 one, int8,
    each quantized with its ``quant_scale``. Labels are numpy int64."""
    kind = cfg["type"]
    if kind not in ("FLOAT32", "INT8"):
        raise ValueError(f"no data of type {kind!r}: FLOAT32 or INT8")
    scale = float(cfg["quant_scale"]) if kind == "INT8" else None
    n, dim = int(cfg["n_rows"]), int(cfg["dim"])
    d, noise = int(cfg["intrinsic_dim"]), float(cfg["noise"])
    rows = embedding_like(_generator(device, seed), n, dim, d, noise, quant_scale=scale)
    pool = embedding_like(_generator(device, seed), int(traffic["pool_batches"]) * int(traffic["batch"]),
                          dim, d, noise, quant_scale=scale,
                          latent_generator=_generator(device, seed + QUERY_SEED_OFFSET))
    perm = torch.randperm(n, generator=_generator("cpu", seed + LABEL_SEED_OFFSET))
    return {"rows": rows, "queries": pool, "labels": perm.numpy().astype("int64")}
