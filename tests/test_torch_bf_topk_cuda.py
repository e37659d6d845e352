"""The group-min kernel on the card: against its plain version, and the flat
index on a CUDA store against the same index on the CPU.

Every test here needs an NVIDIA card and skips elsewhere. The file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/test_torch_bf_topk_cuda.py -q

(``--noconftest``: ``tests/conftest.py`` sets up JAX for the other files.)
The kernel and its plain version both compute in IEEE fp32, in different
summation orders: group minima agree within 1e-5.
"""

import numpy as np
import pytest
import torch

from torch_port_common import TOL, assert_replies_parity, unit_rows
from vectorsimilarity_tpu_torch import config
from vectorsimilarity_tpu_torch.indexes.brute_force import BruteForceIndex
from vectorsimilarity_tpu_torch.ops.kernels import bf_topk as bfk
from vectorsimilarity_tpu_torch.types import BFParams, VecSimMetric, VecSimType

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda:0")


# (B, N, D, tile_n, G, count): odd batches, counts off the tile grid, a dim
# that is not a multiple of 4 (the kernel's scalar load path), G below and
# above the kernel's 128-column block.
SHAPES = [(37, 1024, 40, 128, 16, 1000), (1, 4096, 37, 1024, 256, 3001),
          (130, 2048, 64, 512, 128, 2048)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("metric", ["L2", "IP", "Cosine"])
def test_kernel_matches_plain(card, metric, shape):
    B, N, D, tile_n, G, count = shape
    gen = torch.Generator(device=card).manual_seed(B + D)
    x = torch.nn.functional.normalize(torch.randn((N, D), generator=gen, device=card), dim=1)
    q = torch.nn.functional.normalize(torch.randn((B, D), generator=gen, device=card), dim=1)
    sqn = (x * x).sum(1) if metric == "L2" else None
    kw = dict(metric=VecSimMetric[metric], tile_n=tile_n, group_n=G)
    before = bfk.group_min_scores.launches
    got = bfk.group_min_scores(q, x, sqn, count, **kw)
    ref = bfk.group_min_scores_ref(q, x, sqn, count, **kw)
    torch.cuda.synchronize()
    assert bfk.group_min_scores.launches == before + 1
    assert got.shape == ref.shape == (B, (N // tile_n) * G)
    assert torch.equal(torch.isinf(got), torch.isinf(ref))
    fin = torch.isfinite(ref)
    assert float((got[fin] - ref[fin]).abs().max()) <= TOL


@pytest.mark.parametrize("metric", ["L2", "IP", "Cosine"])
def test_index_on_card_matches_index_on_cpu(card, metric, monkeypatch):
    monkeypatch.setattr(config, "tile_n", 256)
    monkeypatch.setattr(config, "gm_group_n", 32)
    rng = np.random.default_rng(3)
    x, q = unit_rows(rng, 1500, 48), unit_rows(rng, 9, 48)
    params = BFParams(type=VecSimType.FLOAT32, dim=48, metric=VecSimMetric[metric])
    gpu, cpu = BruteForceIndex(params, device=card), BruteForceIndex(params)
    for idx in (gpu, cpu):
        idx.add_vector_batch(x, range(1500))
        for lab in range(0, 1500, 7):
            idx.delete_vector(lab)
    before = bfk.group_min_scores.launches
    assert_replies_parity(gpu.topk_query_batch(q, 10), cpu.topk_query_batch(q, 10))
    assert bfk.group_min_scores.launches == before + 1
    assert_replies_parity(gpu.topk_query_batch(q, 64), cpu.topk_query_batch(q, 64))
