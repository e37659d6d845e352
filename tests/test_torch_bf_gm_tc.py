"""The tensor-core group-min kernel's arithmetic on the CPU
(``csrc/bf_topk_gm_tc.cu``: fp32 as a 3xTF32 split) and its gate.

The kernel needs the card (``test_torch_bf_topk_cuda.py`` holds it against
the plain version there). Here:

- ``split_tf32``, the kernel's split written in PyTorch: hi + lo rebuilds x
  within max(2^-22 |x|, 2^-137), and the three-term product sum over
  D = 768 stays within the kernel's stated bound, 2^-20 * sum |q_i x_i|,
  against float64 (9.5e-7 for unit vectors, under the host's 1e-5 eps);
- group minima scored with the emulated split (three fp32 products, fp32
  sums) against the JAX package's own bf16_3x scoring (``_tile_scores``,
  the body of its Pallas kernel) and a float64 model, within 1e-5; the
  host part ``topk_gm`` on them against ``pallas_topk_gm`` in interpret
  mode: covered, same ids, distances within 1e-5;
- the gate ``config.gm_tc_ok`` over the dims and types the smoke uses.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import TOL, assert_topk_parity, np_of, unit_rows
from vectorsimilarity_tpu.ops.pallas.bf_topk import _tile_scores, pallas_topk_gm
from vectorsimilarity_tpu.types import VecSimMetric as JM
from vectorsimilarity_tpu_torch import config
from vectorsimilarity_tpu_torch.ops.kernels import bf_topk as bfk
from vectorsimilarity_tpu_torch.types import VecSimMetric as TM

T = torch.from_numpy
SPLIT_REL = 2.0 ** -22  # |x - hi - lo| / |x|, normal inputs
SPLIT_ABS = 2.0 ** -137  # |x - hi - lo|, subnormal inputs (and lo subnormal)
DOT_REL = 2.0 ** -20  # the kernel source's bound on a dot product's split error


def _inputs(kind: str, rng) -> np.ndarray:
    n = 1 << 14
    if kind == "random":
        return (rng.standard_normal(n) * 10.0 ** rng.uniform(-30, 30, n)).astype(np.float32)
    if kind == "ties":  # the 13 dropped bits are exactly half a TF32 ulp
        bits = (rng.integers(0x00800000, 0x7F000000, n) & ~0x1FFF) | 0x1000
        sign = rng.integers(0, 2, n).astype(np.int64) << 31
        return (bits | sign).astype(np.uint32).view(np.float32)
    if kind == "large":  # exponents up to 2^126, below the top TF32 value
        return (rng.uniform(1.0, 1.99, n) * 2.0 ** rng.integers(100, 127, n)
                * rng.choice([-1.0, 1.0], n)).astype(np.float32)
    bits = rng.integers(1, 0x00800000, n) | (rng.integers(0, 2, n).astype(np.int64) << 31)
    return bits.astype(np.uint32).view(np.float32)  # subnormal


@pytest.mark.parametrize("kind", ["random", "ties", "large", "subnormal"])
def test_split_tf32_rebuilds_x(kind):
    x = _inputs(kind, np.random.default_rng(len(kind)))
    hi, lo = (np_of(t) for t in bfk.split_tf32(T(x)))
    for part in (hi, lo):
        assert not (part.view(np.uint32) & 0x1FFF).any()  # TF32: low 13 bits zero
    err = np.abs(x.astype(np.float64) - hi.astype(np.float64) - lo.astype(np.float64))
    assert (err <= np.maximum(SPLIT_REL * np.abs(x.astype(np.float64)), SPLIT_ABS)).all()
    if kind == "ties":  # ties round away from zero
        assert (np.abs(hi.astype(np.float64)) > np.abs(x.astype(np.float64))).all()
    if kind == "subnormal":
        assert err.max() <= SPLIT_ABS


@pytest.mark.parametrize("scale", [1.0, 1e-3, 1e3])
def test_3xtf32_dot_within_stated_bound(scale):
    rng = np.random.default_rng(7)
    q, x = unit_rows(rng, 16, 768) * scale, unit_rows(rng, 512, 768)
    (qh, ql), (xh, xl) = bfk.split_tf32(T(q)), bfk.split_tf32(T(x))
    d = lambda a, b: np_of(a).astype(np.float64) @ np_of(b).astype(np.float64).T
    exact = q.astype(np.float64) @ x.astype(np.float64).T
    absdot = np.abs(q.astype(np.float64)) @ np.abs(x.astype(np.float64)).T
    split = d(ql, xh) + d(qh, xl) + d(qh, xh)  # every product exact in float64
    assert (np.abs(split - exact) <= DOT_REL * absdot).all()
    assert (DOT_REL * absdot).max() < 1e-5 * max(scale, 1.0)
    # With fp32 sums, as the kernel's accumulators: still inside the eps.
    f32 = np_of(ql @ xh.T + qh @ xl.T + qh @ xh.T).astype(np.float64)
    assert np.abs(f32 - exact).max() <= 1e-5 * max(scale, 1.0)


def _gm_3xtf32(q, x, count, metric, tile_n, g):
    """Group minima scored as the tensor-core kernel's fp32 lane: three
    fp32 products of the split operands, fp32 sums, the float epilogue."""
    (qh, ql), (xh, xl) = bfk.split_tf32(T(q)), bfk.split_tf32(T(x))
    ip = ql @ xh.T + qh @ xl.T + qh @ xh.T
    if metric == "L2":
        s = T((q * q).sum(1))[:, None] - 2.0 * ip + T((x * x).sum(1))[None, :]
    else:
        s = 1.0 - ip
    s[:, count:] = float("inf")
    B, N = s.shape
    return s.view(B, N // tile_n, tile_n // g, g).amin(dim=2).reshape(B, -1)


def _gm_jax_bf16_3x(q, x, count, metric, tile_n, g):
    """The JAX kernel's group minima: its own scoring body ``_tile_scores``
    in mode bf16_3x over the whole store, the count mask, the group min."""
    N = x.shape[0]
    qaux = jnp.asarray((q * q).sum(1, keepdims=True))
    sqn = jnp.asarray((x * x).sum(1))
    s = np.array(_tile_scores(JM[metric], "bf16_3x", N, jnp.asarray(q), qaux, jnp.asarray(x),
                              sqn))
    s[:, count:] = np.inf
    return s.reshape(q.shape[0], N // tile_n, tile_n // g, g).min(axis=2).reshape(q.shape[0], -1)


def _gm_float64(q, x, count, metric, tile_n, g):
    q64, x64 = q.astype(np.float64), x.astype(np.float64)
    ip = q64 @ x64.T
    s = ((q64 * q64).sum(1)[:, None] - 2 * ip + (x64 * x64).sum(1)[None, :]
         if metric == "L2" else 1.0 - ip)
    s[:, count:] = np.inf
    return s.reshape(q.shape[0], x.shape[0] // tile_n, tile_n // g, g).min(axis=2).reshape(
        q.shape[0], -1)


TILE_N, GROUP_N = 128, 16


def _store(seed=31):
    rng = np.random.default_rng(seed)
    return unit_rows(rng, 1024, 96), unit_rows(rng, 6, 96)


@pytest.mark.parametrize("metric,count", [("Cosine", 1024), ("L2", 1000), ("IP", 777)])
def test_3xtf32_group_minima_match_jax_and_float64(metric, count):
    x, q = _store()
    got = np_of(_gm_3xtf32(q, x, count, metric, TILE_N, GROUP_N))
    for ref in (_gm_jax_bf16_3x(q, x, count, metric, TILE_N, GROUP_N),
                _gm_float64(q, x, count, metric, TILE_N, GROUP_N)):
        assert np.array_equal(np.isinf(got), np.isinf(ref))
        fin = np.isfinite(ref)
        assert np.abs(got[fin] - ref[fin]).max() <= TOL


def test_topk_gm_on_3xtf32_minima_matches_pallas(monkeypatch):
    """The host part on the emulated minima: covered, with the ids of
    ``pallas_topk_gm`` in interpret mode (one metric: the host part is the
    same code for all three, which test_torch_bf_topk.py covers)."""
    x, q = _store()
    count, k = 1000, 10
    emulated = lambda qq, xx, sq, c, *, metric, tile_n, group_n, query_norms=None: \
        _gm_3xtf32(np_of(qq), np_of(xx), c, metric.name, tile_n, group_n)
    monkeypatch.setattr(bfk, "group_min_scores", emulated)
    d, i, u = bfk.topk_gm(T(q), T(x), None, count, k, metric=TM.Cosine, tile_n=TILE_N,
                          group_n=GROUP_N)
    rd, ri, ru = pallas_topk_gm(jnp.asarray(q), jnp.asarray(x), None, jnp.int32(count), k,
                                metric=JM.Cosine, tile_n=TILE_N, group_n=GROUP_N, interpret=True)
    assert not np_of(u).any() and not np_of(ru).any()
    assert_topk_parity(d, i, rd, ri)


# (dim, dtype, admitted): the smoke's and the card tests' dims. TMA needs a
# row of a multiple of 16 bytes.
GATE = [(d, t, d * torch.empty((), dtype=t).element_size() % 16 == 0)
        for d in (37, 40, 48, 64, 96, 100, 768)
        for t in (torch.float32, torch.bfloat16, torch.float16, torch.int8, torch.uint8)]


@pytest.mark.parametrize("dim,dtype,admitted", GATE)
def test_gm_tc_gate(dim, dtype, admitted):
    assert config.gm_tc_ok(dim, dtype) is admitted
    if dim in (37, 40) and dtype in (torch.int8, torch.uint8):
        assert not admitted  # the smoke's deliberate CUDA-core shapes
    x = torch.zeros((64, dim), dtype=dtype)
    assert bfk.gm_tc_admits(x[:2], x) is admitted
    # A view whose base is not 16-byte aligned goes to the CUDA-core kernel.
    flat = torch.zeros(64 * dim + 1, dtype=dtype)[1:].view(64, dim)
    assert not bfk.gm_tc_admits(flat[:2].contiguous(), flat)


def test_gm_tc_gate_refuses_other_types():
    assert not config.gm_tc_ok(768, torch.float64)
    assert not config.gm_tc_ok(0, torch.float32)
