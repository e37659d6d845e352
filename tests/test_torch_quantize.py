"""The port's quantizers (``ops/quantize.py``) against the JAX package's, on
the CPU, on the same numpy rows:

- SQ8, SQ4 and residual codes, and their (vmin, delta) scales, are
  bit-equal (the same operation order, half-to-even rounding); the row sums
  agree within 1e-5;
- ``pack4`` gives the same bytes and ``unpack4`` inverts it, at odd and
  even D;
- the decodes and ``gathered_recon_dists`` over one and two layers agree
  within 1e-5;
- ``leanvec_train``'s projector P P^T agrees within 1e-4 and P has
  orthonormal columns (each eigenvector is defined up to its sign, so the
  columns are not compared one by one).
"""

import numpy as np
import pytest
import torch

from torch_port_common import np_of
from vectorsimilarity_tpu.ops import quantize as jq
from vectorsimilarity_tpu_torch.ops import quantize as tq

TOL = 1e-5


def _rows(seed, n, d, scale=1.0):
    rng = np.random.default_rng(seed)
    x = (scale * rng.standard_normal((n, d))).astype(np.float32)
    x[0] = 0.25  # a constant row: delta falls back to 1
    return x


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.mark.parametrize("d", [31, 32])
@pytest.mark.parametrize("name", ["sq8", "sq4"])
def test_codes_bit_equal(name, d):
    x = _rows(1, 96, d, scale=3.0)
    got = getattr(tq, f"{name}_quantize")(_t(x))
    want = getattr(jq, f"{name}_quantize")(x)
    for g, w in zip(got[:3], want[:3]):  # codes, vmin, delta
        assert np.array_equal(np_of(g), np_of(w))
    for g, w in zip(got[3:], want[3:]):  # xsum, xsumsq
        np.testing.assert_allclose(np_of(g), np_of(w), rtol=TOL, atol=TOL)
    assert getattr(tq, f"{name}_quantize")(_t(x), with_sumsq=False)[4] is None


@pytest.mark.parametrize("bits", [4, 8])
def test_residual_codes_bit_equal(bits):
    x = _rows(2, 80, 33)
    codes, vmin, delta, _, _ = jq.sq4_quantize(x)
    recon = np_of(jq.sq4_reconstruct(codes, vmin, delta, 33))
    got = tq.residual_quantize(_t(x), _t(recon), bits)
    want = jq.residual_quantize(x, recon, bits)
    for g, w in zip(got, want):
        assert np.array_equal(np_of(g), np_of(w))


@pytest.mark.parametrize("d", [7, 8])
def test_pack4_roundtrip(d):
    codes = np.random.default_rng(3).integers(0, 16, size=(5, 3, d)).astype(np.uint8)
    packed = tq.pack4(_t(codes))
    assert np.array_equal(np_of(packed), np_of(jq.pack4(codes)))
    assert packed.shape[-1] == (d + 1) // 2
    un = tq.unpack4(packed)
    assert np.array_equal(np_of(un)[..., :d], codes)
    assert (np_of(un)[..., d:] == 0).all()


def test_reconstruct_and_query_meta():
    x = _rows(4, 64, 21)
    c8, v8, d8, _, _ = tq.sq8_quantize(_t(x))
    np.testing.assert_allclose(np_of(tq.sq8_reconstruct(c8, v8, d8)),
                               np_of(jq.sq8_reconstruct(np_of(c8), np_of(v8), np_of(d8))),
                               atol=1e-6)
    c4, v4, d4, _, _ = tq.sq4_quantize(_t(x))
    np.testing.assert_allclose(np_of(tq.sq4_reconstruct(c4, v4, d4, 21)),
                               np_of(jq.sq4_reconstruct(np_of(c4), np_of(v4), np_of(d4), 21)),
                               atol=1e-6)
    for g, w in zip(tq.sq8_query_meta(_t(x)), jq.sq8_query_meta(x)):
        np.testing.assert_allclose(np_of(g), np_of(w), rtol=TOL, atol=TOL)


def _layers(x, two_level: bool, primary_bits: int):
    """(numpy layers, packed flags) of rows x: one SQ8 layer, or a primary
    at ``primary_bits`` and its 8-bit residual."""
    if not two_level:
        c, v, d = jq.residual_quantize(x, np.zeros_like(x), 8)
        return ((np_of(c), np_of(v), np_of(d)),), (False,)
    q = jq.sq4_quantize if primary_bits == 4 else jq.sq8_quantize
    c, v, d, _, _ = q(x)
    recon = (jq.sq4_reconstruct(c, v, d, x.shape[1]) if primary_bits == 4
             else jq.sq8_reconstruct(c, v, d))
    rc, rv, rd = jq.residual_quantize(x, np_of(recon), 8)
    return (((np_of(c), np_of(v), np_of(d)), (np_of(rc), np_of(rv), np_of(rd))),
            (primary_bits == 4, False))


@pytest.mark.parametrize("l2", [True, False], ids=["L2", "IP"])
@pytest.mark.parametrize("layers", ["one", "two_q4", "two_q8"])
def test_gathered_recon_dists(layers, l2):
    x = _rows(5, 200, 25)
    x[0] = np.linspace(-1, 1, 25)
    q = _rows(6, 6, 25)
    ids = np.random.default_rng(7).integers(0, 200, size=(6, 17)).astype(np.int32)
    lay, packed = _layers(x, layers != "one", 4 if layers == "two_q4" else 8)
    xsq = (x * x).sum(1).astype(np.float32)
    want = jq.gathered_recon_dists(q, ids, lay, xsq, metric_is_l2=l2, packed_flags=packed)
    tlay = tuple(tuple(_t(a) for a in layer) for layer in lay)
    got = tq.gathered_recon_dists(_t(q), _t(ids), tlay, _t(xsq), metric_is_l2=l2,
                                  packed_flags=packed)
    np.testing.assert_allclose(np_of(got), np_of(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("ldim", [8, 16])
def test_leanvec_projector(ldim):
    # Rows with well-separated principal scales: every eigenvector is then
    # defined up to its sign, and the projector P P^T exactly.
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((300, 32)) * np.linspace(4.0, 0.1, 32)).astype(np.float32)
    p = np_of(tq.leanvec_train(_t(x), ldim)).astype(np.float64)
    pj = np_of(jq.leanvec_train(x, ldim)).astype(np.float64)
    assert p.shape == (32, ldim)
    np.testing.assert_allclose(p.T @ p, np.eye(ldim), atol=1e-4)
    np.testing.assert_allclose(p @ p.T, pj @ pj.T, atol=1e-4)
    proj = np_of(tq.leanvec_project(_t(x), _t(pj.astype(np.float32))))
    np.testing.assert_allclose(proj, np_of(jq.leanvec_project(x, pj.astype(np.float32))),
                               rtol=1e-4, atol=1e-4)
