"""The flat index's kernels on the card: each kernel and scoring lane against
its plain version, and the flat index on a CUDA store against the same index
on the CPU for each store type and k band.

Every test here needs an NVIDIA card and skips elsewhere. The file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/port/test_torch_bf_topk_cuda.py -q

(``--noconftest``: ``tests/conftest.py`` sets up JAX for the other files.)
Float lanes: kernel and plain version both sum in fp32, in different orders
(the tensor-core K1's fp32 lane multiplies as a 3xTF32 split, within 2^-20
relative of fp32 products), so distances agree within 1e-5 and ids except at
near-ties. Integer lanes are exact on both sides: L2 and IP must be equal;
Cosine rounds one fp32 divide and is held to 1e-6. K1, K3 and K4 each have
two kernels: the tensor-core one where ``config.gm_tc_ok`` admits the shape
(K4: and ``tile_n`` is a multiple of 128), the CUDA-core one elsewhere; every
case checks which one launched.
"""

import numpy as np
import pytest
import torch

from torch_port_common import TOL, assert_replies_parity, assert_topk_parity, unit_rows
from vectorsimilarity_tpu_torch import config
from vectorsimilarity_tpu_torch.indexes.brute_force import BruteForceIndex
from vectorsimilarity_tpu_torch.ops.kernels import bf_topk as bfk
from vectorsimilarity_tpu_torch.types import BFParams, VecSimMetric, VecSimType

pytestmark = pytest.mark.cuda

LANES = ["f32", "bf16", "f16", "s8", "u8"]
METRICS = ["L2", "IP", "Cosine"]
_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16, "f16": torch.float16,
           "s8": torch.int8, "u8": torch.uint8}
_VTYPES = {"f32": VecSimType.FLOAT32, "bf16": VecSimType.BFLOAT16, "f16": VecSimType.FLOAT16,
           "s8": VecSimType.INT8, "u8": VecSimType.UINT8}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda:0")


def _rows(rng, n, d, lane, small=False):
    """numpy rows of a lane: unit vectors, or integers (``small``: values
    0..2, so that distances tie)."""
    if lane == "s8":
        return rng.integers(0 if small else -128, 3 if small else 128, size=(n, d)).astype(np.int8)
    if lane == "u8":
        return rng.integers(0, 3 if small else 256, size=(n, d)).astype(np.uint8)
    return unit_rows(rng, n, d)


def _case(card, lane, metric, B, N, D, seed, small=False):
    """(q, x, aux, query_norms, metric) on the card for one lane and metric."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(_rows(rng, N, D, lane, small)).to(card, _DTYPES[lane])
    q = torch.from_numpy(_rows(rng, B, D, lane, small)).to(card, _DTYPES[lane])
    aux = qn = None
    if lane in ("s8", "u8"):
        if metric == "Cosine":
            aux = x.double().square().sum(1).float().sqrt().clamp(min=1.0)
            qn = q.double().square().sum(1).float().sqrt().clamp(min=1.0)
    elif metric == "L2":
        aux = x.float().square().sum(1)
    return q, x, aux, qn, VecSimMetric[metric]


def _assert_lists(lane, metric, got, ref):
    """Sorted (distance, id) lists [B, m] of a kernel against its plain
    version. ``ref`` may hold one slot more, the plain version's next pair:
    appended to the kernel's lists it makes their last slot count as a
    near-tie when the plain m-th and (m+1)-th distances are one."""
    (d, i), (rd, ri) = got, ref
    m = d.shape[1]
    if lane in ("s8", "u8") and metric != "Cosine":
        assert torch.equal(d, rd[:, :m]) and torch.equal(i, ri[:, :m])
    else:
        d, i = torch.cat([d, rd[:, m:]], dim=1), torch.cat([i, ri[:, m:]], dim=1)
        assert_topk_parity(d, i, rd, ri, 1e-6 if lane in ("s8", "u8") else TOL)


# Few test items on purpose: each loops over lanes, metrics and shapes itself
# and names the failing case in its assertion message.
#
# Group minima (B, N, D, tile_n, G, count): odd batches, counts off the tile
# grid, dims that are not a multiple of 4 or 16 (the scalar load paths), G
# below and above the kernel's 128-column block.
GM_SHAPES = [(37, 1024, 40, 128, 16, 1000), (1, 4096, 37, 1024, 256, 3001),
             (130, 2048, 64, 512, 128, 2048)]
# Per-tile top-c on the CUDA-core K4 (B, N, D, tile_n, c, count): a tile
# shorter than the kernel's 128-row sub-tile, odd rows (no lane's row is a
# multiple of 16 bytes), count inside a tile, count below one tile, c =
# tile_n.
TOPC_SHAPES = [(37, 1024, 40, 64, 16, 1000), (1, 4096, 37, 1024, 32, 3001),
               (130, 2048, 63, 512, 128, 300), (7, 512, 47, 128, 128, 512)]
# Per-tile top-c every lane's tensor-core K4 takes (B, N, D, tile_n, c,
# count): B = 1, 7, 130, 1024; tile_n = 128, 512, 4096; c = 1, 32, 128; a
# count inside a tile, counts that leave whole tiles empty, count = 0;
# ranges of one tile (B = 1, 7) and of several (B = 130 over 125 live
# tiles: 3 a range, the last 2 tiles past every range; B = 1024: 2).
TOPC_TC_SHAPES = [(1, 8192, 768, 4096, 32, 7001), (7, 4096, 96, 512, 128, 1500),
                  (130, 2048, 48, 128, 1, 2000), (130, 16384, 48, 128, 32, 16000),
                  (130, 4096, 96, 512, 32, 0), (1024, 65536, 64, 4096, 32, 60000)]
# Fused top-k (B, N, D, count, k): N off the 128-row grid, k > count, k = 128;
# D = 37 and (in the byte lanes) 40 and 48 go to the CUDA-core K3.
FUSED_SHAPES = [(37, 3000, 40, 2500, 100), (7, 2048, 37, 50, 64), (130, 5000, 64, 5000, 128),
                (1, 70000, 48, 69999, 33)]
# Fused top-k every lane's tensor-core K3 takes (B, N, D, count, k, bound):
# B = 1, 7, 130, counts off the 128-row grid and off the ranges, m = 1, 32,
# 40, 100, 128, k > count, count = 0, K4's m = 32 on ranges of 6,912 rows
# (one list per range, not per 4096 rows); ``bound``: the slot of the plain
# version's list that sets the lower bound (None: no bound).
FUSED_TC_SHAPES = [(1, 70000, 64, 69001, 128, None), (7, 3000, 96, 2900, 40, 17),
                   (130, 20000, 48, 19999, 100, None), (130, 9000, 128, 8800, 1, None),
                   (7, 40000, 64, 39999, 128, 60), (1, 5000, 768, 4999, 100, 3),
                   (7, 2048, 64, 50, 64, None), (3, 1000, 64, 0, 10, None),
                   (130, 300000, 64, 299001, 32, None)]
# Group minima every lane's tensor-core K1 takes (B, N, D, tile_n, G, count):
# B = 1, 7, 130, counts off the grid, G below and above its 128 columns.
GM_TC_SHAPES = [(1, 8192, 768, 4096, 256, 7001), (7, 4096, 96, 1024, 256, 3999),
                (130, 2048, 48, 512, 128, 2000), (130, 1024, 768, 128, 16, 1000)]


def _gm_counts():
    return bfk.group_min_scores.tc_launches, bfk.group_min_scores.launches


def _gm_expect(lane, D):
    """(tensor-core, CUDA-core) launches one K1 call must add."""
    return (1, 0) if config.gm_tc_ok(D, _DTYPES[lane]) else (0, 1)


def _gm_case(card, lane, metric, shape):
    B, N, D, tile_n, G, count = shape
    q, x, aux, qn, m = _case(card, lane, metric, B, N, D, seed=B + D)
    kw = dict(metric=m, tile_n=tile_n, group_n=G, query_norms=qn)
    got = bfk.group_min_scores(q, x, aux, count, **kw)
    ref = bfk.group_min_scores_ref(q, x, aux, count, **kw)
    assert got.shape == ref.shape == (B, (N // tile_n) * G)
    assert torch.equal(torch.isinf(got), torch.isinf(ref))
    fin = torch.isfinite(ref)
    if lane in ("s8", "u8") and metric != "Cosine":
        assert torch.equal(got[fin], ref[fin])
    else:
        assert float((got[fin] - ref[fin]).abs().max()) <= (1e-6 if lane in ("s8", "u8") else TOL)


def _topc_case(card, lane, metric, shape):
    B, N, D, tile_n, c, count = shape
    q, x, aux, qn, m = _case(card, lane, metric, B, N, D, seed=B + D + 1)
    kw = dict(metric=m, tile_n=tile_n, query_norms=qn)
    d, i = bfk.tile_topc(q, x, aux, count, c=c, **kw)
    # The plain version's next pair too, where the tile has one: the
    # tensor-core fp32 lane rounds apart from the plain IEEE fp32 (3xTF32),
    # so a tile's c-th slot may hold a near-tie's other pair.
    cr = min(c + 1, tile_n)
    rd, ri = bfk.tile_topc_ref(q, x, aux, count, c=cr, **kw)
    assert d.shape == i.shape == (B, N // tile_n, c) and i.dtype == torch.int32
    _assert_lists(lane, metric, (d.reshape(-1, c), i.reshape(-1, c)),
                  (rd.reshape(-1, cr), ri.reshape(-1, cr)))


def _topc_counts():
    return bfk.tile_topc.tc_launches, bfk.tile_topc.launches


def _fused_counts():
    return bfk.fused_topk.tc_launches, bfk.fused_topk.launches


def _fused_expect(lane, D):
    """(tensor-core, CUDA-core) launches one K3 call must add."""
    return (1, 0) if config.gm_tc_ok(D, _DTYPES[lane]) else (0, 1)


def _lower_bound(lane, metric, rd, ri, slot):
    """(lo_d, lo_i) from the plain version's lists of at least slot + 9
    pairs: the pair at ``slot`` in the exact lanes (the id rule decides),
    else, with id 0, the middle of the widest gap between slots slot ..
    slot + 8, so that the two sides' roundings cannot put a row on different
    sides of the bound."""
    if lane in ("s8", "u8") and metric != "Cosine":
        return rd[:, slot].contiguous(), ri[:, slot].contiguous()
    seg = rd[:, slot:slot + 9].double()
    j = torch.diff(seg, dim=1).argmax(dim=1, keepdim=True)
    mid = (seg.gather(1, j) + seg.gather(1, j + 1)) / 2
    return mid[:, 0].float().contiguous(), torch.zeros_like(ri[:, slot])


def _fused_case(card, lane, metric, shape):
    B, N, D, count, k = shape[:5]
    bound = shape[5] if len(shape) > 5 else None
    q, x, aux, qn, m = _case(card, lane, metric, B, N, D, seed=B + D + 2)
    kw = dict(metric=m, query_norms=qn)
    if bound is not None:
        rd, ri = bfk.fused_topk_ref(q, x, aux, count, bound + 9, **kw)
        kw["lo"] = _lower_bound(lane, metric, rd, ri, bound)
    got = bfk.fused_topk(q, x, aux, count, k, **kw)
    ref = bfk.fused_topk_ref(q, x, aux, count, k + 1, **kw)
    assert got[0].shape == (B, k) and got[1].dtype == torch.int32
    _assert_lists(lane, metric, got, ref)


@pytest.mark.parametrize("kernel", ["gm", "fused", "fused_tc", "topc", "topc_tc"])
def test_kernel_matches_plain(card, kernel):
    # (case, shapes, launch counters, the counters' expected moves)
    case, shapes, counts, expect = {
        "gm": (_gm_case, GM_SHAPES, _gm_counts, _gm_expect),
        "fused": (_fused_case, FUSED_SHAPES, _fused_counts, _fused_expect),
        "fused_tc": (_fused_case, FUSED_TC_SHAPES, _fused_counts, lambda lane, D: (1, 0)),
        "topc": (_topc_case, TOPC_SHAPES, _topc_counts, lambda lane, D: (0, 1)),
        "topc_tc": (_topc_case, TOPC_TC_SHAPES, _topc_counts, lambda lane, D: (1, 0)),
    }[kernel]
    for lane in LANES:
        for metric in METRICS:
            for shape in shapes:
                before = counts()
                try:
                    case(card, lane, metric, shape)
                    torch.cuda.synchronize()
                except AssertionError as err:
                    raise AssertionError(f"{kernel} {lane} {metric} {shape}: {err}") from err
                moved = tuple(a - b for a, b in zip(counts(), before))
                assert moved == expect(lane, shape[2]), (kernel, lane, shape, moved)


@pytest.mark.parametrize("lane", LANES)
def test_tc_group_min_matches_plain(card, lane):
    for metric in METRICS:
        for shape in GM_TC_SHAPES:
            before = _gm_counts()
            try:
                _gm_case(card, lane, metric, shape)
                torch.cuda.synchronize()
            except AssertionError as err:
                raise AssertionError(f"gm_tc {lane} {metric} {shape}: {err}") from err
            assert tuple(a - b for a, b in zip(_gm_counts(), before)) == (1, 0)


@pytest.mark.parametrize("lane", LANES)
def test_tc_group_min_ties_and_masked_groups(card, lane):
    # Every row the same: all scores of a query tie. count = 100 of 2048 rows
    # with tile_n = 512, G = 128: groups 100..127 of tile 0 and every group of
    # the later tiles have no live row and must come out +inf.
    B, N, D, tile_n, G, count = 9, 2048, 64, 512, 128, 100
    row = np.arange(D) % 3 if lane in ("s8", "u8") else np.full(D, D ** -0.5)
    x = torch.from_numpy(np.tile(row, (N, 1))).to(card, _DTYPES[lane])
    q = x[:B].clone()
    for metric in METRICS:
        aux = qn = None
        if lane in ("s8", "u8") and metric == "Cosine":
            aux = x.double().square().sum(1).float().sqrt()
            qn = q.double().square().sum(1).float().sqrt()
        elif lane not in ("s8", "u8") and metric == "L2":
            aux = x.float().square().sum(1)
        kw = dict(metric=VecSimMetric[metric], tile_n=tile_n, group_n=G, query_norms=qn)
        before = _gm_counts()
        got = bfk.group_min_scores(q, x, aux, count, **kw)
        ref = bfk.group_min_scores_ref(q, x, aux, count, **kw)
        assert tuple(a - b for a, b in zip(_gm_counts(), before)) == (1, 0)
        dead = torch.ones((N // tile_n, G), dtype=torch.bool, device=card)
        dead[0, :count] = False
        dead = dead.flatten()
        assert torch.isinf(got[:, dead]).all() and torch.isfinite(got[:, ~dead]).all()
        assert torch.equal(torch.isinf(got), torch.isinf(ref))
        fin = torch.isfinite(ref)
        live = got[fin].view(B, -1)
        assert torch.equal(live, live[:, :1].expand_as(live))  # all ties stay ties
        tol = TOL if lane not in ("s8", "u8") else 1e-6 if metric == "Cosine" else 0.0
        assert float((got[fin] - ref[fin]).abs().max()) <= tol, (lane, metric)


@pytest.mark.parametrize("lane", ["s8", "u8"])
def test_ties_come_out_in_id_order(card, lane):
    # Rows with values 0..2 in 8 dims: most distances tie, so every list is
    # decided by the id rule: inside a list, across the fused kernel's row
    # ranges, across the chained passes' lower bound, and in the top-c merge.
    q, x, _, _, m = _case(card, lane, "L2", 9, 8192, 8, seed=5, small=True)
    for k in (100, 300):
        d, i = bfk.topk_fused(q, x, None, 8000, k, metric=m)
        rd, ri = bfk.topk_fused(q.cpu(), x.cpu(), None, 8000, k, metric=m)
        assert torch.equal(d.cpu(), rd) and torch.equal(i.cpu(), ri)
        assert all(len(set(row)) == k for row in i.tolist())
    d, i, t = bfk.topk_bigk(q, x, None, 8000, 300, metric=m, tile_n=256, local_c=64)
    rd, ri, rt = bfk.topk_bigk(q.cpu(), x.cpu(), None, 8000, 300, metric=m, tile_n=256,
                               local_c=64)
    assert torch.equal(t.cpu(), rt)
    assert torch.equal(d.cpu(), rd) and torch.equal(i.cpu(), ri)


@pytest.mark.parametrize("lane", LANES)
def test_tc_fused_chain_k300_no_id_lost_or_repeated(card, lane):
    # k = 300 chains three passes on the tensor-core K3, each above the last
    # pair of the pass before: a pair that scored differently in two passes
    # would repeat or vanish. Held against the plain version's chain.
    for metric in METRICS:
        q, x, aux, qn, m = _case(card, lane, metric, 9, 30000, 64, seed=11)
        before = _fused_counts()
        d, i = bfk.topk_fused(q, x, aux, 29999, 300, metric=m, query_norms=qn)
        assert tuple(a - b for a, b in zip(_fused_counts(), before)) == (3, 0)
        rd, ri = bfk.fused_topk_ref(q, x, aux, 29999, 301, metric=m, query_norms=qn)
        assert all(len(set(row)) == 300 for row in i.tolist()), (lane, metric)
        _assert_lists(lane, metric, (d, i.to(torch.int32)), (rd, ri))


@pytest.mark.parametrize("lane", LANES)
def test_tc_fused_all_ties_in_id_order_across_ranges(card, lane):
    # Every row the same: every distance ties, so each list is decided by the
    # id rule inside a range, across the kernel's ranges (B = 1 cuts 70,000
    # rows into many) and across the chained passes' lower bound.
    N, D, count = 70000, 64, 69001
    row = np.arange(D) % 3 if lane in ("s8", "u8") else np.full(D, D ** -0.5)
    x = torch.from_numpy(np.tile(row, (N, 1))).to(card, _DTYPES[lane])
    q = x[:1].clone()
    assert bfk._fused_tc_ranges(1, count, 132)[1] > 1
    for k in (100, 300):
        before = _fused_counts()
        d, i = bfk.topk_fused(q, x, None, count, k, metric=VecSimMetric.IP)
        assert tuple(a - b for a, b in zip(_fused_counts(), before)) == (-(-k // 128), 0)
        assert torch.equal(i.cpu(), torch.arange(k)[None, :]), (lane, k)
        assert torch.equal(d, d[:, :1].expand_as(d))


def test_fused_counters_follow_the_gate(card):
    # The tensor-core K3 launches only where the gate admits the rows: D = 37
    # (no lane's row is a multiple of 16 bytes), D = 40 in the byte lanes and
    # a view whose base is off 16 bytes go to the CUDA-core K3.
    for lane, D, offset, want in (("f32", 37, 0, (0, 1)), ("s8", 40, 0, (0, 1)),
                                  ("f32", 40, 0, (1, 0)), ("s8", 48, 0, (1, 0)),
                                  ("bf16", 64, 1, (0, 1)), ("bf16", 64, 0, (1, 0))):
        q, x, _, _, m = _case(card, lane, "IP", 5, 2000, D, seed=D)
        x = x.flatten()[offset:offset + 1999 * D].view(1999, D)
        assert bfk.fused_tc_admits(q, x) == (want == (1, 0))
        before = _fused_counts()
        d, i = bfk.fused_topk(q, x, None, 1999, 50, metric=m)
        assert tuple(a - b for a, b in zip(_fused_counts(), before)) == want, (lane, D, offset)
        _assert_lists(lane, "IP", (d, i), bfk.fused_topk_ref(q, x, None, 1999, 51, metric=m))


def test_fused_lower_bound_between_two_distances(card):
    # A bound halfway between the 40th and 41st distance: the pass returns
    # the 41st on.
    q, x, _, _, m = _case(card, "f32", "Cosine", 5, 3000, 32, seed=8)
    rd, ri = bfk.fused_topk_ref(q, x, None, 3000, 80, metric=m)
    lo = (((rd[:, 39] + rd[:, 40]) / 2).contiguous(),
          torch.zeros(5, dtype=torch.int32, device=card))
    d, i = bfk.fused_topk(q, x, None, 3000, 40, metric=m, lo=lo)
    assert_topk_parity(d, i, rd[:, 40:], ri[:, 40:])


def test_bigk_truncation_falls_back_exactly(card):
    # All near rows in one tile: that tile's 16th best lies inside the global
    # top-40, the flag fires, and the exact wrapper answers from the scan.
    rng = np.random.default_rng(7)
    target = unit_rows(rng, 1, 16)
    near = target + 0.01 * rng.standard_normal((64, 16)).astype(np.float32)
    x = np.concatenate([near, rng.standard_normal((192, 16)).astype(np.float32)])
    x = torch.from_numpy(x / np.linalg.norm(x, axis=1, keepdims=True)).to(card)
    q = torch.from_numpy(target).to(card)
    kw = dict(metric=VecSimMetric.Cosine, tile_n=64, local_c=16)
    assert bool(bfk.topk_bigk(q, x, None, 256, 40, **kw)[2].any())
    before = bfk.topk_bigk_exact.fallbacks
    d, i = bfk.topk_bigk_exact(q, x, None, 256, 40, kind="float", **kw)
    assert bfk.topk_bigk_exact.fallbacks == before + 1
    rd, ri = bfk.fused_topk_ref(q, x, None, 256, 40, metric=VecSimMetric.Cosine)
    assert_topk_parity(d, i, rd, ri)


def test_default_device_is_the_card(card):
    idx = BruteForceIndex(BFParams(type=VecSimType.FLOAT32, dim=8, metric=VecSimMetric.L2))
    assert idx.store.device.type == "cuda"
    idx.add_vector(np.ones(8, np.float32), 3)
    assert idx.store.device_arrays()["data"].is_cuda
    assert idx.topk_query(np.ones(8, np.float32), 1).ids.tolist() == [3]


@pytest.mark.parametrize("lane", LANES)
def test_index_on_card_matches_index_on_cpu(card, lane, monkeypatch):
    monkeypatch.setattr(config, "tile_n", 256)
    monkeypatch.setattr(config, "gm_group_n", 32)
    rng = np.random.default_rng(3)
    x, q = _rows(rng, 1500, 48, lane), _rows(rng, 9, 48, lane)
    tol = 1e-6 if lane in ("s8", "u8") else TOL
    counts = lambda: (*_gm_counts(), *_fused_counts(), *_topc_counts())
    for metric in METRICS:
        params = BFParams(type=_VTYPES[lane], dim=48, metric=VecSimMetric[metric])
        gpu, cpu = BruteForceIndex(params, device=card), BruteForceIndex(params, device="cpu")
        for idx in (gpu, cpu):
            idx.add_vector_batch(x, range(1500))
            for lab in range(0, 1500, 7):
                idx.delete_vector(lab)
        # k = 10, 64 and 200 run the tensor-core K1, K3 and K4 (D = 48 passes
        # their gate in every lane, tile_n = 256 K4's).
        for k, want in ((10, (1, 0, 0, 0, 0, 0)), (64, (0, 0, 1, 0, 0, 0)),
                        (200, (0, 0, 0, 0, 1, 0))):
            before = counts()
            assert_replies_parity(gpu.topk_query_batch(q, k), cpu.topk_query_batch(q, k), tol)
            assert tuple(a - b for a, b in zip(counts(), before)) == want, (metric, k)
