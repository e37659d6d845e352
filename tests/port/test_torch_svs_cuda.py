"""SVS-Vamana on the card against the same inputs on the CPU.

Every test here needs an NVIDIA card and skips elsewhere. The file imports
no JAX, so it also runs where JAX is not installed:

    python -m pytest --noconftest -m cuda tests/port/test_torch_svs_cuda.py -q

- The ``sq8`` / ``sq4`` gathers and the two-layer re-rank on the card agree
  with the CPU's within 1e-5 on the same codes.
- Codes computed on the card differ from the CPU's by at most one step, in
  at most 1 of 1,000 codes: a fused multiply-add on the card may round a
  code that sits at .5 the other way (the CPU's equal the JAX package's bit
  for bit, ``tests/port/test_torch_quantize.py``).
- A graph built on the CPU and carried to the card (``convert``) answers
  alike (labels equal, distances within 1e-5).
- A 10,000-row build per ``quantBits`` mode on the card reaches the JAX
  package's recall floors (0.75 for Q4, 0.85 else, ``tests/test_svs_quant.py``)
  against the exact answer, and deleted labels never answer.
- A tiered SVS index on the card answers its flat tier with the group-min
  kernel K1 while the training migration waits, then migrates.
"""

import threading

import numpy as np
import pytest
import torch

from torch_port_common import TOL, assert_replies_parity, embedding_rows
from vectorsimilarity_tpu_torch import config  # noqa: F401  (TF32 off, as the CPU)
from vectorsimilarity_tpu_torch import types as T
from vectorsimilarity_tpu_torch.convert import export_svs_state, svs_from_state
from vectorsimilarity_tpu_torch.indexes.factory import create_index
from vectorsimilarity_tpu_torch.ops import graph_search as gs
from vectorsimilarity_tpu_torch.ops import quantize as qz
from vectorsimilarity_tpu_torch.ops.kernels.bf_topk import group_min_scores
from vectorsimilarity_tpu_torch.utils.thread_pool import JobQueueThreadPool

pytestmark = pytest.mark.cuda

K = 10
ONE_STEP_SHARE = 1e-3  # codes the card may round one step away from the CPU


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda:0")


def _params(mode, dim, metric="Cosine", **kw):
    sp = dict(type=T.VecSimType.FLOAT32, dim=dim, metric=T.VecSimMetric[metric],
              quantBits=T.VecSimSvsQuantBits[mode], graph_max_degree=32,
              construction_window_size=100, search_window_size=64)
    sp.update(kw)
    return T.VecSimParams(algo=T.VecSimAlgo.SVS, svsParams=T.SVSParams(**sp))


@pytest.mark.parametrize("kind", ["sq8", "sq4"])
def test_quantized_gathers_match_the_cpu(card, kind):
    x = torch.from_numpy(embedding_rows(np.random.default_rng(0), 4000, 97))
    q = torch.from_numpy(embedding_rows(np.random.default_rng(1), 64, 97))
    quant = qz.sq4_quantize if kind == "sq4" else qz.sq8_quantize
    codes, vmin, delta, _, sq = quant(x)
    recon = (qz.sq4_reconstruct(codes, vmin, delta, 97) if kind == "sq4"
             else qz.sq8_reconstruct(codes, vmin, delta))
    res, rvmin, rdelta = qz.residual_quantize(x, recon, 8)
    ids = torch.from_numpy(np.random.default_rng(2).integers(-1, 4000, (64, 200)).astype(np.int32))
    meta = qz.sq8_query_meta(q)
    out = {}
    for dev in ("cpu", card):
        ctx = gs.StoreCtx(data=codes.to(dev), sqnorm=sq.to(dev), vmin=vmin.to(dev),
                          delta=delta.to(dev))
        d = gs.dists_to_ids(q.to(dev), ids.to(dev), ctx, metric=T.VecSimMetric.L2, kind=kind,
                            q_meta=tuple(m.to(dev) for m in meta))
        layers = ((codes.to(dev), vmin.to(dev), delta.to(dev)),
                  (res.to(dev), rvmin.to(dev), rdelta.to(dev)))
        r = qz.gathered_recon_dists(q.to(dev), ids.clamp(min=0).to(dev), layers, sq.to(dev),
                                    metric_is_l2=True, packed_flags=(kind == "sq4", False))
        out[str(dev)] = (d.cpu(), r.cpu())
    (dc, rc), (dg, rg) = out["cpu"], out[str(card)]
    assert torch.equal(torch.isinf(dc), torch.isinf(dg))
    fin = torch.isfinite(dc)
    assert (dc[fin] - dg[fin]).abs().max() <= TOL
    assert (rc - rg).abs().max() <= TOL


@pytest.mark.parametrize("name", ["sq8", "sq4", "res4", "res8"])
def test_card_codes_within_one_step(card, name):
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((20000, 100)).astype(np.float32))

    def codes(dev):
        xd = x.to(dev)
        if name.startswith("res"):
            c, v, d, _, _ = qz.sq4_quantize(x)
            recon = qz.sq4_reconstruct(c, v, d, 100).to(dev)  # the same level-1 decode
            out = qz.residual_quantize(xd, recon, int(name[3:]))[0]
            return qz.unpack4(out) if name == "res4" else out
        out = (qz.sq4_quantize if name == "sq4" else qz.sq8_quantize)(xd)[0]
        return qz.unpack4(out) if name == "sq4" else out

    cpu, gpu = codes("cpu"), codes(card).cpu()
    diff = (cpu.to(torch.int16) - gpu.to(torch.int16)).abs()
    assert int(diff.max()) <= 1
    assert float((diff > 0).float().mean()) <= ONE_STEP_SHARE


@pytest.mark.parametrize("mode", ["NONE", "Scalar", "Q4x8"])
def test_carried_graph_answers_alike(card, mode):
    x = embedding_rows(np.random.default_rng(4), 1500, 64)
    q = embedding_rows(np.random.default_rng(5), 32, 64)
    cpu = create_index(_params(mode, 64), device="cpu")
    cpu.add_vector_batch(x, list(range(len(x))))
    gpu = svs_from_state(export_svs_state(cpu), device=card)
    assert gpu.device.type == "cuda"
    assert_replies_parity(gpu.topk_query_batch(q, K), cpu.topk_query_batch(q, K))
    for lab in (3, 700, cpu.entry_id):
        assert gpu.delete_vector(lab) == cpu.delete_vector(lab)
    gpu._ensure_host_links()
    cpu._ensure_host_links()
    assert gpu.entry_id == cpu.entry_id
    n = cpu.store.count
    assert np.array_equal(gpu.store.host["links"][:n], cpu.store.host["links"][:n])


@pytest.mark.parametrize("mode", [m.name for m in T.VecSimSvsQuantBits])
def test_10k_build_per_mode(card, mode):
    n, dim = 10_000, 96
    gen = np.random.default_rng(6)
    x = embedding_rows(gen, n + 64, dim)
    data, q = x[:n], x[n:]
    idx = create_index(_params(mode, dim, metric="L2"))
    assert idx.device.type == "cuda"
    idx.bulk_build_device(torch.from_numpy(data).to(card))
    truth = np.argsort(((q[:, None, :] - data[None]) ** 2).sum(-1), axis=1, kind="stable")[:, :K]
    replies = idx.topk_query_batch(q, K)
    rec = np.mean([len(set(r.ids.tolist()) & set(t.tolist())) / K for r, t in zip(replies, truth)])
    assert rec >= (0.75 if mode == "Q4" else 0.85), rec
    gone = [int(t[0]) for t in truth[:8]]
    for lab in gone:
        assert idx.delete_vector(lab) == 1
    for r in idx.topk_query_batch(q, K):
        assert not set(gone) & set(r.ids.tolist())


def test_tiered_svs_flat_tier_runs_k1(card):
    dim, train = 64, 256
    x = embedding_rows(np.random.default_rng(7), train + 32, dim)
    pool = JobQueueThreadPool(1)
    gate = threading.Event()
    pool.submit_cb(None, None, [None], [lambda _: gate.wait(60)])
    try:
        params = T.TieredIndexParams(
            primaryIndexParams=_params("Q4x8", dim), jobQueue=pool, submitCb=pool.submit_cb,
            tieredSVSParams=T.TieredSVSParams(trainingTriggerThreshold=train,
                                              updateTriggerThreshold=32))
        idx = create_index(T.VecSimParams(algo=T.VecSimAlgo.TIERED, tieredParams=params))
        assert idx.device.type == "cuda" and idx.frontend.device == idx.device
        for i in range(train):
            idx.add_vector(x[i], i)
        group_min_scores.launches = group_min_scores.tc_launches = 0
        rep = idx.topk_query_batch(x[:16], K)
        assert group_min_scores.launches + group_min_scores.tc_launches > 0
        assert [int(r.ids[0]) for r in rep] == list(range(16))
        gate.set()
        assert pool.wait_for_quiescence(120)
        assert idx.frontend.index_size == 0 and idx.backend.index_size == train
        for i in range(train, train + 32):
            idx.add_vector(x[i], i)
        assert pool.wait_for_quiescence(120)
        assert idx.backend.index_size == train + 32 and idx.migrations == 2
        idx.delete_vector(5)
        idx.run_gc()
        assert idx.backend.index_size == train + 31
        assert 5 not in idx.topk_query(x[5], K).ids.tolist()
    finally:
        gate.set()
        pool.shutdown()
