"""Multi-device dry run of the port: ``dryrun_multichip(n_devices)``.

Counterpart of ``__graft_entry__.dryrun_multichip``, step for step, each
step checked against numpy:

1. the raw ``sharded_topk`` after a sharded row ingest (one new row written
   into every shard);
2. the sharded flat lifecycle (``BruteForceIndex.to_sharded``: add, delete
   with swap-with-last, query);
3. query-sharded HNSW (``to_query_sharded``: an odd batch, padded, equal to
   the unsharded answers);
4. ``ShardedHNSW``: add, delete, query.

The mesh is ``[device] * n_devices``. Like every entry point of the port,
it runs on the current CUDA device unless the caller names another, and
raises where there is none; ``device="cpu"`` runs it on the CPU.

    python -m vectorsimilarity_tpu_torch.dryrun [n_devices] [device]
"""

from __future__ import annotations

import sys

import numpy as np
import torch


def dryrun_multichip(n_devices: int, device=None) -> None:
    from . import (
        BFParams, HNSWParams, VecSimAlgo, VecSimMetric, VecSimParams, VecSimType, create_index,
    )
    from .parallel.sharded_graph import ShardedHNSW
    from .core.abstract_index import resolve_device
    from .parallel.sharding import make_mesh, shard_rows, sharded_topk

    device = resolve_device(device)
    mesh = make_mesh([device] * n_devices)
    D, K, B = 32, 5, 4
    shard_rows_n = 64
    N = shard_rows_n * n_devices
    rng = np.random.default_rng(1)
    base = rng.standard_normal((N, D)).astype(np.float32)
    queries = rng.standard_normal((B, D)).astype(np.float32)
    data = shard_rows(torch.from_numpy(base.copy()), mesh)
    sqn = shard_rows(torch.from_numpy((base * base).sum(-1)), mesh)

    # --- write step: a fresh row into every shard, in place.
    new_rows = rng.standard_normal((n_devices, D)).astype(np.float32)
    idx = torch.arange(0, N, shard_rows_n, dtype=torch.int64)  # one row per shard
    data.write_rows(idx, torch.from_numpy(new_rows))
    sqn.write_rows(idx, torch.from_numpy((new_rows * new_rows).sum(-1)))
    base[idx.numpy()] = new_rows

    # --- read step: sharded exact top-k, merged on the mesh's first device.
    _, ids = sharded_topk(torch.from_numpy(queries), (data, sqn), N, K,
                          metric=VecSimMetric.L2, kind="float", mesh=mesh)
    ids = ids.cpu().numpy()
    ref = ((queries[:, None, :] - base[None, :, :]) ** 2).sum(-1)
    want = np.argsort(ref, axis=1)[:, :K]
    for b in range(B):
        assert set(ids[b].tolist()) == set(want[b].tolist()), (b, ids[b], want[b])

    # --- the sharded flat lifecycle through the public API.
    idx2 = create_index(VecSimParams(algo=VecSimAlgo.BF, bfParams=BFParams(
        type=VecSimType.FLOAT32, dim=D, metric=VecSimMetric.L2)), device=device)
    idx2.to_sharded(mesh)
    n2 = 600
    data2 = rng.standard_normal((n2, D)).astype(np.float32)
    idx2.add_vector_batch(data2, list(range(n2)))
    for lab in range(0, n2, 3):
        idx2.delete_vector(lab)
    live = np.asarray([lab for lab in range(n2) if lab % 3 != 0])
    rep = idx2.topk_query(data2[live[7]], K)
    ref2 = ((data2[live] - data2[live[7]]) ** 2).sum(-1)
    want2 = set(live[np.argsort(ref2)[:K]].tolist())
    assert set(rep.ids.tolist()) == want2, (rep.ids, want2)

    # --- query-sharded HNSW: an odd batch, the same answers as unsharded.
    g = create_index(VecSimParams(algo=VecSimAlgo.HNSWLIB, hnswParams=HNSWParams(
        type=VecSimType.FLOAT32, dim=D, metric=VecSimMetric.L2,
        M=8, efConstruction=60, efRuntime=40)), device=device)
    n3 = 300
    data3 = rng.standard_normal((n3, D)).astype(np.float32)
    g.add_vector_batch(data3, list(range(n3)))
    qs = rng.standard_normal((2 * n_devices + 1, D)).astype(np.float32)
    base_ids = [r.ids.tolist() for r in g.topk_query_batch(qs, K)]
    g.to_query_sharded(mesh)
    for b, r in enumerate(g.topk_query_batch(qs, K)):
        assert r.ids.tolist() == base_ids[b], (b, r.ids, base_ids[b])

    # --- the data-sharded graph: add -> delete -> query.
    sg = ShardedHNSW(HNSWParams(
        type=VecSimType.FLOAT32, dim=D, metric=VecSimMetric.L2,
        M=8, efConstruction=60, efRuntime=48), mesh)
    n4 = 400
    data4 = rng.standard_normal((n4, D)).astype(np.float32)
    sg.add_vector_batch(data4, list(range(n4)))
    for lab in range(0, n4, 5):
        sg.delete_vector(lab)
    rep = sg.topk_query(data4[1], K)
    live4 = np.asarray([lab for lab in range(n4) if lab % 5 != 0])
    ref4 = ((data4[live4] - data4[1]) ** 2).sum(-1)
    want4 = set(live4[np.argsort(ref4)[:K]].tolist())
    assert set(rep.ids.tolist()) == want4, (rep.ids, want4)

    print(f"dryrun_multichip OK on {n_devices} x {device}: top-{K} matches numpy "
          f"(sharded scan + sharded index lifecycle + query-sharded graph + "
          f"data-sharded graph)")


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 8,
                     sys.argv[2] if len(sys.argv) > 2 else None)
