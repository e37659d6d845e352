"""The port's HNSW write path against the JAX package's, on the CPU.

A copy of the suite's shared JAX build (``torch_port_common.jax_hnsw_index``,
384 x 16 fp32 Cosine, M = 8; copied through the JAX serializer, so the
shared index is never mutated) is carried across with
``convert.hnsw_from_jax``, and both packages apply the same writes in
``STEPS`` order:

- eager ``delete_vector`` calls, including the entry point's label and the
  last row's (a swap that moves nothing), and one of a missing label;
- an insert batch that overwrites 3 live labels (the eager branch, at most
  8) and one that overwrites 10 (tombstones and one bulk pass);
- ``mark_delete`` of 14 labels, then one ``delete_tombstoned_bulk``.

After each step the two graphs are equal row for row (``links0``, upper
links, labels, levels, flags, entry point, maximum level, the label map),
and ``topk_query_batch`` gives the same labels with distances within 1e-5.
The JAX answers are computed once, in the module fixture.

The port alone: an index built by ``bulk_build_device`` (its vectors
device-authoritative, the host mirror unfilled) takes the same deletes and
bulk removal as a host-built copy of it, with the same graph, rows and
answers after (the compaction keeps device-authoritative fields so).
"""

import numpy as np
import pytest
import torch

from torch_port_common import HNSW_N, assert_replies_parity, jax_hnsw_index, unit_rows
from vectorsimilarity_tpu import config as jconfig
from vectorsimilarity_tpu.utils.serializer import load_index, save_index
from vectorsimilarity_tpu_torch import config as tconfig
from vectorsimilarity_tpu_torch.convert import export_hnsw_state, hnsw_from_jax, hnsw_from_state

K = 10
QUERIES = unit_rows(np.random.default_rng(21), 16, 16)
NEW = unit_rows(np.random.default_rng(22), 16, 16)


def _eager(idx):
    last = int(idx.store.host["label"][idx.store.count - 1])
    entry = int(idx.store.host["label"][idx.entry_id])
    return [idx.delete_vector(lab) for lab in (5, entry, 100, last, 7, 5, 10_000)]


def _overwrite_few(idx):
    return idx.add_vector_batch(NEW[:4], [10, 11, 12, 1000])


def _overwrite_many(idx):
    return idx.add_vector_batch(NEW[4:16], list(range(20, 30)) + [2000, 2001])


def _bulk(idx):
    ids = []
    for lab in range(40, 82, 3):
        ids += idx.mark_delete(lab)
    return idx.delete_tombstoned_bulk(ids), len(ids), idx.num_marked_deleted


STEPS = {"eager": _eager, "overwrite_few": _overwrite_few,
         "overwrite_many": _overwrite_many, "bulk": _bulk}


def _graph(idx) -> dict:
    st = export_hnsw_state(idx)
    keep = ("label", "level", "upper_row", "links0", "nlinks0", "flags")
    return {"arrays": {n: st["arrays"][n] for n in keep}, "upper": st["upper"]["arrays"],
            "head": (st["entry_id"], st["max_level"], st["lmax"], st["num_marked_deleted"],
                     st["count"], st["upper"]["count"]),
            "labels": st["labels"]}


def _run(idx, cfg) -> dict:
    """Every step on ``idx``; per step its return value, graph and replies.
    Connect chunks of 4 rows: the overwrite batches take one chunk shape."""
    saved, cfg.build_batch = cfg.build_batch, 4
    try:
        out = {}
        for name, step in STEPS.items():
            ret = step(idx)
            out[name] = (ret, _graph(idx), idx.topk_query_batch(QUERIES, K))
        return out
    finally:
        cfg.build_batch = saved


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX observations, port observations), from one copy of the shared
    build carried to both packages."""
    path = str(tmp_path_factory.mktemp("hnsw") / "copy.npz")
    save_index(jax_hnsw_index()[0], path)
    jidx = load_index(path)
    tidx = hnsw_from_jax(jidx, device="cpu")
    return _run(jidx, jconfig), _run(tidx, tconfig)


def _assert_graph_equal(port: dict, ref: dict) -> None:
    assert port["head"] == ref["head"]
    assert port["labels"] == ref["labels"]
    for group in ("arrays", "upper"):
        for name, want in ref[group].items():
            got = port[group][name]
            bad = np.nonzero((got != want).reshape(len(want), -1).any(axis=1))[0]
            assert not len(bad), (group, name, bad[:8])


@pytest.mark.parametrize("step", list(STEPS))
def test_step_matches_jax(runs, step):
    (jret, jgraph, jreplies), (tret, tgraph, treplies) = runs[0][step], runs[1][step]
    assert tret == jret
    _assert_graph_equal(tgraph, jgraph)
    assert_replies_parity(treplies, jreplies)


def test_steps_do_what_they_say(runs):
    ref = runs[0]
    assert ref["eager"][0] == [1, 1, 1, 1, 1, 0, 0]
    assert ref["overwrite_few"][0] == 1 and ref["overwrite_many"][0] == 2
    removed, marked, left = ref["bulk"][0]
    assert removed == marked == left == 14  # the caller lowers the tombstone count
    count = ref["bulk"][1]["head"][4]
    assert count == HNSW_N - 5 + 1 + 2 - 14
    links0 = ref["bulk"][1]["arrays"]["links0"]
    assert links0.max() < count
    gone = {5, 100, 7} | set(range(40, 82, 3))
    for reply in ref["bulk"][2]:
        assert not gone & set(reply.ids.tolist())
    assert {10, 20, 29, 1000, 2000, 2001} <= set(ref["overwrite_many"][1]["labels"]["label_to_id"])


def _bulk_built(rows: np.ndarray):
    """A port index built by ``bulk_build_device`` on the CPU (the data
    column device-authoritative) and its host-built copy."""
    import vectorsimilarity_tpu_torch as tvs
    from torch_port_common import hnsw_params

    idx = tvs.create_index(hnsw_params(tvs), device="cpu")
    saved = tconfig.build_batch
    tconfig.build_batch = 64
    try:
        idx.bulk_build_device(torch.from_numpy(rows), batch=64, scan_batches=2)
    finally:
        tconfig.build_batch = saved
    copy = hnsw_from_state(export_hnsw_state(idx), device="cpu")
    # The export pulled the vectors to the host; make the device copy the
    # only one again, with a host mirror that poisons any use of it.
    idx.store.host["data"][:] = np.nan
    idx.store.mark_host_stale("data")
    return idx, copy


def test_device_authoritative_store_deletes_like_a_host_built_one():
    rows = unit_rows(np.random.default_rng(23), 200, 16)
    idx, copy = _bulk_built(rows)
    for i in (idx, copy):
        assert [i.delete_vector(lab) for lab in (3, 199, 50)] == [1, 1, 1]
        ids = []
        for lab in range(60, 120, 4):
            ids += i.mark_delete(lab)
        assert i.delete_tombstoned_bulk(ids) == 15
        assert i.add_vector_batch(NEW[:2], [0, 500]) == 1  # eager overwrite
    assert "data" in idx.store._host_stale and "data" not in copy.store._host_stale
    _assert_graph_equal(_graph(idx), _graph(copy))
    dev = idx.store.device_arrays()["data"][: idx.store.count].numpy()
    assert np.array_equal(dev, copy.store.device_arrays()["data"][: copy.store.count].numpy())
    assert_replies_parity(idx.topk_query_batch(QUERIES, K), copy.topk_query_batch(QUERIES, K))
    # The device copy holds each live label's own row.
    src = {**dict(enumerate(rows)), 0: NEW[0], 500: NEW[1]}
    want = np.stack([src[int(lab)] for lab in idx.store.host["label"][: idx.store.count]])
    assert np.allclose(dev, want, atol=1e-6)
