"""The port's ``BlockStore`` against a numpy model of its rows.

The model is a dict of numpy arrays holding rows [0, count) in id order, with
the reference's swap-with-last deletion. After every operation the store's
device copy (``device_arrays``, synced in place) and, after ``pull_host``,
its host mirrors must hold exactly the model's rows.
"""

import numpy as np
import pytest
import torch

from vectorsimilarity_tpu_torch.core.store import BlockStore, FieldSpec

DIM = 6
BLOCK = 1024  # the smallest capacity bucket


def _fields():
    return {"data": FieldSpec((DIM,), np.float32), "label": FieldSpec((), np.int64, fill=-1)}


class Model:
    def __init__(self):
        self.rows = {"data": np.zeros((0, DIM), np.float32), "label": np.zeros(0, np.int64)}

    @property
    def count(self):
        return len(self.rows["label"])

    def append(self, rows):
        self.rows = {n: np.concatenate([self.rows[n], rows[n]]) for n in self.rows}

    def set_row(self, idx, row):
        for n in self.rows:
            self.rows[n][idx] = row[n]

    def swap_delete(self, idx):
        for a in self.rows.values():
            a[idx] = a[-1]
        self.rows = {n: a[:-1] for n, a in self.rows.items()}


def _rows(rng, n, start):
    return {"data": rng.standard_normal((n, DIM)).astype(np.float32),
            "label": np.arange(start, start + n, dtype=np.int64)}


def _assert_device(store, model):
    dev = store.device_arrays()
    assert store.count == model.count
    for n, want in model.rows.items():
        assert dev[n].shape[0] == store.capacity
        assert np.array_equal(dev[n][: model.count].numpy(), want), n


def _assert_host(store, model):
    store.pull_host()
    for n, want in model.rows.items():
        assert np.array_equal(store.host[n][: model.count], want), n


def _adopted(rng, count, cap=BLOCK):
    """A store whose data/label came in on the device (adopt_device)."""
    store, model = BlockStore(_fields(), BLOCK), Model()
    rows = _rows(rng, count, 0)
    model.append(rows)
    arrays = {}
    for n, a in rows.items():
        full = np.full((cap, *a.shape[1:]), 0, a.dtype)
        full[:count] = a
        arrays[n] = torch.from_numpy(full)
    store.adopt_device(arrays, count=count)
    return store, model


@pytest.mark.parametrize("adopt", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_random_ops_match_numpy_model(adopt, seed):
    rng = np.random.default_rng(seed)
    if adopt:
        store, model = _adopted(rng, 700)
    else:
        store, model = BlockStore(_fields(), BLOCK), Model()
    next_label = 10_000
    for step in range(300):
        op = rng.integers(0, 10)
        if op < 3 or model.count < 4:
            n = int(rng.integers(1, 40))
            rows = _rows(rng, n, next_label)
            next_label += n
            ids = store.append(rows)
            assert ids.tolist() == list(range(model.count, model.count + n))
            model.append(rows)
        elif op < 5:
            idx = int(rng.integers(0, model.count))
            row = {k: v[0] for k, v in _rows(rng, 1, next_label).items()}
            next_label += 1
            store.set_row(idx, row)
            model.set_row(idx, row)
        else:
            idx = int(rng.integers(0, model.count))
            if rng.random() < 0.2:
                idx = model.count - 1  # deleting the last row moves nothing
            assert store.swap_delete(idx) == model.count - 1
            model.swap_delete(idx)
            if rng.random() < 0.3:
                store.maybe_shrink()
        if step % 25 == 0:
            _assert_device(store, model)
    _assert_device(store, model)
    _assert_host(store, model)
    _assert_device(store, model)


def test_deferred_moves_apply_in_one_sync_and_host_writes_win():
    rng = np.random.default_rng(2)
    store, model = _adopted(rng, 900)
    for idx in (5, 17, 5, 300):  # chains: row 5 receives two moves
        store.swap_delete(idx)
        model.swap_delete(idx)
    assert store._pending_moves["data"]  # recorded, not yet applied
    row = {k: v[0] for k, v in _rows(rng, 1, 50_000).items()}
    store.set_row(17, row)  # a host write to a moved-into row is newer
    model.set_row(17, row)
    _assert_device(store, model)
    assert not store._pending_moves["data"]
    _assert_host(store, model)


def test_growth_and_shrink_keep_rows():
    rng = np.random.default_rng(3)
    store, model = _adopted(rng, 1000)
    store.swap_delete(3)
    model.swap_delete(3)
    rows = _rows(rng, 200, 20_000)  # past the 1024-row bucket: grows to 2048
    store.append(rows)
    model.append(rows)
    assert store.capacity == 2 * BLOCK
    _assert_device(store, model)
    for _ in range(700):
        idx = int(rng.integers(0, model.count))
        store.swap_delete(idx)
        model.swap_delete(idx)
    store.maybe_shrink()
    assert store.capacity == BLOCK
    _assert_device(store, model)
    _assert_host(store, model)


def test_pull_host_keeps_host_authoritative_rows():
    # adopt_device -> append -> swap_delete(2) -> pull_host: row 2 now holds
    # the appended row, which so far exists only on the host. The JAX
    # store's pull_host overwrites rows [0, count) with the device copy and
    # so brings the deleted row's old content back into row 2; the port
    # keeps the host's newer row, as the model does.
    rng = np.random.default_rng(4)
    store, model = _adopted(rng, 5)
    rows = _rows(rng, 1, 100)
    store.append(rows)
    model.append(rows)
    store.swap_delete(2)
    model.swap_delete(2)
    store.pull_host()
    assert np.array_equal(store.host["data"][2], rows["data"][0])
    assert store.host["label"][2] == 100
    for n, want in model.rows.items():
        assert np.array_equal(store.host[n][: model.count], want), n
    _assert_device(store, model)


def test_adopt_device_checks_and_memory_bytes():
    store = BlockStore(_fields(), BLOCK)
    with pytest.raises(ValueError, match="capacity bucket"):
        store.adopt_device({"data": torch.zeros((1000, DIM))}, count=10)
    with pytest.raises(ValueError, match="float32"):
        store.adopt_device({"data": torch.zeros((BLOCK, DIM), dtype=torch.float64)}, count=10)
    store.adopt_device({"data": torch.zeros((BLOCK, DIM))}, count=10)
    dev = store.device_arrays()
    assert dev["label"].shape == (BLOCK,) and dev["label"].dtype == torch.int64
    host = BLOCK * DIM * 4 + BLOCK * 8
    assert store.memory_bytes == 2 * host  # host mirrors + device copies


def test_mark_host_stale_pulls_device_writes():
    rng = np.random.default_rng(5)
    store, model = BlockStore(_fields(), BLOCK), Model()
    rows = _rows(rng, 10, 0)
    store.append(rows)
    model.append(rows)
    dev = store.device_arrays()
    dev["data"][:3] += 1.0  # written on the device, in place
    model.rows["data"][:3] += 1.0
    store.mark_host_stale("data")
    _assert_host(store, model)
    _assert_device(store, model)


@pytest.mark.parametrize("adopt", [False, True])
def test_add_field_joins_moves_and_sync(adopt):
    # A field added after construction (the tiered frontend's op ids) starts
    # host-authoritative at its fill, re-uploads every field at the next
    # sync without losing device-authoritative rows, and then moves with
    # swap-with-last like any other field.
    rng = np.random.default_rng(6)
    if adopt:
        store, model = _adopted(rng, 40)
        store.swap_delete(7)  # a deferred move pending on the adopted fields
        model.swap_delete(7)
    else:
        store, model = BlockStore(_fields(), BLOCK), Model()
        rows = _rows(rng, 40, 0)
        store.append(rows)
        model.append(rows)
        _assert_device(store, model)
    store.add_field("opid", FieldSpec((), np.int64, fill=-1))
    with pytest.raises(ValueError, match="exists"):
        store.add_field("opid", FieldSpec((), np.int64))
    model.rows["opid"] = np.full(model.count, -1, np.int64)
    assert not store._pending_moves["opid"] and "opid" not in store._host_stale
    _assert_device(store, model)
    store.host["opid"][: model.count] = np.arange(model.count) + 500
    for i in range(model.count):
        store.mark_dirty(i, "opid")
    model.rows["opid"] = np.arange(model.count, dtype=np.int64) + 500
    rows = _rows(rng, 3, 900)
    rows["opid"] = np.array([7, 8, 9], np.int64)
    store.append(rows)
    model.append(rows)
    for idx in (0, 11, -1, 4):
        idx %= model.count  # -1: the last row, which moves nothing
        store.swap_delete(idx)
        model.swap_delete(idx)
    _assert_device(store, model)
    _assert_host(store, model)
