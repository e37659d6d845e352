"""The port's host contract equals the JAX package's: enums, constants,
parameter defaults, query replies and label maps."""

import dataclasses
import enum

import numpy as np
import pytest

import vectorsimilarity_tpu.types as jt
import vectorsimilarity_tpu_torch.types as tt
from vectorsimilarity_tpu.core import labels as jl
from vectorsimilarity_tpu.core import results as jr
from vectorsimilarity_tpu_torch.core import labels as tl
from vectorsimilarity_tpu_torch.core import results as tr

ENUMS = sorted(n for n, v in vars(jt).items()
               if isinstance(v, type) and issubclass(v, enum.Enum) and v.__module__ == jt.__name__)
DATACLASSES = sorted(n for n, v in vars(jt).items()
                     if isinstance(v, type) and dataclasses.is_dataclass(v))
CONSTANTS = sorted(n for n, v in vars(jt).items()
                   if n.isupper() and isinstance(v, (int, float, str)))


@pytest.mark.parametrize("name", ENUMS)
def test_enum_members_match(name):
    assert [(m.name, m.value) for m in getattr(jt, name)] == \
        [(m.name, m.value) for m in getattr(tt, name)]


@pytest.mark.parametrize("name", DATACLASSES)
def test_dataclass_fields_and_defaults_match(name):
    j, t = getattr(jt, name), getattr(tt, name)
    assert [f.name for f in dataclasses.fields(j)] == [f.name for f in dataclasses.fields(t)]
    assert dataclasses.asdict(j()) == dataclasses.asdict(t())


def test_constants_match():
    assert CONSTANTS
    assert {n: getattr(jt, n) for n in CONSTANTS} == {n: getattr(tt, n) for n in CONSTANTS}


@pytest.mark.parametrize("vtype", list(jt.VecSimType))
def test_type_helpers_match(vtype):
    tv = tt.VecSimType(int(vtype))
    assert jt.numpy_dtype(vtype) == tt.numpy_dtype(tv)
    assert jt.type_size(vtype) == tt.type_size(tv)
    assert jt.is_integer_type(vtype) == tt.is_integer_type(tv)
    for cap, block in [(0, 1024), (1, 1024), (1500, 1024), (2048, 1024)]:
        assert jt.round_up_initial_capacity(cap, block) == tt.round_up_initial_capacity(cap, block)


def _replies(rng, n):
    ids = rng.integers(0, 6, size=n)
    scores = rng.integers(0, 4, size=n).astype(np.float64) / 4  # planted ties
    return (jr.make_reply(ids, scores), tr.make_reply(ids, scores))


def _same(a, b):
    assert np.array_equal(a.ids, b.ids) and np.array_equal(a.scores, b.scores)
    assert int(a.code) == int(b.code) and a.ids.dtype == b.ids.dtype


@pytest.mark.parametrize("order", list(jt.QueryReplyOrder))
def test_reply_sort_matches(order):
    rng = np.random.default_rng(int(order))
    a, b = _replies(rng, 12)
    _same(a.sort(order), b.sort(tt.QueryReplyOrder(int(order))))
    assert a.results() == b.results()


@pytest.mark.parametrize("with_set", [False, True])
def test_merge_and_filter_match(with_set):
    rng = np.random.default_rng(7)
    (ja, ta), (jb, tb) = _replies(rng, 9), _replies(rng, 7)
    ja.sort(jt.QueryReplyOrder.BY_SCORE_THEN_ID)
    ta.sort(tt.QueryReplyOrder.BY_SCORE_THEN_ID)
    jb.code = jt.VecSimQueryReplyCode.TimedOut
    tb.code = tt.VecSimQueryReplyCode.TimedOut
    _same(jr.merge_replies(ja, jb, 8, with_set), tr.merge_replies(ta, tb, 8, with_set))
    _same(jr.filter_results_by_id(ja), tr.filter_results_by_id(ta))


@pytest.mark.parametrize("multi", [False, True])
def test_label_maps_match(multi):
    rng = np.random.default_rng(3)
    j = jl.MultiLabelMap() if multi else jl.SingleLabelMap()
    t = tl.MultiLabelMap() if multi else tl.SingleLabelMap()
    next_id = 0
    for _ in range(200):
        op = rng.integers(0, 4)
        label = int(rng.integers(0, 12))
        if op <= 1:
            assert j.add(label, next_id) == t.add(label, next_id)
            next_id += 1
        elif op == 2:
            assert j.remove_label(label) == t.remove_label(label)
        elif label in j and j.ids_of(label):
            ids = j.ids_of(label)
            if multi:
                j.on_swap(label, ids[0], next_id)
                t.on_swap(label, ids[0], next_id)
            else:
                j.on_swap(label, next_id)
                t.on_swap(label, next_id)
            next_id += 1
        assert len(j) == len(t)
        assert all(j.ids_of(x) == t.ids_of(x) and (x in j) == (x in t) for x in range(12))
    if multi:
        assert j.num_slots == t.num_slots
        assert j.label_to_slot == t.label_to_slot
        assert all(j.label_of_slot(s) == t.label_of_slot(s) for s in j.label_to_slot.values())
