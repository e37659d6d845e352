"""The port's native host runtime (``vectorsimilarity_tpu_torch/native_bridge.py``,
``native/vecsim_host.cpp`` built with g++) against its numpy forms and
against the JAX package's bridge on the same inputs.

The port builds its own copy of the library under ``build/torch_native/``
and raises where the JAX bridge would fall back to numpy.
"""

import threading

import numpy as np
import pytest

from vectorsimilarity_tpu import native_bridge as jnb
from vectorsimilarity_tpu_torch import native_bridge as nb


def _links(seed, rows=300, m=8, hi=60):
    return np.random.default_rng(seed).integers(-1, hi, size=(rows, m)).astype(np.int32)


@pytest.mark.parametrize("target", [0, 7, 59, 1000])
def test_find_referrers(target):
    links = _links(0)
    got = nb.find_referrers(links, 250, target)
    assert got.dtype == np.int32
    assert np.array_equal(got, nb.find_referrers_plain(links, 250, target))
    if jnb.get_lib() is not None:
        assert np.array_equal(got, jnb.find_referrers(links, 250, target))
    # An upper-level block [rows, levels, M] scans as rows * levels rows.
    block = links.reshape(100, 3, 8)
    assert np.array_equal(nb.find_referrers(block, 100, target),
                          nb.find_referrers_plain(block, 100, target))


def test_rewrite_id():
    links = _links(1)
    a, b = links.copy(), links.copy()
    n = nb.rewrite_id(a, 200, 7, 99)
    assert n == nb.rewrite_id_plain(b, 200, 7, 99) > 0
    assert np.array_equal(a, b) and (a[200:] == links[200:]).all()
    if jnb.get_lib() is not None:
        c = links.copy()
        assert jnb.rewrite_id(c, 200, 7, 99) == n and np.array_equal(a, c)


def test_apply_reverse_edges():
    rng = np.random.default_rng(2)
    links = np.full((50, 6), -1, dtype=np.int32)
    nlinks = rng.integers(0, 7, size=50).astype(np.int32)
    for r, c in enumerate(nlinks):
        links[r, :c] = rng.choice(50, size=c, replace=False)
    pairs = rng.integers(0, 50, size=(400, 2)).astype(np.int32)
    pairs[:5, 1] = pairs[:5, 0]  # self-pairs are skipped
    out = {}
    for name, fn in (("native", nb.apply_reverse_edges), ("plain", nb.apply_reverse_edges_plain),
                     ("jax", jnb.apply_reverse_edges)):
        lk, nl = links.copy(), nlinks.copy()
        res = fn(lk, nl, pairs)
        if res is None:  # the JAX bridge without its library
            continue
        out[name] = (lk, nl, *res)
    ref = out["plain"]
    assert len(ref[2]) and len(ref[3])  # both overflows and appends happen
    for name, got in out.items():
        for a, b in zip(got, ref):
            assert np.array_equal(a, b), name


def test_checks_raise():
    with pytest.raises(TypeError, match="int32"):
        nb.find_referrers(np.zeros((4, 2), np.int64), 4, 0)
    with pytest.raises(ValueError, match="rows"):
        nb.find_referrers(np.zeros((4, 2), np.int32), 5, 0)
    with pytest.raises(TypeError, match="C-contiguous"):
        nb.rewrite_id(np.zeros((4, 4), np.int32)[:, ::2], 4, 0, 1)
    with pytest.raises(ValueError, match="out of"):
        nb.apply_reverse_edges(np.zeros((4, 2), np.int32), np.zeros(4, np.int32),
                               np.array([[0, 9]]))


def test_library_is_the_ports_own_build():
    lib = nb.get_lib()
    assert lib is nb.get_lib()
    assert "torch_native" in lib._name and "libvecsim_host_" in lib._name


def test_native_pool_runs_python_jobs():
    pool = nb.NativePool(3)
    try:
        hits, lock = [], threading.Lock()

        def job(j):
            with lock:
                hits.append(j)

        pool.submit_cb(None, None, list(range(40)), [job] * 40)
        assert pool.wait_for_quiescence(30)
        assert sorted(hits) == list(range(40))
    finally:
        pool.shutdown()
