"""Settings for the suite under ``tests/`` that its own conftest leaves out:
a time limit for every test, one core's share of the CPU thread pools per
xdist worker, and the ``slow`` marks on the JAX package's longest tests.

Pytest loads this file before ``tests/conftest.py``, so ``NPROC`` is set
before that file creates JAX's CPU client.
"""

import contextlib
import os
import signal
import threading
from pathlib import Path

import pytest

# The ``pytester`` fixture, for the test of the limit below.
pytest_plugins = ["pytester"]

TESTS = Path(__file__).parent / "tests"

# One core's share of the CPU thread pools per xdist worker: XLA:CPU and
# torch otherwise each size theirs to every core, in every worker. XLA:CPU
# takes its intra-op pool size from NPROC; XLA_FLAGS has no such setting.
if "PYTEST_XDIST_WORKER_COUNT" in os.environ:
    _CORES = max(1, (os.cpu_count() or 1)
                 // int(os.environ["PYTEST_XDIST_WORKER_COUNT"]))
    os.environ["NPROC"] = str(_CORES)
    import torch

    torch.set_num_threads(_CORES)

# Every test's call phase under ``tests/`` fails once it has run this long:
# about twice the longest test that passes in the tier-1 run (140-184 s on
# an 8-core CPU under 6 xdist workers), so a hang costs one worker this
# much, not the run.
LIMIT_S = 300

# Tests of the frozen JAX package too long for the tier-1 run; each has
# another test of its feature there, most of them the port's parity tests
# in ``tests/port/``. ``-m slow`` runs them.
SLOW = frozenset({
    "tests/test_hnsw.py::test_delete_with_repair_preserves_recall",
    "tests/test_hnsw.py::test_recall_vs_ground_truth[0]",
    "tests/test_hnsw_device_build.py::test_batched_overwrite_updates_labels",
    "tests/test_hnsw_device_build.py::test_bulk_build_device_matches_api",
    "tests/test_hnsw_device_build.py::test_bulk_build_then_delete_pulls_host_mirrors",
    "tests/test_hnsw_dtypes_depth.py::test_batch_iterator_under_mutation",
    "tests/test_hnsw_dtypes_depth.py::test_churn_cycles_at_size",
    "tests/test_hnsw_dtypes_depth.py::test_multi_add_delete_range_cycles",
    "tests/test_sharding.py::test_graft_entry_single_and_multichip",
    "tests/test_sharding.py::test_sharded_batch_iterator_and_info",
    "tests/test_sharding.py::test_sharded_hnsw_bulk_build_device",
    "tests/test_sharding.py::test_sharded_hnsw_delete_and_requery",
    "tests/test_sharding.py::test_sharded_hnsw_recall[0]",
    "tests/test_sharding.py::test_sharded_hnsw_recall[2]",
    "tests/test_sharding.py::test_sharded_hnsw_result_is_union_of_shards",
    "tests/test_sharding.py::test_sharded_vamana_sq8_quantized",
    "tests/test_svs_quant.py::test_quant_modes_delete_and_update",
    "tests/test_timeout.py::test_hnsw_resumable_frontier_reuse",
})


@contextlib.contextmanager
def time_limit(seconds, what):
    """Fail the enclosed block with ``pytest.fail`` once it has run
    ``seconds``, through ``SIGALRM`` (``ITIMER_REAL``).

    A signal handler runs only in the main thread and only between Python
    bytecodes: a block stuck inside a C call, such as an XLA compile, fails
    only when that call returns; waits such as ``time.sleep`` and
    ``Thread.join`` are interrupted at once. Off the main thread, or where
    ``SIGALRM`` does not exist, the block runs without a limit. The timer is
    disarmed on the way out.
    """
    if (not hasattr(signal, "SIGALRM")
            or threading.current_thread() is not threading.main_thread()):
        yield
        return

    def expired(signum, frame):
        pytest.fail(f"{what} ran past its {seconds} s limit")

    old_handler = signal.signal(signal.SIGALRM, expired)
    signal.setitimer(signal.ITIMER_REAL, seconds)
    try:
        yield
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old_handler)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    if not item.path.is_relative_to(TESTS):
        return (yield)
    with time_limit(LIMIT_S, item.nodeid):
        return (yield)


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    for item in items:
        if item.nodeid in SLOW:
            item.add_marker(pytest.mark.slow)
