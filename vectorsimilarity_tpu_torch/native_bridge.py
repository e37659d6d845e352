"""ctypes bridge to the native host runtime (``native/vecsim_host.cpp``).

Counterpart of ``vectorsimilarity_tpu/native_bridge.py``, restated (that
package imports jax). The C++ source is the repository's one copy, used as
it is: g++ builds it at first use into ``build/torch_native/`` under a name
that carries a hash of the source and flags, apart from the JAX package's
``build/libvecsim_host.so`` (two packages writing one file in parallel test
workers would race). The library is a dependency here, not an accelerator:
a build or load failure raises. The numpy forms beside each scan
(``*_plain``) are what the tests hold the native ones against. The numpy
adjacency buffers are passed zero-copy.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_REPO = Path(__file__).resolve().parent.parent
_SRC = _REPO / "native" / "vecsim_host.cpp"
_BUILD_DIR = _REPO / "build" / "torch_native"
# No -march=native: the build directory may travel to a machine with
# another CPU, and these loops gain nothing from it.
_FLAGS = ["-O3", "-shared", "-fPIC"]

_lib: Optional[ctypes.CDLL] = None
_lib_lock = threading.Lock()

JOB_FN = ctypes.CFUNCTYPE(None, ctypes.c_void_p)


def _build() -> Path:
    tag = hashlib.sha256(" ".join(_FLAGS).encode() + _SRC.read_bytes()).hexdigest()[:12]
    out = _BUILD_DIR / f"libvecsim_host_{tag}.so"
    if out.exists():
        return out
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC), "-lpthread"],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed on {_SRC}:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    """The native library, built and loaded at the first call."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(_build()))
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64 = ctypes.c_int64
        lib.vs_find_referrers.restype = i64
        lib.vs_find_referrers.argtypes = [i32p, i64, i64, ctypes.c_int32, i32p, i64]
        lib.vs_rewrite_id.restype = i64
        lib.vs_rewrite_id.argtypes = [i32p, i64, i64, ctypes.c_int32, ctypes.c_int32]
        lib.vs_apply_reverse_edges.restype = i64
        lib.vs_apply_reverse_edges.argtypes = [
            i32p, i32p, i64, i32p, i64, i32p, i64, i32p, i64, ctypes.POINTER(i64)
        ]
        lib.vs_pool_create.restype = ctypes.c_void_p
        lib.vs_pool_create.argtypes = [ctypes.c_int]
        lib.vs_pool_submit.restype = None
        lib.vs_pool_submit.argtypes = [ctypes.c_void_p, JOB_FN, ctypes.c_void_p]
        lib.vs_pool_wait.restype = ctypes.c_int
        lib.vs_pool_wait.argtypes = [ctypes.c_void_p, i64]
        lib.vs_pool_in_flight.restype = i64
        lib.vs_pool_in_flight.argtypes = [ctypes.c_void_p]
        lib.vs_pool_destroy.restype = None
        lib.vs_pool_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _rows_of(links: np.ndarray, n_rows: int) -> np.ndarray:
    if links.dtype != np.int32:
        raise TypeError(f"links must be int32, got {links.dtype}")
    if n_rows > len(links):
        raise ValueError(f"{n_rows} rows asked of {len(links)}")
    return np.ascontiguousarray(links[:n_rows]).reshape(n_rows, -1)


def find_referrers(links: np.ndarray, n_rows: int, target: int) -> np.ndarray:
    """Ascending ids of the rows of ``links[:n_rows]`` that hold ``target``."""
    flat = _rows_of(links, n_rows)
    out = np.empty(n_rows, dtype=np.int32)
    n = get_lib().vs_find_referrers(_i32p(flat), n_rows, flat.shape[1], target,
                                    _i32p(out), n_rows)
    return out[:n].copy()


def find_referrers_plain(links: np.ndarray, n_rows: int, target: int) -> np.ndarray:
    """``find_referrers`` in numpy."""
    flat = _rows_of(links, n_rows)
    return np.nonzero((flat == target).any(axis=1))[0].astype(np.int32)


def rewrite_id(links: np.ndarray, n_rows: int, old_id: int, new_id: int) -> int:
    """Replace ``old_id`` by ``new_id`` in ``links[:n_rows]`` in place (a
    C-contiguous int32 array); returns the number of cells rewritten."""
    if links.dtype != np.int32 or not links.flags.c_contiguous:
        raise TypeError("links must be a C-contiguous int32 array")
    flat = links[:n_rows].reshape(n_rows, -1)
    return int(get_lib().vs_rewrite_id(_i32p(flat), n_rows, flat.shape[1], old_id, new_id))


def rewrite_id_plain(links: np.ndarray, n_rows: int, old_id: int, new_id: int) -> int:
    """``rewrite_id`` in numpy."""
    rows = links[:n_rows]
    hit = rows == old_id
    rows[hit] = new_id
    return int(hit.sum())


def _check_adjacency(links: np.ndarray, nlinks: np.ndarray) -> None:
    if links.dtype != np.int32 or not links.flags.c_contiguous or links.ndim != 2:
        raise TypeError("links must be a C-contiguous int32 [rows, m] array")
    if nlinks.dtype != np.int32 or not nlinks.flags.c_contiguous:
        raise TypeError("nlinks must be a C-contiguous int32 array")
    if len(nlinks) < len(links):
        raise ValueError("nlinks is shorter than links")


def apply_reverse_edges(links: np.ndarray, nlinks: np.ndarray, pairs: np.ndarray):
    """Append back-edges (neighbor, node) into the adjacency rows in place:
    ``links`` [rows, m] and ``nlinks`` [rows] int32, C-contiguous, ``pairs``
    [P, 2]. A pair appends ``node`` to row ``neighbor`` when the row has room
    and lacks it. Returns (overflow rows, in first-seen order, without
    repeats; rows appended to, one entry per append)."""
    _check_adjacency(links, nlinks)
    pairs = np.ascontiguousarray(pairs, dtype=np.int32).reshape(-1, 2)
    if len(pairs) and (pairs.min() < 0 or pairs.max() >= len(links)):
        raise ValueError("pair ids out of the adjacency's rows")
    P = len(pairs)
    overflow = np.empty(max(P, 1), dtype=np.int32)
    dirty = np.empty(max(P, 1), dtype=np.int32)
    dirty_count = ctypes.c_int64(0)
    n_over = get_lib().vs_apply_reverse_edges(
        _i32p(links), _i32p(nlinks), links.shape[1], _i32p(pairs), P,
        _i32p(overflow), len(overflow), _i32p(dirty), len(dirty), ctypes.byref(dirty_count),
    )
    return overflow[:n_over].copy(), dirty[: dirty_count.value].copy()


def apply_reverse_edges_plain(links: np.ndarray, nlinks: np.ndarray, pairs: np.ndarray):
    """``apply_reverse_edges`` as a Python loop."""
    _check_adjacency(links, nlinks)
    m = links.shape[1]
    overflow: list[int] = []
    dirty: list[int] = []
    for nb, node in np.asarray(pairs, dtype=np.int32).reshape(-1, 2).tolist():
        if nb == node:
            continue
        cnt = int(nlinks[nb])
        if node in links[nb, :cnt]:
            continue
        if cnt < m:
            links[nb, cnt] = node
            nlinks[nb] = cnt + 1
            dirty.append(nb)
        elif nb not in overflow:
            overflow.append(nb)
    return np.asarray(overflow, dtype=np.int32), np.asarray(dirty, dtype=np.int32)


class NativePool:
    """C++ worker pool behind the SubmitCB contract; Python callbacks run on
    native threads through a ctypes trampoline (which takes the GIL)."""

    def __init__(self, num_threads: int = 4):
        self._lib = get_lib()
        self._pool = self._lib.vs_pool_create(num_threads)
        self._keepalive: dict[int, tuple] = {}
        self._keys = threading.Lock()
        self._next = 1  # 0 would reach the callback as NULL -> None

        @JOB_FN
        def trampoline(arg):
            with self._keys:
                job, cb = self._keepalive.pop(int(arg))
            cb(job)

        self._trampoline = trampoline

    def submit_cb(self, job_queue, job_queue_ctx, jobs, callbacks) -> int:
        for job, cb in zip(jobs, callbacks):
            with self._keys:
                key = self._next
                self._next += 1
                self._keepalive[key] = (job, cb)
            self._lib.vs_pool_submit(self._pool, self._trampoline, ctypes.c_void_p(key))
        return 0

    def wait_for_quiescence(self, timeout: float | None = None) -> bool:
        ms = -1 if timeout is None else int(timeout * 1000)
        return bool(self._lib.vs_pool_wait(self._pool, ms))

    def shutdown(self) -> None:
        if self._pool:
            self._lib.vs_pool_destroy(self._pool)
            self._pool = None
