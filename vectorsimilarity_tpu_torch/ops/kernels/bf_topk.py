"""The flat index's three top-k kernel engines and their host parts.

Counterpart of ``vectorsimilarity_tpu/ops/pallas/bf_topk.py``. Every function
there that reaches ``pl.pallas_call`` has its kernel here, CUDA C++ for
sm_90a under ``csrc/``, each with the scoring prologue ``_tile_scores`` (K2,
``csrc/bf_scores.cuh``) fused in, in five lanes: fp32, bf16, fp16 (sums in
fp32), int8 and uint8 (exact integers).

=========  ======================  =========================  ====================
k band     JAX                     kernel wrapper             host part
=========  ======================  =========================  ====================
k <= 32    ``pallas_topk_gm``      ``group_min_scores`` (K1)  ``topk_gm(_exact)``
k <= 128   ``pallas_topk``         ``fused_topk`` (K3)        ``topk_fused``
k <= 2048  ``pallas_topk_bigk``    ``tile_topc`` (K4)         ``topk_bigk(_exact)``
=========  ======================  =========================  ====================

K1 scores every store row against the query batch and writes only the
strided group minima of each ``tile_n``-row tile. It has two kernels: the
tensor-core one (``csrc/bf_topk_gm_tc.cu``: wgmma fed by TMA, fp32 as a
3xTF32 split, ``split_tf32`` beside it in PyTorch) for every shape
``config.gm_tc_ok`` admits, and the CUDA-core one (``csrc/bf_topk_gm.cu``)
for the rest; the wrapper chooses before the launch. Group g
of tile j holds rows ``j*tile_n + g + l*G``, ``l < L = tile_n / G``. The host
part takes the S+1 smallest group minima per query (S = k + slack), gathers
and rescores the S*L member rows exactly, selects the k best in (distance,
id) order and flags a query as uncovered when the k-th rescored distance does
not beat the first unselected group minimum by eps (a true neighbour may then
hide in an unselected group). Any true top-k row lies in a group whose
minimum is <= the true k-th distance, so it can be missed only if that group
ranks below the S suspects, which the flag detects.

K3 returns the exact k <= 128 smallest (distance, id) pairs per query,
optionally above a per-query lower bound; ``topk_fused`` chains passes of 128
on that bound for larger k. It too has two kernels, chosen the same way: the
tensor-core one (``csrc/bf_topk_fused_tc.cu``: K1's wgmma + TMA scoring, a
threshold filter in registers and a merge of candidate buffers into sorted
lists) where ``fused_tc_admits``, and the CUDA-core one
(``csrc/bf_topk_fused.cu``) for the rest.

K4 returns each tile's c smallest pairs; the host part takes one exact top-k
over the survivors and flags a query as truncated when a tile's c-th best
lies inside its global top-k (that tile may hide more). Its tensor-core
kernel is the tensor-core K3's, writing one list per tile instead of one per
row range (``bf_topk_topc_tc`` in ``csrc/bf_topk_fused_tc.cu``), where
``topc_tc_admits``; the CUDA-core one (``csrc/bf_topk_topc.cu``) takes the
rest.

``topk_gm_exact`` and ``topk_bigk_exact`` answer a batch with any flagged
query from the exact ``streaming_topk`` instead.

Beside each kernel stands its plain PyTorch version (``group_min_scores_ref``,
``fused_topk_ref``, ``tile_topc_ref``), built from ``scores_float`` /
``scores_int`` and ``_lex_topk``. On a CUDA tensor a wrapper launches its
kernel or raises; only a tensor on the CPU takes the plain version. Each
wrapper counts its launches (``wrapper.launches``), each ``_exact`` host part
its fallbacks.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Optional

import torch

from ... import config
from ...types import VecSimMetric
from ..distances import _lex_topk, _merge_topk, scores_float, scores_int, streaming_topk

_CSRC = Path(__file__).resolve().parents[2] / "csrc"
_SOURCES = ("bf_topk_gm", "bf_topk_gm_tc", "bf_topk_fused", "bf_topk_fused_tc", "bf_topk_topc")
_HEADERS = ("bf_scores.cuh", "bf_select.cuh", "bf_tc.cuh")
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
# No --use_fast_math: the integer Cosine lane needs IEEE divides.
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

PASS_K = 128  # longest list of the fused kernel; larger k chains passes
MAX_C = 128  # longest per-tile list of the top-c kernel
# Queries per block of both fused kernels and the tensor-core K4
# (csrc/bf_select.cuh SEL_BM, csrc/bf_topk_fused_tc.cu BM).
_FUSED_BM = 64
_FUSED_BLOCKS = 528  # blocks the CUDA-core fused kernel's grid aims for: 4 per SM
_FUSED_MIN_ROWS = 1024  # shortest row range worth a block of its own
_SUB_ROWS = 128  # store rows per sub-tile of the fused kernels; ranges (and K4 tiles) a multiple

# Lane codes of the C entry points (csrc/bf_scores.cuh).
_LANES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2, torch.int8: 3, torch.uint8: 4}


class _Kernels:
    """The built and loaded shared libraries, one per source."""

    def __init__(self, paths: dict, build_logs: dict, build_seconds: float):
        self.paths = paths
        self.build_logs = build_logs  # nvcc/ptxas output per source (registers, spills)
        self.build_seconds = build_seconds
        ptr, num = ctypes.c_void_p, ctypes.c_int
        self.gm = self._fn("bf_topk_gm", [ptr] * 6 + [num] * 8 + [ptr])
        self.gm_tc = self._fn("bf_topk_gm_tc", [ptr] * 7 + [num] * 8 + [ptr])
        self.fused = self._fn("bf_topk_fused", [ptr] * 9 + [num] * 9 + [ptr])
        self.fused_tc = self._fn("bf_topk_fused_tc", [ptr] * 10 + [num] * 9 + [ptr])
        self.topc = self._fn("bf_topk_topc", [ptr] * 7 + [num] * 8 + [ptr])
        self.topc_tc = self._fn("bf_topk_topc_tc", [ptr] * 8 + [num] * 10 + [ptr],
                                source="bf_topk_fused_tc")

    def _fn(self, name: str, argtypes: list, source: Optional[str] = None):
        """Entry point ``name`` of the library built from ``source`` (default:
        the source of the same name)."""
        fn = getattr(ctypes.CDLL(str(self.paths[source or name])), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn


_kernels: dict = {}  # defines -> _Kernels
_load_lock = threading.Lock()  # one build per process, whichever thread asks first


def _nvcc() -> str:
    for base in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if base and os.path.exists(os.path.join(base, "bin", "nvcc")):
            return os.path.join(base, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def load_kernel(defines: tuple = ()) -> _Kernels:
    """Build every source under ``csrc/`` into ``build/torch_kernels/`` at
    first use, one nvcc per source and all started together, and load them
    with ctypes. The file names carry a hash of all sources, headers and
    flags, so an edited source or header rebuilds.

    ``defines`` (``"NAME=VALUE"`` strings, nvcc's ``-D``) build and load
    another set beside the default one. The wrappers use the default set;
    ``tools/k1_trials.py`` builds the tensor-core K1's trial variants so."""
    defines = tuple(defines)
    with _load_lock:
        if defines not in _kernels:
            _kernels[defines] = _build_and_load([f"-D{d}" for d in defines])
        return _kernels[defines]


def _build_and_load(extra_flags: list) -> _Kernels:
    flags = _NVCC_FLAGS + extra_flags
    digest = hashlib.sha256(" ".join(flags).encode())
    for name in [f"{s}.cu" for s in _SOURCES] + list(_HEADERS):
        digest.update((_CSRC / name).read_bytes())
    tag = digest.hexdigest()[:12]
    paths = {s: _BUILD_DIR / f"lib{s}_{tag}.so" for s in _SOURCES}
    logs = {s: "" for s in _SOURCES}
    t0 = time.perf_counter()
    procs = {}
    for s, out in paths.items():
        if not out.exists():
            _BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            procs[s] = (tmp, subprocess.Popen(
                [_nvcc(), *flags, "-o", str(tmp), str(_CSRC / f"{s}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for s, (tmp, proc) in procs.items():
        logs[s] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {s}.cu:\n{logs[s]}")
        else:
            os.replace(tmp, paths[s])
    if failed:
        raise RuntimeError("\n".join(failed))
    return _Kernels(paths, logs, time.perf_counter() - t0 if procs else 0.0)


# ---------------------------------------------------------------------------
# Shared by the three wrappers: checks, lane auxiliaries, launch plumbing
# ---------------------------------------------------------------------------


def _check(queries, data, sqnorms, metric, query_norms) -> None:
    """Raise on what no kernel of this module takes."""
    if queries.dim() != 2 or data.dim() != 2 or queries.shape[1] != data.shape[1]:
        raise ValueError(f"shapes {tuple(queries.shape)} and {tuple(data.shape)}")
    if data.dtype not in _LANES:
        raise TypeError("the kernels take float32, bfloat16, float16, int8 or uint8 "
                        f"stores, got {data.dtype}")
    if queries.dtype != data.dtype:
        raise TypeError(f"queries are {queries.dtype}, the store is {data.dtype}")
    B, D = queries.shape
    N = data.shape[0]
    if N >= 2 ** 31:
        raise ValueError(f"row ids are int32, got N={N}")
    is_int = not data.dtype.is_floating_point
    if is_int and 255 * 255 * D >= 2 ** 31:
        raise ValueError(f"the integer lanes sum in int32: D={D} may overflow")
    aux = {}
    if (metric == VecSimMetric.L2 and not is_int) or (metric == VecSimMetric.Cosine and is_int):
        what = "norms" if is_int else "sqnorms"
        if sqnorms is None or tuple(sqnorms.shape) != (N,):
            raise ValueError(f"{metric.name} on a {data.dtype} store needs {what} [N]")
        aux[what] = sqnorms
        if is_int:
            if query_norms is None or tuple(query_norms.shape) != (B,):
                raise ValueError("Cosine on an integer store needs query_norms [B]")
            aux["query_norms"] = query_norms
    for name, t in aux.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
    for t in [queries, data, *aux.values()]:
        if not t.is_contiguous():
            raise ValueError("the kernels take contiguous tensors")
        if t.device != data.device:
            raise ValueError(f"tensors on {t.device} and {data.device}")


def _check_tiles(data, tile_n: int) -> int:
    if tile_n <= 0 or data.shape[0] % tile_n:
        raise ValueError(f"N={data.shape[0]} must be a multiple of tile_n={tile_n}")
    return data.shape[0] // tile_n


def _lane_aux(queries, sqnorms, metric, query_norms):
    """(qaux_f [B] fp32, qaux_i [B] int32, raux [N] fp32) of a launch, None
    where the lane and metric use none: the device half of the JAX
    ``_mode_and_aux``. Float L2 carries |q|^2 and the rows' sqnorms; integer
    L2 the exact |q|^2 (the rows' are summed in the kernel); integer Cosine
    both sides' stored norms. uint8 needs no shift on this card."""
    if queries.dtype.is_floating_point:
        if metric != VecSimMetric.L2:
            return None, None, None
        qf = queries.float()
        return torch.sum(qf * qf, dim=1), None, sqnorms
    if metric == VecSimMetric.L2:
        qi = queries.to(torch.int32)
        return None, torch.sum(qi * qi, dim=1, dtype=torch.int32), None
    if metric == VecSimMetric.Cosine:
        return query_norms, None, sqnorms
    return None, None, None


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _dsq(data, metric, count: int):
    """Integer L2's int32 scratch [max(count, 1)] for a tensor-core launch,
    which writes the rows' sums of squares into it; None elsewhere."""
    if data.dtype.is_floating_point or metric != VecSimMetric.L2:
        return None
    return torch.empty((max(count, 1),), dtype=torch.int32, device=data.device)


def _sms(device) -> int:
    """SMs of a CUDA device, which the tensor-core launches fill in one wave.
    A device other than CUDA (meta) has none; ``_run`` refuses it."""
    if device.type != "cuda":
        return 1
    return torch.cuda.get_device_properties(device).multi_processor_count


def _run(wrapper, name: str, data, call, counter: str = "launches") -> None:
    """Launch one kernel on ``data``'s device and current stream, raise on a
    refused launch, count it in ``wrapper.<counter>``. ``call(kernels,
    stream)`` returns the C entry point's error code."""
    if data.device.type != "cuda":
        raise ValueError(f"the {name} kernel runs on CUDA tensors, got {data.device}")
    kernels = load_kernel()
    with torch.cuda.device(data.device):
        err = call(kernels, torch.cuda.current_stream(data.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    setattr(wrapper, counter, getattr(wrapper, counter) + 1)


def _scores(queries, data, sqnorms, metric, query_norms, lo: int, hi: int):
    """Plain scores [B, hi - lo] of rows [lo, hi)."""
    aux = None if sqnorms is None else sqnorms[lo:hi]
    if data.dtype.is_floating_point:
        return scores_float(queries, data[lo:hi], metric, aux)
    return scores_int(queries, data[lo:hi], metric, aux, query_norms)


def _masked(s, lo: int, count: int):
    """Scores of rows [lo, lo + width) with rows >= count at +inf."""
    rows = torch.arange(lo, lo + s.shape[1], device=s.device)
    return torch.where(rows[None, :] < count, s, float("inf"))


# ---------------------------------------------------------------------------
# K1: group minima
# ---------------------------------------------------------------------------


def group_min_scores(queries: torch.Tensor, data: torch.Tensor,
                     sqnorms: Optional[torch.Tensor], count: int, *,
                     metric: VecSimMetric, tile_n: int, group_n: int,
                     query_norms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Strided group minima ``gm [B, (N / tile_n) * G]`` (fp32) of the score
    tiles, rows >= count at +inf. ``sqnorms`` [N] carries the rows' sqnorms
    (float L2) or stored norms (integer Cosine, with ``query_norms`` [B]).

    CUDA tensors launch one of K1's two kernels, chosen before the launch:
    the tensor-core kernel (``csrc/bf_topk_gm_tc.cu``, counted in
    ``group_min_scores.tc_launches``) where ``config.gm_tc_ok`` admits the
    shape and both bases are 16-byte aligned, else the CUDA-core kernel
    (``csrc/bf_topk_gm.cu``, ``group_min_scores.launches``). CPU tensors
    take ``group_min_scores_ref``; anything else raises.
    """
    metric = VecSimMetric(metric)
    _check(queries, data, sqnorms, metric, query_norms)
    _check_tiles(data, tile_n)
    if tile_n % min(group_n, tile_n):
        raise ValueError(f"tile_n={tile_n} must be a multiple of G={min(group_n, tile_n)}")
    if data.device.type == "cpu":
        return group_min_scores_ref(queries, data, sqnorms, count, metric=metric,
                                    tile_n=tile_n, group_n=group_n, query_norms=query_norms)
    B, D = queries.shape
    N = data.shape[0]
    n_tiles, G = N // tile_n, min(group_n, tile_n)
    count = max(0, min(int(count), N))
    qf, qi, rf = _lane_aux(queries, sqnorms, metric, query_norms)
    out = torch.empty((B, n_tiles * G), dtype=torch.float32, device=data.device)
    if not gm_tc_admits(queries, data):
        _run(group_min_scores, "bf_topk_gm", data, lambda kern, stream: kern.gm(
            queries.data_ptr(), data.data_ptr(), _ptr(qf), _ptr(qi), _ptr(rf), out.data_ptr(),
            _LANES[data.dtype], B, D, n_tiles, tile_n, G, count, int(metric), stream))
        return out
    dsq = _dsq(data, metric, count)
    _run(group_min_scores, "bf_topk_gm_tc", data, lambda kern, stream: kern.gm_tc(
        queries.data_ptr(), data.data_ptr(), _ptr(qf), _ptr(qi), _ptr(rf), _ptr(dsq),
        out.data_ptr(), _LANES[data.dtype], B, D, n_tiles, tile_n, G, count, int(metric),
        stream), counter="tc_launches")
    return out


group_min_scores.launches = 0  # CUDA-core kernel
group_min_scores.tc_launches = 0  # tensor-core kernel


def gm_tc_admits(queries: torch.Tensor, data: torch.Tensor) -> bool:
    """Whether the tensor-core K1 takes these tensors: ``config.gm_tc_ok``
    on the row width and type, and 16-byte aligned bases (the CUDA
    allocator's blocks are, so a view's element offset decides)."""
    D = queries.shape[1]
    return config.gm_tc_ok(D, data.dtype) and all(
        t.storage_offset() * t.element_size() % 16 == 0 for t in (queries, data))


def split_tf32(x: torch.Tensor):
    """(hi, lo) fp32 tensors with hi + lo ~ x: the tensor-core kernels'
    3xTF32 split (``split_share`` in ``csrc/bf_tc.cuh``) on any device. hi
    rounds x to TF32 (11 significant bits, nearest, ties away from zero: the
    integer form of cvt.rna.tf32.f32), lo rounds x - hi (exact in fp32) the
    same way. For finite x, |x - hi - lo| <= max(2^-22 |x|, 2^-137)."""
    def rna(v: torch.Tensor) -> torch.Tensor:
        bits = v.contiguous().view(torch.int32)
        return ((bits + 0x1000) & -0x2000).view(torch.float32)

    x = x.to(torch.float32)
    hi = rna(x)
    return hi, rna(x - hi)


def group_min_scores_ref(queries: torch.Tensor, data: torch.Tensor,
                         sqnorms: Optional[torch.Tensor], count: int, *,
                         metric: VecSimMetric, tile_n: int, group_n: int,
                         query_norms: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K1, on any device: chunked ``scores_float``
    / ``scores_int`` and an ``amin`` over the strided group view."""
    metric = VecSimMetric(metric)
    B = queries.shape[0]
    N = data.shape[0]
    G = min(group_n, tile_n)
    L = tile_n // G
    n_tiles = N // tile_n
    out = torch.empty((B, n_tiles, G), dtype=torch.float32, device=data.device)
    step = max(1, (1 << 26) // max(B * tile_n, 1))  # tiles per ~256 MB of scores
    for t0 in range(0, n_tiles, step):
        t1 = min(t0 + step, n_tiles)
        lo, hi = t0 * tile_n, t1 * tile_n
        s = _masked(_scores(queries, data, sqnorms, metric, query_norms, lo, hi), lo, count)
        # Row t*tile_n + l*G + g of the chunk is element [t, l, g].
        out[:, t0:t1] = s.view(B, t1 - t0, L, G).amin(dim=2)
    return out.view(B, n_tiles * G)


def _rescore_members(queries, data, sqnorms, mem, metric, query_norms):
    """Exact distances [B, C] of each query to its own member rows ``mem``
    [B, C], by the streaming engine's formulas (``scores_float`` /
    ``scores_int``), so that a covered answer is the streaming engine's.

    Integer stores go through fp64 (every partial sum is an integer below
    2^53, so any summation order is exact), a few queries at a time: the
    gathered [B, C, D] members of a 1024-query batch would take gigabytes in
    fp64 at once.
    """
    if data.dtype.is_floating_point:
        qf = queries.float()
        ip = torch.bmm(data[mem].float(), qf[:, :, None])[:, :, 0]
        if metric != VecSimMetric.L2:
            return 1.0 - ip
        return torch.sum(qf * qf, dim=1, keepdim=True) - 2.0 * ip + sqnorms[mem]
    B, C = mem.shape
    out = torch.empty((B, C), dtype=torch.float32, device=data.device)
    step = max(1, (1 << 25) // (C * data.shape[1]))  # ~256 MB of fp64 members
    for b0 in range(0, B, step):
        m = mem[b0:b0 + step]
        rows = data[m].to(torch.float64)
        q64 = queries[b0:b0 + step].to(torch.float64)
        ip = torch.bmm(rows, q64[:, :, None])[:, :, 0].to(torch.int64)
        if metric == VecSimMetric.IP:
            d = 1.0 - ip.to(torch.float32)
        elif metric == VecSimMetric.Cosine:
            d = 1.0 - ip.to(torch.float32) / (query_norms[b0:b0 + step, None] * sqnorms[m])
        else:
            q_sq = torch.sum(q64 * q64, dim=1, keepdim=True).to(torch.int64)
            d_sq = torch.sum(rows * rows, dim=2).to(torch.int64)
            d = (q_sq - 2 * ip + d_sq).to(torch.float32)
        out[b0:b0 + step] = d
    return out


def topk_gm(queries: torch.Tensor, data: torch.Tensor, sqnorms: Optional[torch.Tensor],
            count: int, k: int, *, metric: VecSimMetric, tile_n: int = 4096,
            group_n: int = 256, slack: int = 8,
            query_norms: Optional[torch.Tensor] = None):
    """Top-k via group minima + exact suspect rescue.

    Returns (dists [B, k], ids [B, k], uncovered [B] bool). ``uncovered``
    True means the k-th rescored distance reached the first unselected
    group's minimum: the suspect set may miss a true neighbour and the
    caller must answer from an exact path. Requires
    ``n_tiles * G >= k + slack + 2`` (``config.gm_enabled``).
    """
    metric = VecSimMetric(metric)
    B = queries.shape[0]
    N = data.shape[0]
    G = min(group_n, tile_n)
    L = tile_n // G
    T = (N // tile_n) * G
    S = min(k + slack, T - 2)
    if S < k:
        raise ValueError(f"too few groups (T={T}) for k={k}: gate this shape off")
    gm = group_min_scores(queries, data, sqnorms, count, metric=metric, tile_n=tile_n,
                          group_n=group_n, query_norms=query_norms)
    gvals, gpos = _lex_topk(gm, S + 1)  # [B, S+1] smallest group minima
    m_next = gvals[:, S]  # first UNSELECTED group's min (coverage bound)
    sus = gpos[:, :S]  # flat group index t = tile*G + g
    # Group g of tile j holds rows j*tile_n + g + l*G. Sorting each row of
    # member ids makes _lex_topk's lower-position tie rule a lower-id rule.
    lane = torch.arange(L, device=data.device, dtype=torch.int64) * G
    mem = ((sus // G) * tile_n + sus % G)[:, :, None] + lane
    mem = torch.sort(mem.reshape(B, S * L), dim=1).values
    d = _rescore_members(queries, data, sqnorms, mem, metric, query_norms)
    d = torch.where(mem < count, d, float("inf"))
    vals, pos = _lex_topk(d, k)
    ids = torch.gather(mem, 1, pos)
    ids = torch.where(torch.isfinite(vals), ids, -1)
    # Coverage: the k-th best must beat every unselected group's minimum. The
    # float lanes guard the kernel-vs-rescore fp32 summation-order skew by
    # eps (see the precision note in csrc/bf_topk_gm.cu); the integer lanes
    # are exact on both sides and need none.
    kth = vals[:, k - 1]
    if data.dtype.is_floating_point:
        eps = 1e-5 * torch.clamp(torch.maximum(kth.abs(), m_next.abs()), min=1.0)
    else:
        eps = 0.0
    uncovered = ~(kth < m_next - eps)
    return vals, ids, uncovered


def topk_gm_exact(queries: torch.Tensor, data: torch.Tensor,
                  sqnorms: Optional[torch.Tensor], count: int, k: int, *,
                  metric: VecSimMetric, kind: str, tile_n: int = 4096, group_n: int = 256,
                  slack: int = 8, chunk: int = 1 << 16,
                  query_norms: Optional[torch.Tensor] = None):
    """Group-min engine, unconditionally exact: a batch with any uncovered
    query is answered by ``streaming_topk`` (``topk_gm_exact.fallbacks``
    counts those batches).

    The JAX package fuses that choice into the program (``lax.cond``). Here
    it costs one host read of the flag per call, a device sync that stops
    consecutive batches from overlapping.
    """
    vals, ids, uncovered = topk_gm(queries, data, sqnorms, count, k, metric=metric,
                                   tile_n=tile_n, group_n=group_n, slack=slack,
                                   query_norms=query_norms)
    if bool(uncovered.any()):
        topk_gm_exact.fallbacks += 1
        return streaming_topk(queries, (data, sqnorms), count, k, metric=metric,
                              kind=kind, chunk=chunk, query_norms=query_norms)
    return vals, ids


topk_gm_exact.fallbacks = 0


# ---------------------------------------------------------------------------
# K3: fused top-k
# ---------------------------------------------------------------------------


def _check_lo(lo, queries) -> None:
    if lo is None:
        return
    lo_d, lo_i = lo
    B = queries.shape[0]
    if tuple(lo_d.shape) != (B,) or tuple(lo_i.shape) != (B,):
        raise ValueError("the lower bound is a pair of [B] tensors")
    if lo_d.dtype != torch.float32 or lo_i.dtype != torch.int32:
        raise TypeError("the lower bound is (float32 distances, int32 ids)")
    for t in lo:
        if not t.is_contiguous() or t.device != queries.device:
            raise ValueError("the lower bound must be contiguous, on the queries' device")


def _fused_ranges(B: int, N: int) -> tuple:
    """(rows per range, number of ranges) of a fused launch: enough blocks
    to fill the card, ranges a whole number of the kernel's 128-row
    sub-tiles."""
    want = max(1, -(-_FUSED_BLOCKS // -(-B // _FUSED_BM)))
    rows = max(_FUSED_MIN_ROWS, -(-N // want))
    rows = -(-rows // _SUB_ROWS) * _SUB_ROWS
    return rows, -(-N // rows)


def fused_topk(queries: torch.Tensor, data: torch.Tensor, sqnorms: Optional[torch.Tensor],
               count: int, k: int, *, metric: VecSimMetric, lo: Optional[tuple] = None,
               query_norms: Optional[torch.Tensor] = None):
    """One pass of the fused kernel: the exact k <= 128 smallest (distance,
    id) per query in lexicographic order over rows < count, as (dists [B, k]
    fp32, ids [B, k] int32), unfilled slots (+inf, -1). With ``lo`` = (lo_d
    [B] fp32, lo_i [B] int32) only pairs lex-greater than a query's bound
    count.

    CUDA tensors launch one of K3's two kernels, chosen before the launch,
    each writing one sorted list per query and row range; the lists of a
    query are merged here with one exact top-k. The tensor-core kernel
    (``csrc/bf_topk_fused_tc.cu``, counted in ``fused_topk.tc_launches``)
    takes what ``fused_tc_admits``, the CUDA-core kernel
    (``csrc/bf_topk_fused.cu``, ``fused_topk.launches``) the rest. CPU
    tensors take ``fused_topk_ref``; anything else raises.
    """
    metric = VecSimMetric(metric)
    _check(queries, data, sqnorms, metric, query_norms)
    _check_lo(lo, queries)
    if not 0 < k <= PASS_K:
        raise ValueError(f"one fused pass takes 0 < k <= {PASS_K}, got {k}")
    if data.device.type == "cpu":
        return fused_topk_ref(queries, data, sqnorms, count, k, metric=metric, lo=lo,
                              query_norms=query_norms)
    B, D = queries.shape
    N = data.shape[0]
    count = max(0, min(int(count), N))
    tc = fused_tc_admits(queries, data)
    if tc:
        rows, n_ranges = _fused_tc_ranges(B, count, _sms(data.device))
    else:
        rows, n_ranges = _fused_ranges(B, N)
    qf, qi, rf = _lane_aux(queries, sqnorms, metric, query_norms)
    lo_d, lo_i = lo if lo is not None else (None, None)
    part_d = torch.empty((B, n_ranges, k), dtype=torch.float32, device=data.device)
    part_i = torch.empty((B, n_ranges, k), dtype=torch.int32, device=data.device)
    if tc:
        dsq = _dsq(data, metric, count)
        _run(fused_topk, "bf_topk_fused_tc", data, lambda kern, stream: kern.fused_tc(
            queries.data_ptr(), data.data_ptr(), _ptr(qf), _ptr(qi), _ptr(rf), _ptr(dsq),
            _ptr(lo_d), _ptr(lo_i), part_d.data_ptr(), part_i.data_ptr(), _LANES[data.dtype],
            B, D, N, rows, n_ranges, k, count, int(metric), stream), counter="tc_launches")
    else:
        _run(fused_topk, "bf_topk_fused", data, lambda kern, stream: kern.fused(
            queries.data_ptr(), data.data_ptr(), _ptr(qf), _ptr(qi), _ptr(rf), _ptr(lo_d),
            _ptr(lo_i), part_d.data_ptr(), part_i.data_ptr(), _LANES[data.dtype], B, D, N,
            rows, n_ranges, k, count, int(metric), stream))
    # Lists are lex-sorted and ranges are in id order, so _lex_topk's
    # lower-position rule on equal distances is the lower-id rule.
    vals, pos = _lex_topk(part_d.view(B, n_ranges * k), k)
    return vals, torch.gather(part_i.view(B, n_ranges * k), 1, pos)


fused_topk.launches = 0  # CUDA-core kernel
fused_topk.tc_launches = 0  # tensor-core kernel


def fused_tc_admits(queries: torch.Tensor, data: torch.Tensor) -> bool:
    """Whether the tensor-core K3 takes these tensors. It is the shared TMA
    gate of both tensor-core kernels, ``gm_tc_admits`` (``config.gm_tc_ok``
    on the row width and type, 16-byte aligned bases), named for K3's
    wrapper; the tensors it refuses go to the CUDA-core K3."""
    return gm_tc_admits(queries, data)


def _fused_tc_ranges(B: int, rows_live: int, sms: int) -> tuple:
    """(rows per range, number of ranges) of a tensor-core fused launch over
    the first ``rows_live`` rows: one block per SM in one wave (``sms //
    query blocks`` ranges, at least one), ranges a whole number of the
    kernel's 128-row sub-tiles and at least ``_FUSED_MIN_ROWS`` long. Fewer,
    longer ranges mean fewer list inserts; the grid is one wave because
    every block of a launch does the same work."""
    want = max(1, sms // -(-B // _FUSED_BM))
    rows = max(_FUSED_MIN_ROWS, -(-rows_live // want))
    rows = -(-rows // _SUB_ROWS) * _SUB_ROWS
    return rows, max(1, -(-rows_live // rows))


def fused_topk_ref(queries: torch.Tensor, data: torch.Tensor,
                   sqnorms: Optional[torch.Tensor], count: int, k: int, *,
                   metric: VecSimMetric, lo: Optional[tuple] = None,
                   query_norms: Optional[torch.Tensor] = None):
    """Plain PyTorch version of K3, on any device: chunked scores, the count
    mask, the lower bound, and a running exact top-k."""
    metric = VecSimMetric(metric)
    B = queries.shape[0]
    N = data.shape[0]
    best_d = torch.full((B, k), float("inf"), dtype=torch.float32, device=data.device)
    best_i = torch.full((B, k), -1, dtype=torch.int64, device=data.device)
    step = max(k, (1 << 26) // max(B, 1))  # rows per ~256 MB of scores
    for r0 in range(0, min(N, max(int(count), 0)), step):
        r1 = min(r0 + step, N)
        s = _masked(_scores(queries, data, sqnorms, metric, query_norms, r0, r1), r0, count)
        if lo is not None:
            ids = torch.arange(r0, r1, device=data.device)[None, :]
            lo_d, lo_i = lo[0][:, None], lo[1][:, None]
            s = torch.where((s > lo_d) | ((s == lo_d) & (ids > lo_i)), s, float("inf"))
        vals, pos = _lex_topk(s, min(k, r1 - r0))
        best_d, best_i = _merge_topk(best_d, best_i, vals, pos + r0, k)
    best_i = torch.where(torch.isfinite(best_d), best_i, -1)
    return best_d, best_i.to(torch.int32)


def topk_fused(queries: torch.Tensor, data: torch.Tensor, sqnorms: Optional[torch.Tensor],
               count: int, k: int, *, metric: VecSimMetric,
               query_norms: Optional[torch.Tensor] = None):
    """Exact top-k with the fused scan: (dists [B, k] fp32, ids [B, k]
    int64) sorted ascending, unfilled slots (+inf, -1). k > 128 runs
    ceil(k / 128) passes, each excluding everything lexicographically <= the
    last (distance, id) of the pass before: exact because every pass selects
    in (distance, id) order on the same scores."""
    n_passes = -(-k // PASS_K)
    pass_k = k if n_passes == 1 else PASS_K
    parts_d, parts_i = [], []
    for _ in range(n_passes):
        lo = (parts_d[-1][:, -1].contiguous(), parts_i[-1][:, -1].contiguous()) if parts_d else None
        pd, pi = fused_topk(queries, data, sqnorms, count, pass_k, metric=metric, lo=lo,
                            query_norms=query_norms)
        parts_d.append(pd)
        parts_i.append(pi)
    out_d = torch.cat(parts_d, dim=1)[:, :k]
    out_i = torch.cat(parts_i, dim=1)[:, :k].to(torch.int64)
    return out_d, torch.where(torch.isfinite(out_d), out_i, -1)


# ---------------------------------------------------------------------------
# K4: per-tile local top-c (large k)
# ---------------------------------------------------------------------------


def tile_topc(queries: torch.Tensor, data: torch.Tensor, sqnorms: Optional[torch.Tensor],
              count: int, *, metric: VecSimMetric, tile_n: int, c: int,
              query_norms: Optional[torch.Tensor] = None):
    """Each tile's c smallest (distance, id) per query in lexicographic
    order: (local_d [B, n_tiles, c] fp32, local_i [B, n_tiles, c] int32),
    rows >= count at +inf, unfilled slots (+inf, -1).

    CUDA tensors launch one of K4's two kernels, chosen before the launch:
    the tensor-core kernel (``bf_topk_topc_tc`` in
    ``csrc/bf_topk_fused_tc.cu``, counted in ``tile_topc.tc_launches``)
    where ``topc_tc_admits``, else the CUDA-core kernel
    (``csrc/bf_topk_topc.cu``, ``tile_topc.launches``). CPU tensors take
    ``tile_topc_ref``; anything else raises.
    """
    metric = VecSimMetric(metric)
    _check(queries, data, sqnorms, metric, query_norms)
    n_tiles = _check_tiles(data, tile_n)
    if not 0 < c <= min(MAX_C, tile_n):
        raise ValueError(f"the top-c kernel takes 0 < c <= min({MAX_C}, tile_n), got {c}")
    if data.device.type == "cpu":
        return tile_topc_ref(queries, data, sqnorms, count, metric=metric, tile_n=tile_n, c=c,
                             query_norms=query_norms)
    B, D = queries.shape
    count = max(0, min(int(count), data.shape[0]))
    qf, qi, rf = _lane_aux(queries, sqnorms, metric, query_norms)
    local_d = torch.empty((B, n_tiles, c), dtype=torch.float32, device=data.device)
    local_i = torch.empty((B, n_tiles, c), dtype=torch.int32, device=data.device)
    if not topc_tc_admits(queries, data, tile_n):
        _run(tile_topc, "bf_topk_topc", data, lambda kern, stream: kern.topc(
            queries.data_ptr(), data.data_ptr(), _ptr(qf), _ptr(qi), _ptr(rf),
            local_d.data_ptr(), local_i.data_ptr(), _LANES[data.dtype], B, D, n_tiles, tile_n,
            c, count, int(metric), stream))
        return local_d, local_i
    tiles, n_ranges = _topc_tc_ranges(B, -(-count // tile_n), _sms(data.device))
    # The kernel writes the lists of its ranges' tiles; the tiles past the
    # last range hold no live row.
    local_d[:, tiles * n_ranges:] = float("inf")
    local_i[:, tiles * n_ranges:] = -1
    dsq = _dsq(data, metric, count)
    _run(tile_topc, "bf_topk_topc_tc", data, lambda kern, stream: kern.topc_tc(
        queries.data_ptr(), data.data_ptr(), _ptr(qf), _ptr(qi), _ptr(rf), _ptr(dsq),
        local_d.data_ptr(), local_i.data_ptr(), _LANES[data.dtype], B, D, n_tiles, tile_n, c,
        count, tiles, n_ranges, int(metric), stream), counter="tc_launches")
    return local_d, local_i


tile_topc.launches = 0  # CUDA-core kernel
tile_topc.tc_launches = 0  # tensor-core kernel


def topc_tc_admits(queries: torch.Tensor, data: torch.Tensor, tile_n: int) -> bool:
    """Whether the tensor-core K4 takes these tensors: the tensor-core
    kernels' TMA gate ``gm_tc_admits`` and tiles of whole 128-row sub-tiles,
    so that every tile is one list of the kernel's ranges."""
    return tile_n % _SUB_ROWS == 0 and gm_tc_admits(queries, data)


def _topc_tc_ranges(B: int, live_tiles: int, sms: int) -> tuple:
    """(tiles per range, number of ranges) of a tensor-core top-c launch
    over the first ``live_tiles`` tiles: as ``_fused_tc_ranges``, one block
    per SM in one wave (``sms // query blocks`` ranges, at least one), the
    query blocks of a range next to each other, but ranges of whole
    tiles."""
    want = max(1, sms // -(-B // _FUSED_BM))
    tiles = max(1, -(-live_tiles // want))
    return tiles, max(1, -(-live_tiles // tiles))


def tile_topc_ref(queries: torch.Tensor, data: torch.Tensor, sqnorms: Optional[torch.Tensor],
                  count: int, *, metric: VecSimMetric, tile_n: int, c: int,
                  query_norms: Optional[torch.Tensor] = None):
    """Plain PyTorch version of K4, on any device: chunked scores and an
    exact top-c over each tile."""
    metric = VecSimMetric(metric)
    B = queries.shape[0]
    n_tiles = data.shape[0] // tile_n
    local_d = torch.empty((B, n_tiles, c), dtype=torch.float32, device=data.device)
    local_i = torch.empty((B, n_tiles, c), dtype=torch.int32, device=data.device)
    step = max(1, (1 << 26) // max(B * tile_n, 1))  # tiles per ~256 MB of scores
    for t0 in range(0, n_tiles, step):
        t1 = min(t0 + step, n_tiles)
        lo, hi = t0 * tile_n, t1 * tile_n
        s = _masked(_scores(queries, data, sqnorms, metric, query_norms, lo, hi), lo, count)
        vals, pos = _lex_topk(s.view(B * (t1 - t0), tile_n), c)
        base = torch.arange(t0, t1, device=data.device).repeat(B)[:, None] * tile_n
        ids = torch.where(torch.isfinite(vals), pos + base, -1)
        local_d[:, t0:t1] = vals.view(B, t1 - t0, c)
        local_i[:, t0:t1] = ids.view(B, t1 - t0, c).to(torch.int32)
    return local_d, local_i


def topk_bigk(queries: torch.Tensor, data: torch.Tensor, sqnorms: Optional[torch.Tensor],
              count: int, k: int, *, metric: VecSimMetric, tile_n: int = 4096,
              local_c: int = 32, query_norms: Optional[torch.Tensor] = None):
    """Top-k for large k via per-tile local top-c + one exact merge.

    Returns (dists [B, k], ids [B, k] int64, truncated [B] bool).
    ``truncated`` True means a tile filled all ``local_c`` slots inside the
    global top-k and may be hiding more: the caller must answer that batch
    from an exact path. Tie order is (distance, lower id): a tile's list is
    lex-sorted and the flat survivor positions are in id order, which
    ``_lex_topk`` keeps (``torch.topk`` promises no tie order).
    """
    B = queries.shape[0]
    n_tiles = data.shape[0] // tile_n
    c = min(local_c, tile_n)
    if n_tiles * c < k:
        raise ValueError(f"raise local_c: {n_tiles} tiles of {c} survivors cannot cover k={k}")
    local_d, local_i = tile_topc(queries, data, sqnorms, count, metric=metric, tile_n=tile_n,
                                 c=c, query_norms=query_norms)
    vals, pos = _lex_topk(local_d.view(B, n_tiles * c), k)
    ids = torch.gather(local_i.view(B, n_tiles * c), 1, pos).to(torch.int64)
    ids = torch.where(torch.isfinite(vals), ids, -1)
    worst = local_d[:, :, c - 1]  # each tile's c-th best
    truncated = ((worst <= vals[:, k - 1:k]) & torch.isfinite(worst)).any(dim=1)
    return vals, ids, truncated


def topk_bigk_exact(queries: torch.Tensor, data: torch.Tensor,
                    sqnorms: Optional[torch.Tensor], count: int, k: int, *,
                    metric: VecSimMetric, kind: str, tile_n: int = 4096, local_c: int = 32,
                    chunk: int = 1 << 16, query_norms: Optional[torch.Tensor] = None):
    """Big-k engine, unconditionally exact: a batch with any truncated query
    is answered by ``streaming_topk`` (``topk_bigk_exact.fallbacks`` counts
    those batches).

    As in ``topk_gm_exact``, the flag is read on the host once per call (a
    device sync); the JAX package keeps the choice on the device with
    ``lax.cond``.
    """
    vals, ids, truncated = topk_bigk(queries, data, sqnorms, count, k, metric=metric,
                                     tile_n=tile_n, local_c=local_c, query_norms=query_norms)
    if bool(truncated.any()):
        topk_bigk_exact.fallbacks += 1
        return streaming_topk(queries, (data, sqnorms), count, k, metric=metric,
                              kind=kind, chunk=chunk, query_norms=query_norms)
    return vals, ids


topk_bigk_exact.fallbacks = 0
