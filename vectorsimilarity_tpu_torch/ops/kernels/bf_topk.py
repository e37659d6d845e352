"""Group-min engine of the flat index: kernel K1 and its host part.

Counterpart of the group-min engine in
``vectorsimilarity_tpu/ops/pallas/bf_topk.py`` (``_make_gm_kernel``,
``pallas_topk_gm``, ``pallas_topk_gm_exact``), fp32 lane only.

The kernel (``csrc/bf_topk_gm.cu``, CUDA C++ for sm_90a) scores every store
row against the query batch and writes only the strided group minima of each
``tile_n``-row tile: group g of tile j holds rows ``j*tile_n + g + l*G``,
``l < L = tile_n / G``. No selection state lives in the kernel. The host part,
plain PyTorch on the same device, then

1. takes the S+1 smallest group minima per query (S = k + slack) with the
   exact (distance, position) selector ``_lex_topk``;
2. gathers the S*L member rows of the S suspect groups, sorted by id;
3. rescores them in IEEE fp32 with a batched matmul (the streaming engine's
   formula) and selects the k best in (distance, id) order;
4. flags a query as uncovered when the k-th rescored distance does not beat
   the first unselected group minimum by eps (a true neighbour may then hide
   in an unselected group).

Any true top-k row lies in a group whose minimum is <= the true k-th
distance, so it can be missed only if that group ranks below the S suspects,
which the coverage flag detects. ``topk_gm_exact`` answers a batch with any
uncovered query from the exact ``streaming_topk`` instead.

On a CUDA tensor ``group_min_scores`` launches the kernel or raises; only a
tensor on the CPU takes the plain version ``group_min_scores_ref``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

from ...types import VecSimMetric
from ..distances import _lex_topk, scores_float, streaming_topk

_SRC = Path(__file__).resolve().parents[2] / "csrc" / "bf_topk_gm.cu"
_BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
               "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


class _Kernel:
    """The built and loaded shared library of ``bf_topk_gm.cu``."""

    def __init__(self, path: Path, build_log: str, build_seconds: float):
        self.path = path
        self.build_log = build_log  # nvcc/ptxas output (registers, spills)
        self.build_seconds = build_seconds
        lib = ctypes.CDLL(str(path))
        self.fn = lib.bf_topk_gm_f32
        self.fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        self.fn.restype = ctypes.c_int


_kernel: Optional[_Kernel] = None


def _nvcc() -> str:
    for base in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if base and os.path.exists(os.path.join(base, "bin", "nvcc")):
            return os.path.join(base, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def load_kernel() -> _Kernel:
    """Build ``csrc/bf_topk_gm.cu`` into ``build/torch_kernels/`` at first
    use (the file name carries a hash of the source and flags, so an edited
    source rebuilds) and load it with ctypes."""
    global _kernel
    if _kernel is not None:
        return _kernel
    src = _SRC.read_bytes()
    tag = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:12]
    out = _BUILD_DIR / f"libbf_topk_gm_{tag}.so"
    log, seconds = "", 0.0
    if not out.exists():
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        res = subprocess.run([_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                             capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {_SRC}:\n{res.stdout}\n{res.stderr}")
        os.replace(tmp, out)
        log = res.stdout + res.stderr
    _kernel = _Kernel(out, log, seconds)
    return _kernel


# ---------------------------------------------------------------------------
# K1: group minima
# ---------------------------------------------------------------------------


def _check(queries, data, sqnorms, metric, tile_n, group_n) -> int:
    """Validate a group-min call; returns G."""
    if queries.dim() != 2 or data.dim() != 2 or queries.shape[1] != data.shape[1]:
        raise ValueError(f"shapes {tuple(queries.shape)} and {tuple(data.shape)}")
    G = min(group_n, tile_n)
    if data.shape[0] % tile_n or tile_n % G:
        raise ValueError(f"N={data.shape[0]} must be a multiple of tile_n={tile_n}, "
                         f"and tile_n of G={G}")
    tensors = [queries, data]
    if metric == VecSimMetric.L2:
        if sqnorms is None or tuple(sqnorms.shape) != (data.shape[0],):
            raise ValueError("L2 needs sqnorms [N]")
        tensors.append(sqnorms)
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"the group-min kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError("the group-min kernel takes contiguous tensors")
        if t.device != data.device:
            raise ValueError(f"tensors on {t.device} and {data.device}")
    return G


def group_min_scores(queries: torch.Tensor, data: torch.Tensor,
                     sqnorms: Optional[torch.Tensor], count: int, *,
                     metric: VecSimMetric, tile_n: int, group_n: int) -> torch.Tensor:
    """Strided group minima ``gm [B, (N / tile_n) * G]`` (fp32) of the score
    tiles, rows >= count at +inf.

    CUDA tensors launch the kernel (``group_min_scores.launches`` counts the
    launches); CPU tensors take ``group_min_scores_ref``; anything else
    raises.
    """
    metric = VecSimMetric(metric)
    G = _check(queries, data, sqnorms, metric, tile_n, group_n)
    if data.device.type == "cpu":
        return group_min_scores_ref(queries, data, sqnorms, count,
                                    metric=metric, tile_n=tile_n, group_n=group_n)
    return _launch(queries, data, sqnorms, count, metric, tile_n, G)


group_min_scores.launches = 0


def _launch(queries, data, sqnorms, count, metric, tile_n, G) -> torch.Tensor:
    if data.device.type != "cuda":
        raise ValueError(f"the group-min kernel runs on CUDA tensors, got {data.device}")
    B, D = queries.shape
    N = data.shape[0]
    l2 = metric == VecSimMetric.L2
    qaux = torch.sum(queries * queries, dim=1) if l2 else None
    out = torch.empty((B, (N // tile_n) * G), dtype=torch.float32, device=data.device)
    fn = load_kernel().fn
    stream = torch.cuda.current_stream(data.device).cuda_stream
    with torch.cuda.device(data.device):
        err = fn(queries.data_ptr(), data.data_ptr(),
                 None if qaux is None else qaux.data_ptr(),
                 None if not l2 else sqnorms.data_ptr(), out.data_ptr(),
                 B, D, N // tile_n, tile_n, G, min(int(count), N), int(l2), stream)
    if err != 0:
        raise RuntimeError(f"bf_topk_gm_f32 launch failed: cudaError_t {err}")
    group_min_scores.launches += 1
    return out


def group_min_scores_ref(queries: torch.Tensor, data: torch.Tensor,
                         sqnorms: Optional[torch.Tensor], count: int, *,
                         metric: VecSimMetric, tile_n: int, group_n: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device: a chunked fp32
    matmul (``scores_float``) and an ``amin`` over the strided group view."""
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
        sqn = None if metric != VecSimMetric.L2 else sqnorms[lo:hi]
        s = scores_float(queries, data[lo:hi], metric, sqn)
        rows = torch.arange(lo, hi, device=data.device)
        s = torch.where(rows[None, :] < count, s, float("inf"))
        # Row t*tile_n + l*G + g of the chunk is element [t, l, g].
        out[:, t0:t1] = s.view(B, t1 - t0, L, G).amin(dim=2)
    return out.view(B, n_tiles * G)


# ---------------------------------------------------------------------------
# Host part: suspect rescue, coverage flag, exact fallback
# ---------------------------------------------------------------------------


def topk_gm(queries: torch.Tensor, data: torch.Tensor, sqnorms: Optional[torch.Tensor],
            count: int, k: int, *, metric: VecSimMetric, tile_n: int = 4096,
            group_n: int = 256, slack: int = 8):
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
    gm = group_min_scores(queries, data, sqnorms, count,
                          metric=metric, tile_n=tile_n, group_n=group_n)
    gvals, gpos = _lex_topk(gm, S + 1)  # [B, S+1] smallest group minima
    m_next = gvals[:, S]  # first UNSELECTED group's min (coverage bound)
    sus = gpos[:, :S]  # flat group index t = tile*G + g
    # Group g of tile j holds rows j*tile_n + g + l*G. Sorting each row of
    # member ids makes _lex_topk's lower-position tie rule a lower-id rule.
    lane = torch.arange(L, device=data.device, dtype=torch.int64) * G
    mem = ((sus // G) * tile_n + sus % G)[:, :, None] + lane
    mem = torch.sort(mem.reshape(B, S * L), dim=1).values
    rows = data[mem]  # [B, S*L, D] gather
    ip = torch.bmm(rows, queries[:, :, None])[:, :, 0]
    if metric == VecSimMetric.L2:
        qsq = torch.sum(queries * queries, dim=1, keepdim=True)
        d = qsq - 2.0 * ip + sqnorms[mem]
    else:
        d = 1.0 - ip
    d = torch.where(mem < count, d, float("inf"))
    vals, pos = _lex_topk(d, k)
    ids = torch.gather(mem, 1, pos)
    ids = torch.where(torch.isfinite(vals), ids, -1)
    # Coverage: the k-th best must beat every unselected group's minimum by
    # eps, which covers the kernel-vs-rescore fp32 summation-order skew (see
    # the precision note in csrc/bf_topk_gm.cu).
    kth = vals[:, k - 1]
    eps = 1e-5 * torch.clamp(torch.maximum(kth.abs(), m_next.abs()), min=1.0)
    uncovered = ~(kth < m_next - eps)
    return vals, ids, uncovered


def topk_gm_exact(queries: torch.Tensor, data: torch.Tensor,
                  sqnorms: Optional[torch.Tensor], count: int, k: int, *,
                  metric: VecSimMetric, tile_n: int = 4096, group_n: int = 256,
                  slack: int = 8, chunk: int = 1 << 16):
    """Group-min engine, unconditionally exact: a batch with any uncovered
    query is answered by ``streaming_topk`` (``topk_gm_exact.fallbacks``
    counts those batches).

    The JAX package fuses that choice into the program (``lax.cond``). Here
    it costs one host read of the flag per call, a device sync that stops
    consecutive batches from overlapping.
    """
    vals, ids, uncovered = topk_gm(queries, data, sqnorms, count, k, metric=metric,
                                   tile_n=tile_n, group_n=group_n, slack=slack)
    if bool(uncovered.any()):
        topk_gm_exact.fallbacks += 1
        return streaming_topk(queries, (data, sqnorms), count, k, metric=metric,
                              kind="float", chunk=chunk)
    return vals, ids


topk_gm_exact.fallbacks = 0
