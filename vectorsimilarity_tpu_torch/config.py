"""Runtime engine configuration: the flat index's top-k and the HNSW graph.

Counterpart of ``vectorsimilarity_tpu/config.py``. For the flat index, the
engine bands stay the JAX package's, so both packages pick the same engine
for a given k:

- k <= ``gm_max_k``: the group-min engine (kernel K1, ``topk_gm_exact``);
- k <= ``max_k``: the fused top-k kernel (K3, ``topk_fused``);
- k <= ``bigk_max``: the per-tile local-top-c kernel (K4,
  ``topk_bigk_exact``),

all in ``ops/kernels/bf_topk.py``, for fp32, bf16, fp16, int8 and uint8
stores. The fused and big-k gates see k rounded up to a power of two, as the
JAX index passes it. fp64 stores, multi-value labels, range queries, the
batch iterator and the timeout-segmented scan stay on the exact
``ops.distances.streaming_topk`` / ``full_scores``.

Gates of the JAX package that existed only for the TPU are dropped: the
device check and ``use_pallas`` (the port runs the same engine logic on the
CPU with the kernels' plain versions), the minimum batch (a TPU compiler
workaround), the ``dim % 128`` lane alignment (a TPU relayout copy), the
VMEM budget and the fp32-precision gate (the port's fp32 lanes hold their
products within 2^-20 relative, under the coverage eps, whatever
``torch``'s matmul precision setting). One gate is the port's own:
``gm_tc_ok`` sends the group-min and fused engines' shapes to their
tensor-core kernels or their CUDA-core ones.
"""

from __future__ import annotations

import torch

# fp32 scores must stay within the group-min engine's coverage guard: the
# host (``ops/kernels/bf_topk.py``) holds the kernel's group minima against
# rescored distances under a 1e-5 relative eps, and plain TF32 (about 1e-3
# relative) would let a true neighbour hide in an unselected group and be
# lost silently. The rescore and every torch matmul of the port stay IEEE
# fp32: these are PyTorch's defaults, set so that no caller's setting can
# change the contract (cuDNN is not used on this path, set anyway). The
# kernels choose their own arithmetic: the CUDA-core ones run IEEE fp32
# FMAs, the tensor-core group-min kernel a 3xTF32 split whose products stay
# within 2^-20 relative (``csrc/bf_topk_gm_tc.cu``).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

# Rows per kernel tile and strided groups per tile of the group-min engine
# (group g of tile j holds rows j*tile_n + g + l*gm_group_n,
# l < tile_n // gm_group_n).
tile_n: int = 4096
gm_group_n: int = 256
gm_slack: int = 8
gm_max_k: int = 32

# Bands of the fused kernel (K3) and the big-k kernel (K4). ``local_c`` is the
# number of survivors each tile hands to the big-k merge. ``group_n`` is the
# width of the JAX fused kernel's compact selection view; the port's kernel
# keeps sorted lists instead and does not read it.
max_k: int = 128
group_n: int = 512
bigk_max: int = 2048
local_c: int = 32

# Timeout-aware queries scan bounded segments of this many rows, with the
# user's timeout callback polled between them.
timeout_poll_rows: int = 1 << 18

_KERNEL_DTYPES = {
    "float": (torch.float32, torch.bfloat16, torch.float16),
    "int": (torch.int8, torch.uint8),
}


def _kernel_common(kind: str, capacity: int, dtype) -> bool:
    """What every kernel engine needs: a store type with a scoring lane
    (fp64 has none) and a capacity that tiles evenly."""
    if dtype not in _KERNEL_DTYPES.get(kind, ()):
        return False
    return capacity % min(tile_n, capacity) == 0


def gm_enabled(kind: str, k: int, capacity: int, dtype) -> bool:
    """Gate of the group-min engine: k <= gm_max_k and enough groups for the
    coverage bound (``n_groups >= k + slack + 2``)."""
    if not _kernel_common(kind, capacity, dtype) or k > gm_max_k:
        return False
    tile = min(tile_n, capacity)
    n_groups = (capacity // tile) * min(gm_group_n, tile)
    return n_groups >= k + gm_slack + 2


def gm_tc_ok(dim: int, dtype) -> bool:
    """Gate of the tensor-core kernels of the group-min, fused and big-k
    engines (``csrc/bf_topk_gm_tc.cu``, ``csrc/bf_topk_fused_tc.cu``): a
    store type with a scoring lane and a row of ``dim`` elements whose byte
    length is a multiple of 16, the row stride a TMA load needs. The
    wrappers send every other shape to the CUDA-core kernels
    (``csrc/bf_topk_gm.cu``, ``csrc/bf_topk_fused.cu``,
    ``csrc/bf_topk_topc.cu``) before launching; the big-k one also needs
    tiles of a multiple of 128 rows (``topc_tc_admits``)."""
    lanes = _KERNEL_DTYPES["float"] + _KERNEL_DTYPES["int"]
    if dtype not in lanes or dim <= 0:
        return False
    return dim * torch.empty((), dtype=dtype).element_size() % 16 == 0


def fused_enabled(kind: str, k: int, capacity: int, dtype) -> bool:
    """Gate of the fused top-k kernel: k <= max_k."""
    return _kernel_common(kind, capacity, dtype) and k <= max_k


def bigk_enabled(kind: str, k: int, capacity: int, dtype) -> bool:
    """Gate of the per-tile local-top-c kernel: max_k < k <= bigk_max and
    enough tiles of survivors to cover k."""
    if not _kernel_common(kind, capacity, dtype) or not max_k < k <= bigk_max:
        return False
    return max(capacity // tile_n, 1) * local_c >= k


# ---------------------------------------------------------------------------
# HNSW (``ops/graph_search.py``, ``ops/graph_build.py``, ``indexes/hnsw.py``).
# The defaults are the JAX package's, so both packages build and search the
# same graph the same way.
# ---------------------------------------------------------------------------

# Connect each insert batch on the device (``graph_build.connect_batch``);
# ``False`` takes the host-orchestrated construction (the indexes'
# ``_connect_batch``: device beams and prunes, links and reverse edges
# written on the host).
graph_build_device: bool = True
build_batch: int = 1024  # max rows per connect_batch call (a power of two)
build_scan_batches: int = 4  # batches per ``build_scan`` call of a bulk build
build_reverse_cap: int = 16  # new back-edges joining one row's re-prune
build_beam_expand: int = 4  # candidates popped per construction-beam iteration
# Max rows one tiered insert-job execution migrates into the backend (the
# JAX package's value): each migration batch holds the backend lock for one
# connect call, so queries wait behind at most one short batch, and the rest
# of the queue coalesces into the next.
tiered_migrate_batch: int = 256
# bf16 navigation shadow of fp32 stores for construction beams: candidate
# RANKING gathers half the bytes; the diversity prune recomputes its anchor
# leg in fp32, so keep/discard compares stay fp32.
build_nav_bf16: bool = True

# Query-side beam expansion: candidates popped per search-beam iteration.
# "auto" picks 1 below ``search_expand_auto_ef`` and 4 at or above it; an int
# forces that expansion (1 = step-for-step ``searchLayer`` parity).
search_beam_expand = "auto"
search_expand_auto_ef: int = 192


def resolve_search_expand(ef: int) -> int:
    """Per-query beam expansion for runtime ef (see search_beam_expand)."""
    e = search_beam_expand
    if e == "auto":
        return 4 if ef >= search_expand_auto_ef else 1
    return max(int(e), 1)


# bf16 navigation shadow for QUERY beams of fp32 stores; the returned window
# is re-scored exactly in fp32 (``graph_search.exact_rerank``), so reported
# distances, tie order and the range radius filter stay exact.
search_nav_bf16: bool = True

# Beam-search iteration cap: max_iters = factor * ef + base (divided by the
# expansion), the bound on one search's loop.
beam_iter_factor: int = 8
beam_iter_base: int = 64
# The graph loops (greedy descent, beam search) read their "all rows done"
# flag from the device once every this many iterations, and timeout-aware
# HNSW queries poll the user's callback as often.
timeout_poll_iters: int = 32
