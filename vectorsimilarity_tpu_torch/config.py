"""Runtime engine configuration of the flat index's top-k.

Counterpart of ``vectorsimilarity_tpu/config.py`` for the flat index. The
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
