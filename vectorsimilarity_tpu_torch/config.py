"""Runtime engine configuration of the flat index's top-k.

Counterpart of ``vectorsimilarity_tpu/config.py`` for the flat index. The
engine bands stay the JAX package's, so both packages pick the same engine
for a given k:

- k <= ``gm_max_k``: the group-min engine (kernel K1,
  ``ops/kernels/bf_topk.py``);
- k <= ``max_k``: the single-buffer fused kernel (K3) in the JAX package;
- k <= ``bigk_max``: the per-tile local-top-c kernel (K4) in the JAX package.

K3, K4 and the bf16/fp16/int8/uint8 scoring lanes of K2 are not ported yet
(ROADMAP queue 2). Until they are, every store and k outside the group-min
engine's fp32 lane routes to the exact ``ops.distances.streaming_topk``.

Gates of the JAX package that existed only for the TPU are dropped: the
device check (the port runs the same engine logic on the CPU with the
kernel's plain version), the minimum batch (a TPU compiler workaround), the
``dim % 128`` lane alignment, the VMEM budget and the fp32-precision gate
(the kernel computes in IEEE fp32, not bf16_3x).
"""

from __future__ import annotations

import torch

# fp32 scoring must stay IEEE fp32 everywhere: the group-min engine's
# coverage test (``ops/kernels/bf_topk.py``) holds the kernel's group minima
# against rescored distances under a 1e-5 relative guard, and TF32 (about
# 1e-3 relative) would let a true neighbour hide in an unselected group and
# be lost silently. These are PyTorch's defaults for matmuls; set them so
# that no caller's setting can change the contract (cuDNN is not used on
# this path, set anyway).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
torch.set_float32_matmul_precision("highest")

# Rows per kernel tile and strided groups per tile (group g of tile j holds
# rows j*tile_n + g + l*group_n, l < tile_n // group_n).
tile_n: int = 4096
gm_group_n: int = 256
gm_slack: int = 8
gm_max_k: int = 32

# Bands of the engines still to port (K3: single-buffer, K4: big-k).
max_k: int = 128
bigk_max: int = 2048

# Timeout-aware queries scan bounded segments of this many rows, with the
# user's timeout callback polled between them.
timeout_poll_rows: int = 1 << 18


def gm_enabled(kind: str, k: int, capacity: int, dtype) -> bool:
    """Gate of the group-min engine: fp32 float stores, k <= gm_max_k, a
    capacity that tiles evenly, and enough groups for the coverage bound
    (``n_groups >= k + slack + 2``)."""
    if kind != "float" or dtype != torch.float32:
        return False
    if k > gm_max_k:
        return False
    tile = min(tile_n, capacity)
    if capacity % tile:
        return False
    n_groups = (capacity // tile) * min(gm_group_n, tile)
    return n_groups >= k + gm_slack + 2
