"""Top-k helpers, including per-label segment-min for multi-value indexes.

Counterpart of ``vectorsimilarity_tpu/ops/topk.py``. The reference's
multi-value indexes keep "best score per label" with an
``updatable_max_heap`` (``utils/updatable_heap.h:24-120``); here that is a
scatter-min over dense label slots followed by an ordinary top-k.
"""

from __future__ import annotations

import torch

from .distances import _lex_topk


def slot_min_scores(scores: torch.Tensor, slots: torch.Tensor, slot_cap: int) -> torch.Tensor:
    """Per-label-slot minimum distance.

    scores: [B, N] (+inf for masked/padded rows); slots: [N] int32 dense label
    slots, -1 for padded rows. Returns [B, slot_cap] with +inf for empty slots.
    """
    B = scores.shape[0]
    # Route padded rows (-1) to a scratch slot at index slot_cap.
    safe = torch.where(slots < 0, slot_cap, slots).to(torch.int64)
    out = torch.full((B, slot_cap + 1), float("inf"), dtype=scores.dtype, device=scores.device)
    out.scatter_reduce_(1, safe[None, :].expand(B, -1), scores, reduce="amin")
    return out[:, :slot_cap]


def topk_by_slot(scores: torch.Tensor, slots: torch.Tensor, slot_cap: int, k: int):
    """Top-k (smallest) per-label distances -> (dists[B,k], slot_ids[B,k]);
    equal distances come out lower slot first."""
    per_slot = slot_min_scores(scores, slots, slot_cap)
    return _lex_topk(per_slot, min(k, slot_cap))
