"""Index factories — params to concrete index.

Counterpart of ``vectorsimilarity_tpu/indexes/factory.py`` (reference:
``index_factories/index_factory.cpp:17-73``). Only the flat index is ported;
the other algorithms raise until their slice of the port lands (ROADMAP.md,
queue 1).
"""

from __future__ import annotations

import dataclasses

from ..types import DEFAULT_BLOCK_SIZE, BFParams, VecSimAlgo, VecSimParams

_NOT_PORTED = {
    VecSimAlgo.HNSWLIB: "HNSW is ROADMAP slice 3",
    VecSimAlgo.TIERED: "the tiered index is ROADMAP slice 4",
    VecSimAlgo.SVS: "SVS-Vamana is ROADMAP slice 5",
}


def _with_defaults_bf(p: BFParams) -> BFParams:
    return dataclasses.replace(p, blockSize=p.blockSize or DEFAULT_BLOCK_SIZE)


def create_index(params: VecSimParams, *, device=None):
    """``VecSimIndex_New`` equivalent (``vec_sim.cpp:213``); the index keeps
    its store on ``device``: the current CUDA device by default (an error
    where there is none), the CPU only on request."""
    algo = VecSimAlgo(params.algo)
    if algo == VecSimAlgo.BF:
        from .brute_force import BruteForceIndex

        return BruteForceIndex(_with_defaults_bf(params.bfParams), params.logCtx,
                               device=device)
    raise NotImplementedError(f"{algo.name} is not ported yet: {_NOT_PORTED[algo]}")
