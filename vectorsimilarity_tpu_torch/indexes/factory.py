"""Index factories — params to concrete index.

Counterpart of ``vectorsimilarity_tpu/indexes/factory.py`` (reference:
``index_factories/index_factory.cpp:17-73``): the flat, HNSW, SVS and tiered
indexes.
"""

from __future__ import annotations

import dataclasses

from ..types import (
    DEFAULT_BLOCK_SIZE,
    HNSW_DEFAULT_EF_C,
    HNSW_DEFAULT_EF_RT,
    HNSW_DEFAULT_EPSILON,
    HNSW_DEFAULT_M,
    SVS_VAMANA_DEFAULT_GRAPH_MAX_DEGREE,
    BFParams,
    HNSWParams,
    VecSimAlgo,
    VecSimParams,
    numpy_dtype,
)

def _with_defaults_bf(p: BFParams) -> BFParams:
    return dataclasses.replace(p, blockSize=p.blockSize or DEFAULT_BLOCK_SIZE)


def _with_defaults_hnsw(p: HNSWParams) -> HNSWParams:
    return dataclasses.replace(
        p,
        blockSize=p.blockSize or DEFAULT_BLOCK_SIZE,
        M=p.M or HNSW_DEFAULT_M,
        efConstruction=p.efConstruction or HNSW_DEFAULT_EF_C,
        efRuntime=p.efRuntime or HNSW_DEFAULT_EF_RT,
        epsilon=p.epsilon or HNSW_DEFAULT_EPSILON,
    )


def create_index(params: VecSimParams, *, device=None):
    """``VecSimIndex_New`` equivalent (``vec_sim.cpp:213``); the index keeps
    its store on ``device``: the current CUDA device by default (an error
    where there is none), the CPU only on request."""
    algo = VecSimAlgo(params.algo)
    if algo == VecSimAlgo.BF:
        from .brute_force import BruteForceIndex

        return BruteForceIndex(_with_defaults_bf(params.bfParams), params.logCtx,
                               device=device)
    if algo == VecSimAlgo.HNSWLIB:
        from .hnsw import HNSWIndex

        return HNSWIndex(_with_defaults_hnsw(params.hnswParams), params.logCtx,
                         device=device)
    if algo == VecSimAlgo.SVS:
        from .svs import SVSIndex

        return SVSIndex(params.svsParams, params.logCtx, device=device)
    if algo == VecSimAlgo.TIERED:
        from .tiered import create_tiered_index

        return create_tiered_index(params.tieredParams, params.logCtx, device=device)
    raise ValueError(f"unknown algo {algo}")


def estimate_initial_size(params: VecSimParams) -> int:
    """Rough initial memory footprint (``EstimateInitialSize`` parity)."""
    algo = VecSimAlgo(params.algo)
    p = params.algo_params
    if algo == VecSimAlgo.TIERED:
        return estimate_initial_size(p.primaryIndexParams) + 4096
    block = p.blockSize or DEFAULT_BLOCK_SIZE
    return block * (p.dim * numpy_dtype(p.type).itemsize + 16)


def estimate_element_size(params: VecSimParams) -> int:
    """Per-vector incremental memory (``EstimateElementSize`` parity)."""
    algo = VecSimAlgo(params.algo)
    p = params.algo_params
    if algo == VecSimAlgo.TIERED:
        return estimate_element_size(p.primaryIndexParams)
    base = p.dim * numpy_dtype(p.type).itemsize + 8 + 4
    if algo == VecSimAlgo.HNSWLIB:
        M = getattr(p, "M", 0) or HNSW_DEFAULT_M
        base += (2 * M + M) * 4  # level-0 + expected upper-level links
    if algo == VecSimAlgo.SVS:
        deg = p.graph_max_degree or SVS_VAMANA_DEFAULT_GRAPH_MAX_DEGREE
        base += deg * 4
        qv = int(p.quantBits or 0)
        if qv:
            # Quantized storage replaces the raw row: primary codes (+8
            # bytes of per-row scales), and secondary codes for the
            # two-level / LeanVec modes.
            bits = 8 if qv == 1 else qv & 0xFF
            res_bits = (qv >> 8) & 0xFF
            pdim = (p.leanvec_dim or p.dim // 2) if qv >> 16 else p.dim
            stored = ((pdim + 1) // 2 if bits == 4 else pdim) + 8
            if res_bits:
                stored += ((p.dim + 1) // 2 if res_bits == 4 else p.dim) + 8
            base = stored + 8 + 4 + deg * 4
    return base
