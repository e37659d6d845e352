"""Batches that the flat engines' host parts answered from the exact
streaming scan over the window (K1's uncovered queries, K4's truncated
tiles)."""

_K = "vectorsimilarity_tpu_torch.ops.kernels.bf_topk:"
COUNTERS = {"gm_fallbacks": _K + "topk_gm_exact.fallbacks",
            "bigk_fallbacks": _K + "topk_bigk_exact.fallbacks"}


def read(run):
    return run.counters["gm_fallbacks"] + run.counters["bigk_fallbacks"]
