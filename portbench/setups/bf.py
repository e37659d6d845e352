"""Set-up of a flat (brute-force) index through the port's public API.

``create_index`` with no device on the card (the CPU only where a test asks
for it), then one ``add_vector_batch`` of every row from the host, as a
user loads a corpus: the index normalizes the rows, keeps its host mirror
and uploads the store at its first query.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def build(cfg: dict, rows: np.ndarray, rows_dev: torch.Tensor, labels: np.ndarray, device):
    """(index, {"build_s": seconds}) over ``rows`` [n, D] with ``labels``."""
    from vectorsimilarity_tpu_torch import create_index
    from vectorsimilarity_tpu_torch import types as T

    index = create_index(T.VecSimParams(algo=T.VecSimAlgo.BF, bfParams=T.BFParams(
        type=T.VecSimType[cfg["type"]], dim=int(cfg["dim"]), metric=T.VecSimMetric[cfg["metric"]],
        initialCapacity=int(cfg["capacity"]))),
        device=None if device.type == "cuda" else device)
    t0 = time.perf_counter()
    index.add_vector_batch(rows, labels)
    return index, {"build_s": time.perf_counter() - t0}


def query_params(traffic: dict):
    return None
