"""Set-up of an HNSW index through the port's public API.

``create_index`` with no device on the card (the CPU only where a test asks
for it), then ``bulk_build_device`` of the rows already on the device, the
port's build path for a corpus that is loaded whole.
"""

from __future__ import annotations

import time

import numpy as np
import torch


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build(cfg: dict, rows: np.ndarray, rows_dev: torch.Tensor, labels: np.ndarray, device):
    """(index, {"build_s", "build_vps"}) over ``rows_dev`` [n, D] with
    ``labels``; the build is timed to a device synchronisation."""
    from vectorsimilarity_tpu_torch import create_index
    from vectorsimilarity_tpu_torch import types as T

    n = int(cfg["n_rows"])
    index = create_index(T.VecSimParams(algo=T.VecSimAlgo.HNSWLIB, hnswParams=T.HNSWParams(
        type=T.VecSimType[cfg["type"]], dim=int(cfg["dim"]), metric=T.VecSimMetric[cfg["metric"]],
        M=int(cfg["M"]), efConstruction=int(cfg["efConstruction"]), initialCapacity=n)),
        device=None if device.type == "cuda" else device)
    _sync(device)
    t0 = time.perf_counter()
    index.bulk_build_device(rows_dev, labels=labels)
    _sync(device)
    build_s = time.perf_counter() - t0
    return index, {"build_s": build_s, "build_vps": n / build_s}


def query_params(traffic: dict):
    from vectorsimilarity_tpu_torch import types as T

    params = T.VecSimQueryParams()
    params.hnswRuntimeParams.efRuntime = int(traffic["ef_runtime"])
    return params
