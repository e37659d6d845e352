"""Shared machinery for device-backed vector indexes.

Counterpart of ``vectorsimilarity_tpu/core/abstract_index.py`` (the
reference's ``VecSimIndexAbstract``, ``vec_sim_index.h:42-390``): owns
dim/type/metric/blockSize, the vector ``BlockStore`` on a torch device (the
current CUDA device unless the caller names another), and the preprocessing
pipeline (the reference's calculator +
preprocessors, ``spaces/computer/*``).
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np
import torch

from ..ops.normalize import needs_query_normalize
from ..types import (
    DEFAULT_BLOCK_SIZE,
    VecSimIndexBasicInfo,
    VecSimMetric,
    VecSimType,
    numpy_dtype,
)
from .interface import VecSimIndexBase
from .labels import MultiLabelMap, SingleLabelMap
from .store import BlockStore, FieldSpec, _bucket_capacity


def resolve_device(device) -> torch.device:
    """The device an entry point keeps its store on: ``None`` is the current
    CUDA device, and an error where there is none. The CPU is used only when
    the caller asks for it (``device="cpu"``)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: this package runs on the card by default; "
            "pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda", torch.cuda.current_device())


def pow2_bucket(n: int, lo: int = 1) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


class DeviceVectorIndex(VecSimIndexBase):
    """Base for device-backed indexes (BF, HNSW): vector store + labels +
    preprocessing."""

    def __init__(
        self,
        *,
        vtype: VecSimType,
        dim: int,
        metric: VecSimMetric,
        multi: bool,
        block_size: int,
        device=None,
        log_ctx: Any = None,
        extra_fields: Optional[dict[str, FieldSpec]] = None,
        initial_capacity: int = 0,
    ):
        super().__init__(log_ctx)
        if dim <= 0:
            raise ValueError("dim must be positive")
        self.vtype = VecSimType(vtype)
        self.dim = int(dim)
        self.metric = VecSimMetric(metric)
        self.multi = bool(multi)
        self.block_size = int(block_size) or DEFAULT_BLOCK_SIZE
        self.device = resolve_device(device)

        self.np_dtype = numpy_dtype(self.vtype)
        self.is_int = self.vtype in (VecSimType.INT8, VecSimType.UINT8)
        self.store_kind = "int" if self.is_int else "float"

        # fp64 stores compute in fp64 on the device (torch has it natively;
        # the JAX package does so only with x64 enabled).
        # bfloat16 rows are bfloat16 on the device also where numpy lacks the
        # type and the host mirror holds their fp32 values.
        self.data_dtype = torch.bfloat16 if self.vtype == VecSimType.BFLOAT16 else None
        fields: dict[str, FieldSpec] = {
            "data": FieldSpec((self.dim,), self.np_dtype, device_dtype=self.data_dtype)
        }
        fields["label"] = FieldSpec((), np.int64, fill=-1)
        if self.multi:
            fields["slot"] = FieldSpec((), np.int32, fill=-1)
        if self.metric == VecSimMetric.L2:
            # Precomputed ||v||^2 turns L2 scans into one matmul plus rank-1
            # updates (exact f32 for int inputs).
            sq_dtype = np.float64 if self.vtype == VecSimType.FLOAT64 else np.float32
            fields["sqnorm"] = FieldSpec((), sq_dtype)
        if self.is_int and self.metric == VecSimMetric.Cosine:
            fields["norm"] = FieldSpec((), np.float32)
        if extra_fields:
            # Per-row columns of the subclass (HNSW: level, links, flags).
            fields.update(extra_fields)

        self.store = BlockStore(fields, self.block_size, device=self.device)
        if initial_capacity:
            self.store._resize(_bucket_capacity(initial_capacity, self.block_size))
        self.labels = MultiLabelMap() if self.multi else SingleLabelMap()
        self._replicas: dict = {}  # device -> replica of the device tensors (_replica)

    # ------------------------------------------------------------------
    # Preprocessing (reference: preprocessors.h pipeline)
    # ------------------------------------------------------------------

    def _as_batch(self, blob: np.ndarray) -> np.ndarray:
        arr = np.asarray(blob)
        if arr.dtype != self.np_dtype:
            arr = arr.astype(self.np_dtype)
        arr = self._as_stored(arr)
        if arr.ndim == 1:
            arr = arr[None, :]
        if arr.shape[-1] != self.dim:
            raise ValueError(f"expected dim {self.dim}, got {arr.shape[-1]}")
        return arr

    def _as_stored(self, arr: np.ndarray) -> np.ndarray:
        """Host rows with the values the device copy holds: an fp32 host
        mirror of bfloat16 rows is rounded to bfloat16 values."""
        if self.data_dtype is None or arr.dtype != np.float32:
            return arr
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.data_dtype).float().numpy()

    def _normalize_rows(self, arr: np.ndarray) -> np.ndarray:
        acc = np.float64 if arr.dtype == np.float64 else np.float32
        v = arr.astype(acc)
        norms = np.sqrt(np.sum(v * v, axis=-1, keepdims=True))
        norms[norms == 0] = 1.0
        return self._as_stored((v / norms).astype(arr.dtype))

    def preprocess_storage(self, blob: np.ndarray) -> dict[str, np.ndarray]:
        """Blob -> storage field rows (CosinePreprocessor semantics:
        float cosine normalizes storage; int cosine keeps raw + norms)."""
        arr = self._as_batch(blob)
        rows: dict[str, np.ndarray] = {}
        if self.metric == VecSimMetric.Cosine and not self.is_int:
            arr = self._normalize_rows(arr)
        rows["data"] = arr
        if "sqnorm" in self.store.fields:
            if self.is_int:
                v64 = arr.astype(np.int64)
                rows["sqnorm"] = np.sum(v64 * v64, axis=-1).astype(np.float32)
            else:
                v = arr.astype(np.float32 if arr.dtype != np.float64 else np.float64)
                rows["sqnorm"] = np.sum(v * v, axis=-1).astype(
                    self.store.fields["sqnorm"].dtype
                )
        if "norm" in self.store.fields:
            v = arr.astype(np.int64)
            rows["norm"] = np.sqrt(np.sum(v * v, axis=-1).astype(np.float32))
        return rows

    def preprocess_queries(self, queries: np.ndarray):
        """Queries -> (host batch ready for upload, query_norms or None)."""
        arr = self._as_batch(queries)
        qnorms = None
        if needs_query_normalize(self.vtype, self.metric):
            arr = self._normalize_rows(arr)
        elif self.is_int and self.metric == VecSimMetric.Cosine:
            v = arr.astype(np.int64)
            qnorms = np.sqrt(np.sum(v * v, axis=-1).astype(np.float32))
        return arr, qnorms

    def to_device(self, arr: Optional[np.ndarray]) -> Optional[torch.Tensor]:
        """Upload a preprocessed host batch to the store's device."""
        if arr is None:
            return None
        if arr.dtype.name == "bfloat16":  # torch cannot wrap ml_dtypes arrays
            arr = arr.astype(np.float32)
        t = torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)
        if self.data_dtype is not None:
            t = t.to(self.data_dtype)
        return t

    def store_tuple(self, dev: dict[str, torch.Tensor]) -> tuple:
        """Device tensors in the layout ``ops.distances`` expects."""
        if self.is_int:
            return (dev["data"], dev.get("norm"))
        return (dev["data"], dev.get("sqnorm"))

    # ------------------------------------------------------------------
    # Multi-device query-parallel serving (graph indexes)
    # ------------------------------------------------------------------

    _qmesh = None

    def to_query_sharded(self, mesh):
        """Serve every batch search with the query batch cut over ``mesh``
        (``parallel.sharding.make_mesh``) and the graph replicated: slice i
        is searched on the mesh's device i. The graph indexes' scale-out
        axis: a proximity graph scales over QUERIES, while the flat scan
        shards DATA rows (``BruteForceIndex.to_sharded``)."""
        with self._lock:
            self._qmesh = mesh
        return self

    def _maybe_shard_queries(self, search, qd, qn=None, qm=None, mesh=None):
        """Run ``search(qd, qn, qm, device)`` over a device batch: whole, on
        the index's device (``device`` None), without a mesh; with one
        (``mesh``, else ``to_query_sharded``'s), padded to a multiple of the
        mesh size with copies of its last query and cut into slices, slice i
        searched on ``mesh.devices[i]``. Returns device (dists, ids) of the
        original rows on the index's device. Rows are independent, so the
        answers equal the unsharded search's."""
        mesh = self._qmesh if mesh is None else mesh
        if mesh is None:
            return search(qd, qn, qm, None)
        nq, S = qd.shape[0], mesh.size
        pad = (-nq) % S

        def padded(t):
            if t is None or not pad:
                return t
            return torch.cat([t, t[-1:].expand(pad, *t.shape[1:])])

        qd, qn = padded(qd), padded(qn)
        qm = None if qm is None else tuple(padded(m) for m in qm)
        w = qd.shape[0] // S
        outs = []
        for i, dev in enumerate(mesh.devices):
            def part(t):
                return None if t is None else t[i * w : (i + 1) * w].to(dev)

            bd, bi = search(part(qd), part(qn), None if qm is None else tuple(map(part, qm)), dev)
            outs.append((bd.to(self.device), bi.to(self.device)))
        return (torch.cat([o[0] for o in outs])[:nq], torch.cat([o[1] for o in outs])[:nq])

    def _replica(self, device, arrays: dict) -> dict:
        """The index's device tensors ``arrays`` on ``device``: themselves
        where ``device`` is the index's own, else copies, one set per
        distinct device, made at first use and made again once any source
        tensor changed (a mutation writes the store's tensors in place,
        which bumps their version, or replaces them)."""
        device = torch.device(device)
        if device == self.device:
            return arrays
        # The cache keeps the source tensors alive, so their ids stay theirs.
        key = {n: None if t is None else (id(t), t._version) for n, t in arrays.items()}
        hit = self._replicas.get(device)
        if hit is not None and hit[0] == key:
            return hit[2]
        copies = {n: None if t is None else t.to(device, copy=True) for n, t in arrays.items()}
        self._replicas[device] = (key, dict(arrays), copies)
        return copies

    # ------------------------------------------------------------------
    # Host-side exact distance (GetDistanceFrom parity)
    # ------------------------------------------------------------------

    def host_distance(self, idx: int, query: np.ndarray, qnorm=None) -> float:
        """Distance between stored row ``idx`` and a preprocessed query."""
        self.store.pull_host("data", "norm")  # no-op unless device-adopted
        v = self.store.host["data"][idx]
        if self.is_int:
            ip = int(np.dot(v.astype(np.int64), query.astype(np.int64)))
            if self.metric == VecSimMetric.IP:
                return float(1.0 - np.float32(ip))
            if self.metric == VecSimMetric.Cosine:
                denom = np.float32(self.store.host["norm"][idx]) * np.float32(qnorm)
                return float(1.0 - np.float32(ip) / denom)
            d = v.astype(np.int64) - query.astype(np.int64)
            return float(np.dot(d, d))
        acc = np.float64 if v.dtype == np.float64 else np.float32
        vv, qq = v.astype(acc), query.astype(acc)
        if self.metric == VecSimMetric.L2:
            d = vv - qq
            return float(np.dot(d, d))
        return float(1.0 - np.dot(vv, qq))

    # ------------------------------------------------------------------
    # Common info plumbing
    # ------------------------------------------------------------------

    @property
    def index_size(self) -> int:
        return self.store.count

    @property
    def index_label_count(self) -> int:
        return len(self.labels)

    def _basic_info(self, algo) -> VecSimIndexBasicInfo:
        return VecSimIndexBasicInfo(
            algo=algo,
            metric=self.metric,
            type=self.vtype,
            isMulti=self.multi,
            isTiered=False,
            isDisk=False,
            blockSize=self.block_size,
            dim=self.dim,
        )

    @property
    def memory_bytes(self) -> int:
        """The store's bytes and those of the query mesh's replicas."""
        return self.store.memory_bytes + sum(
            t.numel() * t.element_size()
            for _, _, copies in self._replicas.values() for t in copies.values() if t is not None
        )

    def contains_label(self, label: int) -> bool:
        return label in self.labels

    def get_stored_vectors(self, label: int) -> list[np.ndarray]:
        """White-box test hook (reference ``getDataByLabel``)."""
        self.store.pull_host("data")  # no-op unless device-adopted
        return [self.store.host["data"][i].copy() for i in self.labels.ids_of(label)]
