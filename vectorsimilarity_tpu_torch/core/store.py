"""Device-resident vector storage — the port's ``DataBlocksContainer``.

Counterpart of ``vectorsimilarity_tpu/core/store.py``. One padded 2-D tensor
per field (SoA) on an explicit device, sized in doubling capacity buckets.
Deletion keeps the reference's swap-with-last semantics (ids stay dense in
[0, count)).

Host numpy mirrors are authoritative (they serve ``getDataByLabel``,
serialization and label mapping); the device copy is synced lazily before
compute. Unlike the JAX store, whose arrays are immutable and replaced on
each sync, the sync here writes the device tensors IN PLACE (``copy_`` of
the appended suffix, ``index_copy_`` of dirty rows and deferred moves): a
dict returned by an earlier ``device_arrays`` call sees later syncs.

``set_sharding(mesh)`` cuts the device copy into row shards over a list of
devices (``ShardedRows``): shard s holds rows [s * N / S, (s + 1) * N / S)
on the mesh's device s, and each row write lands in the shard that owns the
row. ``set_device`` moves an unsharded store to another device.
"""

from __future__ import annotations

import numpy as np
import torch

from ..types import DEFAULT_BLOCK_SIZE


def _bucket_capacity(n: int, block_size: int) -> int:
    """Smallest doubling bucket >= n (min one block)."""
    cap = max(block_size, DEFAULT_BLOCK_SIZE)
    while cap < n:
        cap *= 2
    return cap


def torch_dtype(dtype: np.dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype (bfloat16 via ml_dtypes' name)."""
    if np.dtype(dtype).name == "bfloat16":
        return torch.bfloat16
    return torch.from_numpy(np.empty(0, dtype=dtype)).dtype


def _to_device(rows: np.ndarray, device, dtype: torch.dtype) -> torch.Tensor:
    """A copy of host rows on ``device`` as ``dtype``. Always a copy, also on
    the CPU: the device tensors are written in place and must not alias the
    host mirrors."""
    if rows.dtype.name == "bfloat16":  # torch cannot wrap ml_dtypes arrays
        rows = rows.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(rows)).to(device, dtype, copy=True)


class ShardedRows:
    """A row-sharded [N, ...] tensor, the port's counterpart of a JAX array
    placed ``P(AXIS, ...)`` over a mesh: shard s holds rows [s * n_s,
    (s + 1) * n_s) on ``mesh.devices[s]``, n_s = N / S. Shards that follow
    each other on one device are views of one tensor (a "block"), so a
    device holds each of its rows once, however many shards it serves:
    on ``[cuda:0] * 4`` the four shards are four views of one tensor."""

    def __init__(self, mesh, blocks: list):
        self.mesh = mesh
        self.blocks = blocks  # [(lo, hi, tensor)], in row order, covering [0, N)
        first = blocks[0][2]
        self.shape = (blocks[-1][1], *first.shape[1:])
        self.dtype = first.dtype
        self.shard_n = self.shape[0] // mesh.size

    @classmethod
    def place(cls, t: torch.Tensor, mesh, *, copy: bool = False) -> "ShardedRows":
        """``t`` [N, ...] cut over ``mesh``. Without ``copy``, the rows a
        device already holds stay where they are (views of ``t``)."""
        n, S = t.shape[0], mesh.size
        if n % S:
            raise ValueError(f"{n} rows do not divide over {S} shards")
        w = n // S
        return cls(mesh, [(s0 * w, s1 * w, t[s0 * w : s1 * w].to(dev, copy=copy))
                          for dev, s0, s1 in mesh.runs()])

    def shard(self, s: int) -> torch.Tensor:
        """Shard ``s``'s rows, a view on its device."""
        lo, hi = s * self.shard_n, (s + 1) * self.shard_n
        for blo, bhi, t in self.blocks:
            if blo <= lo < bhi:
                return t[lo - blo : hi - blo]
        raise IndexError(s)

    def write_range(self, lo: int, hi: int, rows: torch.Tensor) -> None:
        """Rows [lo, hi) = ``rows``, each block writing its part in place."""
        for blo, bhi, t in self.blocks:
            a, b = max(lo, blo), min(hi, bhi)
            if a < b:
                t[a - blo : b - blo].copy_(rows[a - lo : b - lo])

    def write_rows(self, idx: torch.Tensor, rows: torch.Tensor) -> None:
        """Rows ``idx`` (int64, on the CPU) = ``rows``: each row lands in the
        shard that owns it."""
        for blo, bhi, t in self.blocks:
            mask = (idx >= blo) & (idx < bhi)
            if bool(mask.any()):
                t.index_copy_(0, (idx[mask] - blo).to(t.device), rows[mask].to(t.device))

    def read_rows(self, idx: torch.Tensor) -> torch.Tensor:
        """Rows ``idx`` (int64, on the CPU) gathered to the CPU."""
        out = torch.empty((len(idx), *self.shape[1:]), dtype=self.dtype)
        for blo, bhi, t in self.blocks:
            mask = (idx >= blo) & (idx < bhi)
            if bool(mask.any()):
                out[mask] = t.index_select(0, (idx[mask] - blo).to(t.device)).cpu()
        return out

    def read_range(self, lo: int, hi: int) -> torch.Tensor:
        """Rows [lo, hi) gathered to the CPU."""
        parts = [t[max(lo, blo) - blo : min(hi, bhi) - blo].cpu()
                 for blo, bhi, t in self.blocks if max(lo, blo) < min(hi, bhi)]
        if not parts:
            return torch.empty((0, *self.shape[1:]), dtype=self.dtype)
        return torch.cat(parts)

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for _, _, t in self.blocks)


class FieldSpec:
    """One SoA field: trailing shape + dtype + pad value. The host mirror
    and the device copy hold the same type, unless ``device_dtype`` names
    another for the device copy (bfloat16 rows over an fp32 host mirror where
    numpy has no bfloat16)."""

    def __init__(self, shape: tuple, dtype, fill=0, device_dtype=None):
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.fill = fill
        self.torch_dtype = device_dtype if device_dtype is not None else torch_dtype(self.dtype)


class BlockStore:
    """Growable SoA store with swap-with-last delete and lazy device sync.

    Usage::

        store = BlockStore({"data": FieldSpec((dim,), np.float32)}, block_size,
                           device="cuda")
        ids = store.append({"data": rows})           # rows [B, dim]
        moved = store.swap_delete(id)                # reference swap semantics
        dev = store.device_arrays()                  # synced torch tensors
    """

    def __init__(self, fields: dict[str, FieldSpec], block_size: int = DEFAULT_BLOCK_SIZE,
                 *, device="cpu"):
        self.fields = dict(fields)
        self.block_size = block_size or DEFAULT_BLOCK_SIZE
        self.device = torch.device(device)
        self.mesh = None  # row-sharded over this mesh (``set_sharding``)
        self.count = 0
        self.capacity = 0
        self.host: dict[str, np.ndarray] = {}
        self._device: dict[str, torch.Tensor] = {}
        # Fields whose DEVICE copy is authoritative (adopt_device); host
        # mirrors are pulled on demand.
        self._host_stale: set[str] = set()
        # Per-field dirty rows: a label update must not re-upload the (much
        # larger) vector column of the same row.
        self._dirty_rows: dict[str, set[int]] = {n: set() for n in self.fields}
        self._dirty_from: int = 0  # appended/overwritten suffix start
        # Deferred swap-delete row moves on device-authoritative fields:
        # {field: {dst: original_src}} applied as ONE gather+scatter per
        # field at the next sync, instead of pulling the device copy to the
        # host on every delete.
        self._pending_moves: dict[str, dict[int, int]] = {n: {} for n in self.fields}
        self._device_capacity = -1
        self._resize(_bucket_capacity(1, self.block_size))

    # -- capacity management -------------------------------------------------

    def _resize(self, new_cap: int) -> None:
        if self._host_stale and self._device:
            # Growth re-seeds host arrays and re-uploads them wholesale; any
            # device-authoritative content must reach the host first.
            self.pull_host()
        for name, spec in self.fields.items():
            arr = np.full((new_cap, *spec.shape), spec.fill, dtype=spec.dtype)
            if name in self.host and self.count:
                arr[: self.count] = self.host[name][: self.count]
            self.host[name] = arr
        self.capacity = new_cap

    def _maybe_grow(self, extra: int) -> None:
        need = self.count + extra
        if need > self.capacity:
            self._resize(_bucket_capacity(need, self.block_size))

    def add_field(self, name: str, spec: FieldSpec) -> None:
        """Register an extra SoA field after construction (the tiered
        frontend's per-row op-id column). Swap-with-last deletion and device
        sync treat it like a constructor-time field. The new field starts
        host-authoritative with no pending moves, and the next sync
        re-uploads every field: device-authoritative fields reach the host
        first, as on growth, so the re-upload carries their content."""
        if name in self.fields:
            raise ValueError(f"field {name!r} exists")
        if self._host_stale and self._device:
            self.pull_host()
        self.fields[name] = spec
        self.host[name] = np.full((self.capacity, *spec.shape), spec.fill, dtype=spec.dtype)
        self._dirty_rows[name] = set()
        self._pending_moves[name] = {}
        self._device_capacity = -1

    def maybe_shrink(self) -> None:
        """Shrink capacity when count has dropped far below the bucket."""
        target = _bucket_capacity(max(self.count, 1), self.block_size)
        if target < self.capacity and self.count <= target // 2:
            self._resize(target)

    # -- mutation ------------------------------------------------------------

    def append(self, rows: dict[str, np.ndarray]) -> np.ndarray:
        """Append a batch of rows; returns the assigned dense ids."""
        n = len(next(iter(rows.values())))
        self._maybe_grow(n)
        ids = np.arange(self.count, self.count + n, dtype=np.int64)
        for name, vals in rows.items():
            self.host[name][self.count : self.count + n] = vals
        self._dirty_from = min(self._dirty_from, self.count)
        self.count += n
        return ids

    def set_row(self, idx: int, rows: dict[str, np.ndarray]) -> None:
        """Overwrite one existing row (update-in-place path)."""
        for name, vals in rows.items():
            self.host[name][idx] = vals
            self._dirty_rows[name].add(int(idx))

    def swap_delete(self, idx: int) -> int:
        """Delete row ``idx`` by moving the last row into it.

        Returns the id of the row that moved into ``idx`` (== idx when the
        deleted row was the last). Mirrors ``removeElement`` swap-with-last
        (``data_blocks_container.h``).
        """
        last = self.count - 1
        if idx != last:
            for name in self.fields:
                if name in self._host_stale and not self._host_holds(name, last):
                    # Device-authoritative row: defer the move to the next
                    # device sync. Chains resolve at record time so one flat
                    # gather from the untouched device tensor is exact; a
                    # pending host write to ``idx`` is superseded.
                    mv = self._pending_moves[name]
                    mv[int(idx)] = mv.get(int(last), int(last))
                    self._dirty_rows[name].discard(int(idx))
                else:
                    # Host holds the authoritative content for row ``last``
                    # (filled mirror, un-synced append suffix, or set_row).
                    if name in self._host_stale:
                        # This newer host write supersedes an earlier
                        # deferred move into ``idx``: moves flush first.
                        self._pending_moves[name].pop(int(idx), None)
                    self.host[name][idx] = self.host[name][last]
                    self._dirty_rows[name].add(int(idx))
        self.count = last
        return last

    def _host_holds(self, name: str, row: int) -> bool:
        """Whether the host mirror holds the newest content of ``row``."""
        return row >= self._dirty_from or row in self._dirty_rows[name]

    def mark_dirty(self, idx: int, *fields: str) -> None:
        """Record a direct host-array edit so device sync picks it up.

        Pass the touched field names; with none given, all fields are
        assumed touched (safe but costs sync bandwidth)."""
        for name in fields or self.fields:
            self._dirty_rows[name].add(int(idx))

    # -- device sync ---------------------------------------------------------

    def _flush_moves(self) -> None:
        """Apply deferred swap-delete row moves to the device tensors.

        One gather (a copy) then one in-place scatter per field. Runs BEFORE
        host uploads in ``device_arrays`` (a host write to a moved row is
        newer and must win) and before any ``pull_host``."""
        for name, mv in self._pending_moves.items():
            if not mv:
                continue
            dst = torch.tensor(list(mv.keys()), dtype=torch.int64)
            src = torch.tensor(list(mv.values()), dtype=torch.int64)
            mv.clear()
            arr = self._device[name]
            if isinstance(arr, ShardedRows):
                arr.write_rows(dst, arr.read_rows(src))
            else:
                dst, src = dst.to(self.device), src.to(self.device)
                arr.index_copy_(0, dst, arr.index_select(0, src))

    def device_arrays(self) -> dict[str, torch.Tensor]:
        """Return the device tensors, applying pending host mutations.

        A capacity change re-uploads every field; otherwise appends upload
        the dirty suffix with one ``copy_`` per field and scattered row edits
        with one ``index_copy_`` per field, in place.
        """
        self._flush_moves()
        if self._device_capacity != self.capacity:
            for name in self.fields:
                self._device[name] = self._upload(self.host[name], self.fields[name].torch_dtype)
            self._device_capacity = self.capacity
            for dset in self._dirty_rows.values():
                dset.clear()
            self._dirty_from = self.count
            return dict(self._device)

        start = self._dirty_from
        if start < self.count:
            for name in self.fields:
                arr, dtype = self._device[name], self.fields[name].torch_dtype
                if isinstance(arr, ShardedRows):
                    arr.write_range(start, self.count,
                                    _to_device(self.host[name][start : self.count], "cpu", dtype))
                else:
                    arr[start : self.count].copy_(
                        _to_device(self.host[name][start : self.count], self.device, dtype))
            for name, dset in self._dirty_rows.items():
                self._dirty_rows[name] = {r for r in dset if r < start}

        for name, dset in self._dirty_rows.items():
            if not dset:
                continue
            idx = np.fromiter(dset, dtype=np.int64, count=len(dset))
            arr, dtype = self._device[name], self.fields[name].torch_dtype
            if isinstance(arr, ShardedRows):
                arr.write_rows(torch.from_numpy(idx), _to_device(self.host[name][idx], "cpu", dtype))
            else:
                rows = _to_device(self.host[name][idx], self.device, dtype)
                arr.index_copy_(0, torch.from_numpy(idx).to(self.device), rows)
            dset.clear()
        self._dirty_from = self.count
        return dict(self._device)

    def _upload(self, host: np.ndarray, dtype: torch.dtype):
        """A fresh device copy of a whole host column: one tensor on the
        store's device, or ``ShardedRows`` over the mesh."""
        if self.mesh is None:
            return _to_device(host, self.device, dtype)
        S = self.mesh.size
        if host.shape[0] % S:
            raise ValueError(f"capacity {host.shape[0]} does not divide over {S} shards")
        w = host.shape[0] // S
        return ShardedRows(self.mesh, [(s0 * w, s1 * w, _to_device(host[s0 * w : s1 * w], dev, dtype))
                                       for dev, s0, s1 in self.mesh.runs()])

    def set_sharding(self, mesh) -> None:
        """Row-shard the device copy over ``mesh`` (the multi-device flat
        scan): each field becomes ``ShardedRows``, shard s on
        ``mesh.devices[s]``. The capacity must divide by the mesh size, and
        every capacity bucket after growth is re-sharded. The synced device
        copy is cut in place: rows already on their shard's device stay
        where they are (no copy on a one-device mesh), the others are
        copied to theirs, and device-authoritative fields stay so."""
        if self.capacity % mesh.size:
            raise ValueError(f"capacity {self.capacity} does not divide over {mesh.size} shards")
        dev = self.device_arrays()
        self.mesh = mesh
        self._device = {n: ShardedRows.place(t, mesh) for n, t in dev.items()}

    def set_device(self, device) -> None:
        """Move the whole device copy to ``device`` (one shard's store of the
        data-sharded graph indexes lives on its own device). Not for a
        row-sharded store."""
        if self.mesh is not None:
            raise ValueError("the store is row-sharded")
        self.device = torch.device(device)
        self._device = {n: t.to(self.device) for n, t in self._device.items()}

    def adopt_device(self, arrays: dict[str, torch.Tensor], count: int) -> None:
        """Bulk-load device-resident data as the compute copy.

        For ingest pipelines whose data is already on the device: the given
        tensors (on the store's device, padded to a capacity bucket) become
        the device copy directly — no host->device upload. Host mirrors are
        allocated and NOT filled; host-side reads are only valid after
        ``pull_host`` or after the caller fills them. Missing fields get
        zeroed device tensors.
        """
        if self.mesh is not None:
            raise ValueError("adopt into an unsharded store, then set_sharding")
        cap = next(iter(arrays.values())).shape[0]
        if cap != _bucket_capacity(cap, self.block_size):
            raise ValueError(f"pad adopted arrays to a capacity bucket, got {cap} rows")
        for name, arr in arrays.items():
            spec = self.fields[name]
            # A CPU tensor reports device "cpu" whatever CPU index it was
            # moved to (a mesh may name "cpu:0", "cpu:1" as distinct devices).
            on_cpu = arr.device.type == self.device.type == "cpu"
            if (arr.device != self.device and not on_cpu) or arr.dtype != spec.torch_dtype:
                raise ValueError(
                    f"field {name!r}: expected {spec.torch_dtype} on {self.device}, "
                    f"got {arr.dtype} on {arr.device}"
                )
            if tuple(arr.shape) != (cap, *spec.shape):
                raise ValueError(f"field {name!r}: shape {tuple(arr.shape)}")
        self._host_stale = set()
        self._device = {}
        self.count = 0
        self._resize(cap)
        self.count = count
        for name, spec in self.fields.items():
            if name in arrays:
                self._device[name] = arrays[name].contiguous()
            else:
                self._device[name] = torch.zeros(
                    (cap, *spec.shape), dtype=spec.torch_dtype, device=self.device
                )
        self._device_capacity = cap
        for dset in self._dirty_rows.values():
            dset.clear()
        for mv in self._pending_moves.values():
            mv.clear()
        self._dirty_from = count
        self._host_stale = set(arrays)

    def pull_host(self, *fields: str) -> None:
        """Download device-authoritative fields into their host mirrors.

        With no names given, pulls every field marked host-stale (by
        ``adopt_device`` or ``mark_host_stale``). Rows whose newest content
        is on the host (the un-synced append suffix and rows written by
        ``set_row`` or a swap-delete from that suffix) are NOT overwritten.
        The JAX store overwrites them (``vectorsimilarity_tpu/core/store.py``
        ``pull_host``), which brings a deleted row's content back after
        ``adopt_device`` -> append -> ``swap_delete`` -> ``pull_host``.
        """
        self._flush_moves()
        names = [f for f in (fields or tuple(self._host_stale)) if f in self._host_stale]
        if not names or not self.count:
            self._host_stale -= set(names)
            return
        top = min(self._dirty_from, self.count)
        for name in names:
            spec = self.fields[name]
            keep = sorted(r for r in self._dirty_rows[name] if r < top)
            saved = self.host[name][keep].copy()
            arr = self._device[name]
            dev = arr.read_range(0, top) if isinstance(arr, ShardedRows) else arr[:top]
            if dev.dtype == torch.bfloat16:
                dev = dev.float()
            self.host[name][:top] = dev.cpu().numpy().astype(spec.dtype, copy=False)
            self.host[name][keep] = saved
        self._host_stale -= set(names)

    def mark_host_stale(self, *fields: str) -> None:
        """Declare device copies authoritative for ``fields`` (device-side
        construction wrote them); host reads must ``pull_host`` first."""
        self._host_stale.update(fields)

    # -- accounting ----------------------------------------------------------

    @property
    def memory_bytes(self) -> int:
        """Actual bytes held: host mirrors + device tensors."""
        host = sum(a.nbytes for a in self.host.values())
        dev = sum(t.nbytes if isinstance(t, ShardedRows) else t.numel() * t.element_size()
                  for t in self._device.values())
        return host + dev
