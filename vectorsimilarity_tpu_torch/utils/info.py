"""Debug-info field iterator.

Counterpart of ``vectorsimilarity_tpu/utils/info.py``, restated (that package
imports jax). Reference: ``info_iterator.h`` / ``VecSimIndex_DebugInfoIterator``
— a flat (name, type, value) field list consumed by RediSearch FT.INFO.
Flattens the ``VecSimIndexDebugInfo`` dataclasses into the same shape.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Iterator


class InfoFieldType(enum.IntEnum):
    UINT64 = 0
    FLOAT64 = 1
    STRING = 2
    ITERATOR = 3


@dataclasses.dataclass
class InfoField:
    name: str
    type: InfoFieldType
    value: Any


def _field(name: str, value) -> InfoField:
    if isinstance(value, bool):
        return InfoField(name, InfoFieldType.UINT64, int(value))
    if isinstance(value, enum.Enum):
        return InfoField(name, InfoFieldType.STRING, value.name)
    if isinstance(value, int):
        return InfoField(name, InfoFieldType.UINT64, value)
    if isinstance(value, float):
        return InfoField(name, InfoFieldType.FLOAT64, value)
    return InfoField(name, InfoFieldType.STRING, str(value))


def _flatten(obj, prefix: str = "") -> Iterator[InfoField]:
    if obj is None:
        return
    if dataclasses.is_dataclass(obj):
        for f in dataclasses.fields(obj):
            v = getattr(obj, f.name)
            name = f"{prefix}{f.name}"
            if dataclasses.is_dataclass(v):
                yield InfoField(name, InfoFieldType.ITERATOR, list(_flatten(v)))
            elif isinstance(v, dict):
                yield InfoField(
                    name, InfoFieldType.ITERATOR, [_field(k, x) for k, x in v.items()]
                )
            elif v is not None:
                yield _field(name, v)
        return
    yield _field(prefix or "value", obj)


def debug_info_iterator(index) -> list[InfoField]:
    """``VecSimIndex_DebugInfoIterator`` parity: flat field list including a
    process-wide shared-memory field appended at the API boundary
    (vec_sim.cpp:380-392)."""
    fields = list(_flatten(index.debug_info()))
    fields.append(InfoField("SHARED_MEMORY", InfoFieldType.UINT64, get_shared_memory()))
    return fields


def get_shared_memory() -> int:
    """``VecSim_GetSharedMemory``: process-wide allocations not owned by any
    single index. Device memory is all index-owned, so this is the shared
    SVS worker pool's bookkeeping (0 while no SVS index uses it)."""
    from .thread_pool import SharedSVSThreadPool

    if not SharedSVSThreadPool.is_initialized():
        return 0
    return SharedSVSThreadPool.instance().shared_allocation_size()
