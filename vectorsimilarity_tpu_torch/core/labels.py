"""Host-side label <-> internal-id bookkeeping.

The reference keeps ``label -> id`` hash maps next to the vector blocks
(``brute_force_single.h:16-212`` single-value, ``brute_force_multi.h:17-277``
multi-value with a label -> ids vector). Internal ids are dense in [0, count)
thanks to swap-with-last deletion.

Design note: the *reverse* direction (id -> label) is NOT kept here — indexes
store labels as a regular SoA field in their ``BlockStore`` (an int64 "label"
column, plus an int32 "slot" column for multi), so swap-with-last relocation
moves them automatically and device kernels can gather them. These maps own
only the forward direction and, for multi-value indexes, the dense label-slot
allocator that lets device kernels do per-label segment-min before top-k (the
replacement for the reference's per-label-best ``updatable_max_heap``,
``utils/updatable_heap.h:24-120``).
"""

from __future__ import annotations


class SingleLabelMap:
    """label -> single internal id."""

    def __init__(self):
        self.label_to_id: dict[int, int] = {}

    def __contains__(self, label: int) -> bool:
        return label in self.label_to_id

    def __len__(self) -> int:
        return len(self.label_to_id)

    def ids_of(self, label: int) -> list[int]:
        i = self.label_to_id.get(label)
        return [] if i is None else [i]

    def add(self, label: int, idx: int) -> None:
        self.label_to_id[label] = idx

    def remove_label(self, label: int) -> list[int]:
        idx = self.label_to_id.pop(label, None)
        return [] if idx is None else [idx]

    def on_swap(self, label: int, moved_to: int) -> None:
        """The row holding ``label`` was relocated to ``moved_to``."""
        self.label_to_id[label] = moved_to


class MultiLabelMap:
    """label -> set of internal ids, plus dense label slots for device kernels."""

    def __init__(self):
        self.label_to_ids: dict[int, set[int]] = {}
        self.label_to_slot: dict[int, int] = {}
        self._slot_to_label: dict[int, int] = {}
        self._free_slots: list[int] = []
        self._next_slot = 0

    def __contains__(self, label: int) -> bool:
        return label in self.label_to_ids

    def __len__(self) -> int:
        return len(self.label_to_ids)

    @property
    def num_slots(self) -> int:
        """High-water mark of allocated slots (device arrays sized by this)."""
        return self._next_slot

    def ids_of(self, label: int) -> list[int]:
        return sorted(self.label_to_ids.get(label, ()))

    def slot_of_label(self, label: int) -> int:
        return self.label_to_slot[label]

    def label_of_slot(self, slot: int) -> int:
        return self._slot_to_label[slot]

    def add(self, label: int, idx: int) -> int:
        """Register (label, id); returns the label's dense slot."""
        ids = self.label_to_ids.get(label)
        if ids is None:
            self.label_to_ids[label] = {idx}
            if self._free_slots:
                slot = self._free_slots.pop()
            else:
                slot = self._next_slot
                self._next_slot += 1
            self.label_to_slot[label] = slot
            self._slot_to_label[slot] = label
            return slot
        ids.add(idx)
        return self.label_to_slot[label]

    def remove_label(self, label: int) -> list[int]:
        ids = self.label_to_ids.pop(label, None)
        if ids is None:
            return []
        slot = self.label_to_slot.pop(label)
        del self._slot_to_label[slot]
        self._free_slots.append(slot)
        return sorted(ids, reverse=True)  # delete from the back first

    def remove_id(self, label: int, idx: int) -> None:
        """Drop one id of ``label``; the label (and its slot) goes with its
        last id."""
        ids = self.label_to_ids[label]
        ids.discard(idx)
        if not ids:
            del self.label_to_ids[label]
            slot = self.label_to_slot.pop(label)
            del self._slot_to_label[slot]
            self._free_slots.append(slot)

    def on_swap(self, label: int, moved_from: int, moved_to: int) -> None:
        ids = self.label_to_ids[label]
        ids.discard(moved_from)
        ids.add(moved_to)


def rebuild_labels(index) -> None:
    """Refill ``index.labels`` (a fresh map) from the store's host columns:
    ``label``, ``slot`` for a multi-value index, and ``flags`` where the
    index keeps tombstones (a tombstoned row has no label entry). The JAX
    package keeps this in ``utils/serializer.py`` (``_rebuild_labels``); here
    the serializer, the SVS folder loader and the bulk tombstone removal
    share it."""
    count = index.store.count
    labels = index.store.host["label"][:count]
    flags = index.store.host.get("flags")
    live = range(count) if flags is None else (i for i in range(count) if not flags[i] & 1)
    if not index.multi:
        for i in live:
            index.labels.label_to_id[int(labels[i])] = i
        return
    m = index.labels
    slots = index.store.host["slot"][:count]
    for i in live:
        lab, slot = int(labels[i]), int(slots[i])
        if lab in m.label_to_ids:
            m.label_to_ids[lab].add(i)
        else:
            m.label_to_ids[lab] = {i}
            m.label_to_slot[lab] = slot
            m._slot_to_label[slot] = lab
    if m._slot_to_label:
        m._next_slot = max(m._slot_to_label) + 1
    used = set(m._slot_to_label)
    m._free_slots = [s for s in range(m._next_slot) if s not in used]
