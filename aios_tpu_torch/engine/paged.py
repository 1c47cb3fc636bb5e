"""Host-side page tables for the paged KV pool.

The device holds a fixed page pool ([L, N, P, KH, D] per k/v) and reads it
through per-slot page tables; this module owns the mapping. Allocation is a
free-list pop, release a push. A pool that cannot back a grow request raises
``PoolExhausted`` so the batcher can retire a victim request instead of
corrupting anyone's cache.

Page 0 is the sacrificial page: never allocated, mapped by every unbacked
table entry, and the write target of inactive slots.

A copy of ``PageAllocator`` and ``PoolExhausted`` from
``aios_tpu/engine/paged.py``, window trimming included, without what the
port has not reached yet (replica partitions, shared prefix pages,
window+sink pruning). The caller (the engine, under its lock) serializes
access.
"""

from __future__ import annotations

from typing import List

import numpy as np

SACRIFICIAL_PAGE = 0


class PoolExhausted(RuntimeError):
    """No free pages left to back a prefill/decode grow request."""

    def __init__(self, needed: int, free: int):
        super().__init__(
            f"KV page pool exhausted: need {needed} page(s), {free} free"
        )
        self.needed = needed
        self.free = free


class PageAllocator:
    """Free-list allocator over ``num_pages`` physical pages of
    ``page_size`` rows, mapping ``num_slots`` slots x ``max_blocks`` logical
    blocks."""

    def __init__(self, num_pages: int, page_size: int, num_slots: int,
                 max_blocks: int) -> None:
        if num_pages < 2:
            raise ValueError("need at least 2 pages (one sacrificial)")
        self.num_pages = num_pages
        self.page_size = page_size
        self.num_slots = num_slots
        self.max_blocks = max_blocks
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        # host copy of the device tables; unbacked entries map page 0
        self.tables = np.full((num_slots, max_blocks), SACRIFICIAL_PAGE,
                              dtype=np.int32)
        self._blocks_used = np.zeros(num_slots, dtype=np.int64)
        # leading blocks of each slot already returned by trim_below_window
        self._trimmed = np.zeros(num_slots, dtype=np.int64)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def capacity_blocks(self) -> int:
        """Most blocks one slot can ever hold (every page but page 0)."""
        return self.num_pages - 1

    def pages_in_use(self) -> int:
        return self.num_pages - 1 - self.free_pages

    def blocks_for(self, rows: int) -> int:
        return -(-rows // self.page_size)

    def ensure(self, slot: int, rows: int) -> bool:
        """Back ``slot`` for ``rows`` logical rows, allocating any missing
        pages. Returns True iff the table changed. Raises PoolExhausted,
        leaving existing pages intact, when the free list cannot cover the
        growth."""
        need = min(self.blocks_for(rows), self.max_blocks)
        have = int(self._blocks_used[slot])
        if need <= have:
            return False
        if need - have > len(self._free):
            raise PoolExhausted(need - have, len(self._free))
        for b in range(have, need):
            self.tables[slot, b] = self._free.pop()
        self._blocks_used[slot] = need
        return True

    def free_slot(self, slot: int) -> None:
        """Return the slot's pages to the free list and remap its table row
        to the sacrificial page. Blocks released earlier by window trimming
        are already free and are skipped."""
        used = int(self._blocks_used[slot])
        for b in range(int(self._trimmed[slot]), used):
            self._free.append(int(self.tables[slot, b]))
        self.tables[slot, :used] = SACRIFICIAL_PAGE
        self._blocks_used[slot] = 0
        self._trimmed[slot] = 0

    def trim_below_window(self, slot: int, length: int, window: int) -> int:
        """Release the slot's leading blocks that sliding-window attention
        can never read again: block b is dead once its last row
        ``(b+1)*P - 1`` falls below ``length - window`` (window starts only
        move forward, and the decode kernels start reading at
        ``max(length + 1 - window, 0)``). The table entries keep their stale
        page ids; they are never read and ``ensure`` never rewinds. Returns
        the blocks freed now."""
        used = int(self._blocks_used[slot])
        dead = min(max(length - window, 0) // self.page_size, used)
        freed = 0
        for b in range(int(self._trimmed[slot]), dead):
            self._free.append(int(self.tables[slot, b]))
            freed += 1
        if dead > self._trimmed[slot]:
            self._trimmed[slot] = dead
        return freed

