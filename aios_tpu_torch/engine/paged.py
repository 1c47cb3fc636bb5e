"""Host-side page tables for the paged KV pool, and the prompt-prefix index.

The device holds a fixed page pool ([L, N, P, KH, D] per k/v) and reads it
through per-slot page tables; this module owns the mapping. Allocation is a
free-list pop, release a push. A pool that cannot back a grow request raises
``PoolExhausted`` so the batcher can retire a victim request instead of
corrupting anyone's cache.

Page 0 is the sacrificial page: never allocated, mapped by every unbacked
table entry, and the write target of inactive slots.

Pages carry a reference count: a slot's table holds one reference on each
page it maps, and the prefix index one on each page it caches, so a prompt's
leading full blocks outlive the request that computed them and map, shared
and read-only, into the next prompt with the same prefix
(``PrefixIndex``, ``RadixPrefixIndex``, keyed by ``chain_hashes``). When the
free list runs dry, the allocator asks the index (its ``reclaimer``) to drop
cold pages that nothing else holds.

Behind the index sits an optional host-RAM tier (``HostPageStore``): an
evicted prefix page's K/V is handed to the index's ``spill`` hook before its
reference drops, copied to host memory, and a later prompt whose chain
continues there gets it back with a copy instead of a prefill forward. The
tier's entries cross processes in the KVX1 wire format (``pack_entry``,
``unpack_entry``), and both indexes and the tier feed the fleet's prefix
digest (``digest``, ``HostPageStore.stored_hashes``).

Copies of ``PageAllocator``, ``PoolExhausted``, ``chain_hashes``,
``PrefixIndex``, ``RadixPrefixIndex``, ``HostPageStore`` and the KVX1 wire
format from ``aios_tpu/engine/paged.py``, window trimming included, without
what the port has not reached yet (replica partitions, window+sink
pruning). The caller (the engine, under its lock) serializes access to the
allocator; each index and the host store also have a lock of their own. The
allocator's ``allocator.pressure`` fault point raises ``PoolExhausted`` on
demand; ``host_store.corrupt`` flips a byte of a matched host entry.

A bf16 page is kept on the host as its 2-byte bit patterns (a ``uint16``
array: numpy has no bfloat16) and travels as the dtype string ``<V2``, the
string the JAX package writes for ``ml_dtypes.bfloat16``; ``<V2`` and ``|V2``
read back as those bits. The checksum runs over the buffer, so it is the same
either way.
"""

from __future__ import annotations

import hashlib
import logging
import os
import struct
import threading
import zlib
from collections import OrderedDict
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import faults
from ..analysis.locks import make_lock

log = logging.getLogger("aios.torch.paged")

SACRIFICIAL_PAGE = 0

# How the serving router scores prefix rows that only the host tier holds: a
# restore saves the prefill forward but still pays the pages, the copy and
# the scatter, so it counts for less than rows already in the pool.
HOST_OVERLAP_DISCOUNT = 0.5


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
    blocks, with a reference count per page."""

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
        # leading blocks of each slot already returned by trim_below_window;
        # their table entries are stale but never read until the slot frees
        self._trimmed = np.zeros(num_slots, dtype=np.int64)
        # blocks [lo, hi) of each slot released by prune_range (window+sink
        # compression; hi = 0: none): their entries map the sacrificial page
        self._pruned_lo = np.zeros(num_slots, dtype=np.int64)
        self._pruned_hi = np.zeros(num_slots, dtype=np.int64)
        # owners of each page (slot tables and the prefix index); 0 = free
        self._rc = np.zeros(num_pages, dtype=np.int64)
        # called with the shortfall when the free list runs dry; returns how
        # many pages it reclaimed (the prefix index plugs in here)
        self.reclaimer: Optional[Callable[[int], int]] = None

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

    def _take(self, grow: int) -> None:
        act = faults.point("allocator.pressure")
        if act is not None:
            # chaos: synthetic pool pressure, through the real PoolExhausted
            # recovery (a victim's eviction at a decode grow or an admission)
            raise PoolExhausted(grow, len(self._free))
        if grow > len(self._free) and self.reclaimer is not None:
            self.reclaimer(grow - len(self._free))
        if grow > len(self._free):
            raise PoolExhausted(grow, len(self._free))

    def ensure(self, slot: int, rows: int) -> bool:
        """Back ``slot`` for ``rows`` logical rows, allocating any missing
        pages (refcount 1). Returns True iff the table changed. Raises
        PoolExhausted, leaving existing pages intact, when the free list
        cannot cover the growth even after the reclaimer dropped cold
        prefix pages."""
        need = min(self.blocks_for(rows), self.max_blocks)
        have = int(self._blocks_used[slot])
        if need <= have:
            return False
        self._take(need - have)
        for b in range(have, need):
            page = self._free.pop()
            self._rc[page] = 1
            self.tables[slot, b] = page
        self._blocks_used[slot] = need
        return True

    def map_shared(self, slot: int, pages: Sequence[int]) -> None:
        """Map already-resident pages (a matched prefix) as ``slot``'s
        leading blocks, taking a reference on each. The slot must be empty
        (a fresh admission)."""
        assert int(self._blocks_used[slot]) == 0, "slot must be empty"
        for b, page in enumerate(pages):
            self._rc[page] += 1
            self.tables[slot, b] = page
        self._blocks_used[slot] = len(pages)

    def alloc_pages(self, n: int) -> List[int]:
        """Pop ``n`` fresh pages (refcount 1 each) without mapping them to a
        slot (``append_owned`` maps them). Raises PoolExhausted, after
        asking the reclaimer, with nothing allocated."""
        self._take(n)
        out: List[int] = []
        for _ in range(n):
            page = self._free.pop()
            self._rc[page] = 1
            out.append(page)
        return out

    def append_owned(self, slot: int, pages: Sequence[int]) -> None:
        """Map pages ``alloc_pages`` returned as ``slot``'s next logical
        blocks; their references are already taken."""
        start = int(self._blocks_used[slot])
        for b, page in enumerate(pages, start=start):
            self.tables[slot, b] = page
        self._blocks_used[slot] = start + len(pages)

    def refcount(self, page: int) -> int:
        """A page's reference count (0 = on the free list)."""
        return int(self._rc[page])

    def refcounts(self, pages) -> np.ndarray:
        """``refcount`` of an array of page ids."""
        return self._rc[np.asarray(pages, dtype=np.int64)]

    def incref(self, page: int) -> None:
        self._rc[page] += 1

    def decref(self, page: int) -> None:
        self._rc[page] -= 1
        if self._rc[page] == 0:
            self._free.append(page)
        assert self._rc[page] >= 0, f"page {page} refcount underflow"

    def free_slot(self, slot: int) -> None:
        """Drop the slot's reference on each of its pages; a page whose
        count reaches 0 returns to the free list (shared prefix pages
        survive under their other owners). Blocks released earlier by
        window trimming or window+sink pruning were already dropped and are
        skipped."""
        used = int(self._blocks_used[slot])
        plo, phi = int(self._pruned_lo[slot]), int(self._pruned_hi[slot])
        for b in range(int(self._trimmed[slot]), used):
            if not plo <= b < phi:
                self.decref(int(self.tables[slot, b]))
        self.tables[slot, :used] = SACRIFICIAL_PAGE
        self._blocks_used[slot] = 0
        self._trimmed[slot] = 0
        self._pruned_lo[slot] = 0
        self._pruned_hi[slot] = 0

    def trim_below_window(self, slot: int, length: int, window: int) -> int:
        """Drop the slot's references on its leading blocks that
        sliding-window attention can never read again: block b is dead once
        its last row ``(b+1)*P - 1`` falls below ``length - window`` (window
        starts only move forward; every reader starts at
        ``max(length + 1 - window, 0)``). The table entries keep their stale
        page ids; they are never read and ``ensure`` never rewinds. Returns
        the blocks released now."""
        used = int(self._blocks_used[slot])
        dead = min(max(length - window, 0) // self.page_size, used)
        freed = 0
        for b in range(int(self._trimmed[slot]), dead):
            self.decref(int(self.tables[slot, b]))
            freed += 1
        if dead > self._trimmed[slot]:
            self._trimmed[slot] = dead
        return freed

    def trimmed_blocks(self, slot: int) -> int:
        """Leading blocks of ``slot`` released by ``trim_below_window``."""
        return int(self._trimmed[slot])

    def prune_range(self, slot: int, lo: int, hi: int) -> int:
        """Window+sink KV compression (the JAX ``prune_range``): drop the
        slot's references on its logical blocks [lo, hi), the dead middle
        between the sink blocks [0, lo) and the trailing window, and map
        their entries to the sacrificial page, so that a stale read (a
        gathered view, a kernel's staged entry) reads deterministic garbage
        that the pruned mask never exposes, never a page another slot now
        owns. A page shared with the prefix index or another slot survives
        under its other owners. The range only grows forward: a later call
        releases [max(lo, previous hi), hi). Returns the blocks released
        now. The caller (the engine, under its lock) masks these rows from
        the next dispatch on."""
        hi = min(hi, int(self._blocks_used[slot]))
        prev_hi = int(self._pruned_hi[slot])
        start = max(lo, prev_hi)
        if hi <= start:
            return 0
        for b in range(start, hi):
            self.decref(int(self.tables[slot, b]))
            self.tables[slot, b] = SACRIFICIAL_PAGE
        if prev_hi == 0:
            self._pruned_lo[slot] = lo
        self._pruned_hi[slot] = hi
        return hi - start

    def pruned_blocks(self, slot: int) -> int:
        """Blocks of ``slot`` released by ``prune_range`` so far."""
        hi = int(self._pruned_hi[slot])
        return hi - int(self._pruned_lo[slot]) if hi else 0

    def pruned_range(self, slot: int) -> Tuple[int, int]:
        """The blocks [lo, hi) of ``slot`` that ``prune_range`` released
        ((0, 0) when none)."""
        return int(self._pruned_lo[slot]), int(self._pruned_hi[slot])

    def slot_pages_resident(self, slot: int) -> int:
        """Pages the slot references now: mapped blocks less trimmed and
        pruned ones."""
        return max(int(self._blocks_used[slot]) - int(self._trimmed[slot])
                   - self.pruned_blocks(slot), 0)


def chain_hashes(token_ids: Sequence[int], page_size: int,
                 num_blocks: int) -> List[bytes]:
    """sha256 per full prompt block, chained so that block b's hash commits
    to every token of [0, (b+1)*P): matching block b matches the whole
    prefix, which is the condition for its K/V to be the same. The bytes of
    the JAX package's ``chain_hashes`` (int32 token bytes), so that both
    stacks key a prefix alike."""
    hashes: List[bytes] = []
    h = b""
    for b in range(num_blocks):
        block = np.asarray(token_ids[b * page_size: (b + 1) * page_size], np.int32)
        h = hashlib.sha256(h + block.tobytes()).digest()
        hashes.append(h)
    return hashes


# -- the host tier's wire format (KVX1) ------------------------------------------

# One HostPageStore entry as self-describing bytes: the magic, the tensor
# count, then per tensor (in sorted key order) its key, dtype string, shape
# and raw buffer. The crc32 travels beside the payload; a receiver derives it
# again from the unpacked arrays (``HostPageStore._entry_crc``).
_WIRE_MAGIC = b"KVX1"
# ml_dtypes' bfloat16 ``dtype.str``, under which the JAX package writes a bf16
# page; the port holds such a page as uint16 bits
BF16_WIRE_DTYPE = "<V2"


# Threads that checksum (and the engine's restore stages) a chain's pages at
# once: zlib and numpy's copies release the GIL, and a 12-page chain of a 7B
# model is about 100 MB, which one core takes tens of milliseconds over.
HOST_COPY_THREADS = min(8, os.cpu_count() or 1)
# below this many bytes in all, a thread hand-off costs more than it saves
HOST_COPY_MIN_BYTES = 1 << 20
_host_pool: Optional[ThreadPoolExecutor] = None
_host_pool_lock = threading.Lock()


def host_map(fn, items, nbytes: int) -> list:
    """``[fn(x) for x in items]`` over ``nbytes`` bytes in all, on
    ``HOST_COPY_THREADS`` threads when there are several items and at least
    ``HOST_COPY_MIN_BYTES`` (a process-wide pool, made at first use)."""
    global _host_pool
    items = list(items)
    if len(items) < 2 or HOST_COPY_THREADS < 2 or nbytes < HOST_COPY_MIN_BYTES:
        return [fn(x) for x in items]
    with _host_pool_lock:
        if _host_pool is None:
            _host_pool = ThreadPoolExecutor(HOST_COPY_THREADS, thread_name_prefix="host-copy")
    return list(_host_pool.map(fn, items))


def _wire_dtype(a: np.ndarray) -> str:
    if a.dtype == np.uint16 or (a.dtype.kind == "V" and a.dtype.itemsize == 2):
        return BF16_WIRE_DTYPE
    return a.dtype.str


def _host_dtype(s: str) -> np.dtype:
    if s in ("<V2", "|V2"):
        return np.dtype(np.uint16)
    return np.dtype(s)


def pack_entry(entry: Dict[str, np.ndarray]) -> bytes:
    """Serialize one page entry (sorted keys, so the bytes, like the crc, do
    not depend on insertion order): the JAX package's bytes for the same
    arrays, a bf16 page (uint16 bits here) included."""
    parts = [_WIRE_MAGIC, struct.pack("<B", len(entry))]
    for key in sorted(entry):
        a = np.ascontiguousarray(entry[key])
        kb = key.encode("utf-8")
        db = _wire_dtype(a).encode("ascii")
        parts.append(struct.pack("<B", len(kb)))
        parts.append(kb)
        parts.append(struct.pack("<B", len(db)))
        parts.append(db)
        parts.append(struct.pack("<B", a.ndim))
        parts.append(struct.pack(f"<{a.ndim}I", *a.shape))
        parts.append(struct.pack("<Q", a.nbytes))
        parts.append(a.tobytes())
    return b"".join(parts)


def unpack_entry(data: bytes) -> Dict[str, np.ndarray]:
    """Inverse of ``pack_entry``; raises ``ValueError`` on a bad magic, a
    truncated payload, trailing bytes or any other broken framing. The
    arrays are writable copies; a bf16 tensor comes back as uint16 bits."""
    if data[:4] != _WIRE_MAGIC:
        raise ValueError("bad page-entry magic")
    off = 4
    try:
        (n,) = struct.unpack_from("<B", data, off)
        off += 1
        entry: Dict[str, np.ndarray] = {}
        for _ in range(n):
            (klen,) = struct.unpack_from("<B", data, off)
            off += 1
            key = data[off: off + klen].decode("utf-8")
            off += klen
            (dlen,) = struct.unpack_from("<B", data, off)
            off += 1
            dtype = _host_dtype(data[off: off + dlen].decode("ascii"))
            off += dlen
            (ndim,) = struct.unpack_from("<B", data, off)
            off += 1
            shape = struct.unpack_from(f"<{ndim}I", data, off)
            off += 4 * ndim
            (nbytes,) = struct.unpack_from("<Q", data, off)
            off += 8
            if off + nbytes > len(data):
                raise ValueError("page-entry payload truncated")
            a = np.frombuffer(data[off: off + nbytes], dtype=dtype).reshape(shape).copy()
            off += nbytes
            entry[key] = a
    except struct.error as exc:
        raise ValueError(f"bad page-entry framing: {exc}") from exc
    if off != len(data):
        raise ValueError("trailing bytes after page-entry payload")
    return entry


class HostPageStore:
    """The host-RAM tier behind the prefix index: chain hash -> the page's
    K/V as numpy arrays ({"k", "v"} and, over an int8 pool, {"k_s", "v_s"};
    [L, P, KH, D] and [L, P, KH]), least recently used first out past
    ``max_bytes``.

    The engine's spill worker inserts evicted pages (``put``); an admission
    whose chain misses the pool probes here (``match_chain``) and restores
    what it finds; the router peeks without touching anything
    (``peek_chain``). Every entry carries a crc32 taken at insert and checked
    at each probe and export: a mismatch drops the entry, counts a
    corruption and truncates the chain there, so the caller recomputes
    rather than scatter bad bytes into the pool. The store has its own lock
    (the worker writes from its thread, the engine probes under its own
    lock, the router under neither); checksums run outside it."""

    def __init__(self, max_bytes: int) -> None:
        self.max_bytes = int(max_bytes)
        #: guarded_by _lock
        self._entries: "OrderedDict[bytes, Dict[str, np.ndarray]]" = OrderedDict()
        #: guarded_by _lock
        self._crcs: Dict[bytes, int] = {}
        self.bytes_resident = 0  #: guarded_by _lock
        self.spills = 0  # entries accepted from evictions
        self.restores = 0  # entries promoted back into pool pages
        self.hits = 0  # probes that found at least one entry
        self.misses = 0
        self.corruptions = 0  # entries dropped on a crc32 mismatch
        self._lock = make_lock("host_store")

    @staticmethod
    def _entry_bytes(entry: Dict[str, np.ndarray]) -> int:
        return sum(int(a.nbytes) for a in entry.values())

    @staticmethod
    def _entry_crc(entry: Dict[str, np.ndarray]) -> int:
        """crc32 over the arrays' buffers in sorted key order (no copy)."""
        crc = 0
        for key in sorted(entry):
            crc = zlib.crc32(np.ascontiguousarray(entry[key]), crc)
        return crc

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    def put(self, h: bytes, entry: Dict[str, np.ndarray]) -> None:
        """Insert a page as the newest entry; the least recently used go past
        the byte budget, and an entry larger than the whole budget is
        dropped. The crc is taken outside the lock."""
        nb = self._entry_bytes(entry)
        if nb > self.max_bytes:
            return
        crc = self._entry_crc(entry)
        with self._lock:
            old = self._entries.pop(h, None)
            if old is not None:
                self.bytes_resident -= self._entry_bytes(old)
            self._entries[h] = entry
            self._crcs[h] = crc
            self.bytes_resident += nb
            self.spills += 1
            while self.bytes_resident > self.max_bytes and self._entries:
                dropped_h, dropped = self._entries.popitem(last=False)
                self._crcs.pop(dropped_h, None)
                self.bytes_resident -= self._entry_bytes(dropped)

    def _verified(self, candidates, hashes: Sequence[bytes], where: str):
        """The leading ``candidates`` ((hash, entry, crc)) whose crc holds;
        the first that fails is dropped (if it is still the stored entry)
        and counted, and the chain ends there. The checksums run on the
        host-copy threads (``host_map``)."""
        out, bad = [], None
        entries = [e for _, e, _ in candidates]
        crcs = host_map(self._entry_crc, entries, sum(map(self._entry_bytes, entries)))
        for (h, e, crc), got in zip(candidates, crcs):
            if crc != got:
                bad = (h, e)
                break
            out.append((h, e, crc))
        if bad is not None:
            with self._lock:
                if self._entries.get(bad[0]) is bad[1]:
                    self._entries.pop(bad[0], None)
                    self._crcs.pop(bad[0], None)
                    self.bytes_resident -= self._entry_bytes(bad[1])
                    self.corruptions += 1
            log.error("host-tier page failed crc32 %s; dropped (chain truncated at %d of %d)",
                      where, len(out), len(hashes))
        return out

    def match_chain(self, hashes: Sequence[bytes]
                    ) -> List[Tuple[bytes, Dict[str, np.ndarray]]]:
        """The longest stored prefix of ``hashes`` (LRU refreshed, one hit or
        miss counted), each entry's crc verified. Entries stay until the
        caller confirms the restore with ``discard``: a failed restore must
        not lose them."""
        candidates = []
        with self._lock:
            for h in hashes:
                e = self._entries.get(h)
                if e is None:
                    break
                self._entries.move_to_end(h)
                candidates.append((h, e, self._crcs.get(h)))
        if candidates and faults.point("host_store.corrupt") is not None:
            # chaos: flip the first byte of the chain's first array, only on
            # a probe that matched, so that the recovery path really runs
            a = next(iter(candidates[0][1].values()))
            a.reshape(-1).view(np.uint8)[0] ^= 0xFF
        out = [(h, e) for h, e, _ in self._verified(candidates, hashes, "at restore probe")]
        with self._lock:
            if out:
                self.hits += 1
            else:
                self.misses += 1
        return out

    def note_failed_restore(self) -> None:
        """A probe hit but the restore failed: count a miss too, since the
        request paid a full recompute."""
        with self._lock:
            self.misses += 1

    def peek_chain(self, hashes: Sequence[bytes]) -> int:
        """Length of the longest stored prefix of ``hashes``, touching
        neither the LRU order nor the counters (the router's probe)."""
        n = 0
        with self._lock:
            for h in hashes:
                if h not in self._entries:
                    break
                n += 1
        return n

    def export_chain(self, hashes: Sequence[bytes], budget_bytes: int = 0
                     ) -> List[Tuple[bytes, int, Dict[str, np.ndarray]]]:
        """The longest stored prefix of ``hashes`` as (hash, crc32, entry)
        for another host, without LRU refresh or hit and miss counts; with
        ``budget_bytes`` > 0 the chain stops before the entry that would
        pass it (one entry at least). Each crc is checked before it ships."""
        candidates = []
        total = 0
        with self._lock:
            for h in hashes:
                e = self._entries.get(h)
                if e is None:
                    break
                total += self._entry_bytes(e)
                if budget_bytes and total > budget_bytes and candidates:
                    break
                candidates.append((h, e, self._crcs.get(h)))
        return [(h, crc, e) for h, e, crc in self._verified(candidates, hashes, "at export")]

    def stored_hashes(self, limit: int) -> List[bytes]:
        """Up to ``limit`` most recently used hashes (the tier's part of the
        prefix digest); read-only."""
        with self._lock:
            keys = list(self._entries.keys())
        return keys[-limit:] if limit else []

    def discard(self, hashes: Sequence[bytes], *, restored: bool = False) -> None:
        """Drop entries (a restore's promotion, or invalidation); with
        ``restored`` each dropped entry counts a restore."""
        with self._lock:
            for h in hashes:
                e = self._entries.pop(h, None)
                self._crcs.pop(h, None)
                if e is not None:
                    self.bytes_resident -= self._entry_bytes(e)
                    if restored:
                        self.restores += 1

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()
            self._crcs.clear()
            self.bytes_resident = 0


class _PrefixIndexBase:
    """What both prefix indexes share: the allocator hook-up (the index is
    the allocator's ``reclaimer``), hit and miss counters, the host tier's
    ``spill`` hook and a lock of the index's own. The flat hash-chain map
    (``PrefixIndex``) and the radix tree (``RadixPrefixIndex``, the
    default) keep one page reference per cached block."""

    def __init__(self, allocator: PageAllocator, max_pages: int) -> None:
        self.alloc = allocator
        self.max_pages = max_pages
        self.hits = 0
        self.misses = 0
        # called with the evicted (hash, page) pairs before their references
        # drop (the engine sets it when a HostPageStore is configured: it
        # enqueues the copy of the pages' contents there); None frees them
        self.spill: Optional[Callable[[List[Tuple[bytes, int]]], None]] = None
        self._lock = make_lock("prefix_index")
        allocator.reclaimer = self.reclaim

    def reclaim(self, n: int) -> int:  # pragma: no cover - abstract
        raise NotImplementedError

    def _drop(self, evicted: List[Tuple[bytes, int]]) -> None:
        """Spill evicted entries (hook set), then release their page
        references, outside the index lock (the callers hold the engine
        lock, which guards the allocator). The references drop only after
        the spill has captured the contents, so a freed page cannot be
        handed out and rewritten before the copy; a spill that fails becomes
        a plain eviction."""
        if not evicted:
            return
        try:
            if self.spill is not None:
                try:
                    self.spill(evicted)
                except Exception:  # noqa: BLE001 - degrade to a plain eviction
                    log.exception("host-tier spill failed; dropping %d page(s)", len(evicted))
        finally:
            # the entries are out of the index already: skipping the decref
            # on a BaseException would leak their pages for good
            for _, page in evicted:
                self.alloc.decref(page)


class PrefixIndex(_PrefixIndexBase):
    """Content-addressed cache of prompt-prefix pages (chain hash -> page),
    LRU. Matching a prompt's leading full blocks against it turns their
    prefill into a table update. Shared pages are read-only by
    construction: a match is capped at the prompt's last full block minus
    one row, so every write of the slot (the tail, decode) lands past the
    shared rows."""

    def __init__(self, allocator: PageAllocator, max_pages: int) -> None:
        super().__init__(allocator, max_pages)
        self._index: "OrderedDict[bytes, int]" = OrderedDict()  # hash -> page

    def snapshot(self) -> Dict[bytes, int]:
        """hash -> page of every cached block."""
        with self._lock:
            return dict(self._index)

    def digest(self, limit: int) -> List[Tuple[bytes, int]]:
        """Up to ``limit`` most recently used (chain hash, depth in blocks)
        pairs for the fleet's prefix digest; the flat map keeps no depth and
        says 0. Read-only."""
        with self._lock:
            keys = list(self._index.keys())
        return [(h, 0) for h in keys[-limit:]] if limit else []

    def match(self, hashes: Sequence[bytes]) -> List[int]:
        """The pages of the longest indexed prefix of ``hashes`` (LRU
        refreshed). No reference is taken: the caller maps the pages with
        ``PageAllocator.map_shared``."""
        pages: List[int] = []
        with self._lock:
            for h in hashes:
                page = self._index.get(h)
                if page is None:
                    break
                self._index.move_to_end(h)
                pages.append(page)
            if pages:
                self.hits += 1
            else:
                self.misses += 1
        return pages

    def peek(self, hashes: Sequence[bytes]) -> int:
        """Length of the longest indexed prefix of ``hashes``, touching
        neither the counters nor the LRU order."""
        n = 0
        with self._lock:
            for h in hashes:
                if h not in self._index:
                    break
                n += 1
        return n

    def put(self, hashes: Sequence[bytes], pages: Sequence[int]) -> None:
        """Register computed prefix blocks, one page reference each; LRU
        entries past ``max_pages`` are evicted."""
        evicted: List[Tuple[bytes, int]] = []
        with self._lock:
            for h, page in zip(hashes, pages):
                if h in self._index:
                    self._index.move_to_end(h)
                    continue
                self.alloc.incref(page)
                self._index[h] = page
            while len(self._index) > self.max_pages:
                evicted.append(self._index.popitem(last=False))
        self._drop(evicted)

    def clear(self) -> None:
        """Drop every entry and its page reference."""
        with self._lock:
            while self._index:
                _, page = self._index.popitem(last=False)
                self.alloc.decref(page)

    def reclaimable(self) -> int:
        """Entries ``reclaim`` could free now: pages held by the index
        alone (refcount 1)."""
        with self._lock:
            if not self._index:
                return 0
            pages = np.fromiter(self._index.values(), dtype=np.int64,
                                count=len(self._index))
            return int(np.count_nonzero(self.alloc.refcounts(pages) == 1))

    def reclaim(self, n: int) -> int:
        """Drop up to ``n`` of the coldest entries whose pages only the
        index holds; entries a live slot shares stay."""
        evicted: List[Tuple[bytes, int]] = []
        with self._lock:
            for h in list(self._index):
                if len(evicted) >= n:
                    break
                page = self._index[h]
                if self.alloc.refcount(page) == 1:
                    del self._index[h]
                    evicted.append((h, page))
        self._drop(evicted)
        return len(evicted)


class _RadixNode:
    """A path-compressed run of consecutive prefix blocks (``entries``:
    (chain hash, page) pairs) and its children, keyed by the first hash of
    each child's run; ``stamp`` is the LRU clock at its last traversal."""

    __slots__ = ("entries", "children", "parent", "stamp")

    def __init__(self, parent: Optional["_RadixNode"]) -> None:
        self.entries: List[Tuple[bytes, int]] = []
        self.children: Dict[bytes, "_RadixNode"] = {}
        self.parent = parent
        self.stamp = 0


class RadixPrefixIndex(_PrefixIndexBase):
    """Refcounted radix tree over prompt-prefix blocks, the default index:
    a prompt's chain hashes are its path, two prompts that share K leading
    blocks share one K-entry path, and eviction pops the deepest blocks of
    the least recently used leaves first, so a cached chain's prefix is
    always cached too. ``put`` accepts a chain whose leading blocks are
    cached already and grafts only the new suffix."""

    def __init__(self, allocator: PageAllocator, max_pages: int) -> None:
        super().__init__(allocator, max_pages)
        self._root = _RadixNode(None)
        self._size = 0  # entries, == pages the tree references
        self._clock = 0

    # -- internal helpers (caller holds self._lock) ---------------------------

    def _split(self, node: _RadixNode, j: int) -> None:
        """``entries[:j]`` stay on ``node``; the suffix moves to a new child
        that takes node's children and its pre-touch stamp."""
        suffix = node.entries[j:]
        child = _RadixNode(node)
        child.entries = suffix
        child.children = node.children
        child.stamp = node.stamp
        for c in child.children.values():
            c.parent = child
        node.entries = node.entries[:j]
        node.children = {suffix[0][0]: child}

    def _leaves(self):
        stack = [self._root]
        while stack:
            n = stack.pop()
            if n.children:
                stack.extend(n.children.values())
            elif n is not self._root:
                yield n

    def _detach(self, node: _RadixNode) -> None:
        parent = node.parent
        if parent is None:
            return
        for key, child in list(parent.children.items()):
            if child is node:
                del parent.children[key]
                break

    def _evict_overflow(self, evicted: List[Tuple[bytes, int]]) -> None:
        """Pop the deepest blocks of the least recently used leaves until
        the size fits ``max_pages``; one leaf scan per victim leaf."""
        while self._size > self.max_pages:
            best = None
            for leaf in self._leaves():
                if leaf.entries and (best is None or leaf.stamp < best.stamp):
                    best = leaf
            if best is None:
                return
            while best.entries and self._size > self.max_pages:
                evicted.append(best.entries.pop())
                self._size -= 1
            if not best.entries:
                self._detach(best)

    # -- the index contract ---------------------------------------------------

    def match(self, hashes: Sequence[bytes]) -> List[int]:
        """The pages of the longest cached prefix of ``hashes`` (stamps
        refreshed). A match that ends inside a node splits it, so that only
        the matched run's recency refreshes. No reference is taken."""
        pages: List[int] = []
        with self._lock:
            self._clock += 1
            node, i = self._root, 0
            while i < len(hashes):
                child = node.children.get(hashes[i])
                if child is None:
                    break
                j = 0
                while (j < len(child.entries) and i < len(hashes)
                       and child.entries[j][0] == hashes[i]):
                    pages.append(child.entries[j][1])
                    i += 1
                    j += 1
                if j < len(child.entries):
                    self._split(child, j)
                    child.stamp = self._clock
                    break
                child.stamp = self._clock
                node = child
            if pages:
                self.hits += 1
            else:
                self.misses += 1
        return pages

    def peek(self, hashes: Sequence[bytes]) -> int:
        """Length of the longest cached prefix, touching neither the
        counters, the stamps nor the structure; a match that ends inside a
        node counts the blocks it shares."""
        n = 0
        with self._lock:
            node, i = self._root, 0
            while i < len(hashes):
                child = node.children.get(hashes[i])
                if child is None:
                    break
                j = 0
                while (j < len(child.entries) and i < len(hashes)
                       and child.entries[j][0] == hashes[i]):
                    n += 1
                    i += 1
                    j += 1
                if j < len(child.entries):
                    break
                node = child
        return n

    def put(self, hashes: Sequence[bytes], pages: Sequence[int]) -> None:
        """Register computed prefix blocks, one page reference per new
        entry; blocks already cached are traversed (recency refreshed).
        Entries past ``max_pages`` evict leaf-LRU."""
        hashes = list(hashes)
        pages = list(pages)
        evicted: List[Tuple[bytes, int]] = []
        with self._lock:
            self._clock += 1
            node, i = self._root, 0
            while i < len(hashes):
                child = node.children.get(hashes[i])
                if child is None:
                    break
                j = 0
                while (j < len(child.entries) and i < len(hashes)
                       and child.entries[j][0] == hashes[i]):
                    i += 1
                    j += 1
                if j < len(child.entries):
                    # split before stamping: the unshared suffix keeps the
                    # node's old stamp and ages on its own
                    self._split(child, j)
                    node = child
                    child.stamp = self._clock
                    break
                child.stamp = self._clock
                node = child
            if i < len(hashes) and i < len(pages):
                new = _RadixNode(node)
                new.stamp = self._clock
                for h, page in zip(hashes[i:], pages[i:]):
                    self.alloc.incref(page)
                    new.entries.append((h, page))
                node.children[hashes[i]] = new
                self._size += len(new.entries)
            self._evict_overflow(evicted)
        self._drop(evicted)

    def clear(self) -> None:
        """Drop every entry and its page reference."""
        with self._lock:
            stack = [self._root]
            while stack:
                n = stack.pop()
                for _, page in n.entries:
                    self.alloc.decref(page)
                stack.extend(n.children.values())
            self._root = _RadixNode(None)
            self._size = 0

    def reclaimable(self) -> int:
        """Entries ``reclaim`` could free now: an entry whose page only the
        tree holds and everything below which is reclaimable too (removal
        takes suffixes of the tree only)."""
        with self._lock:
            total = 0
            fully: Dict[int, bool] = {}
            stack: List[Tuple[_RadixNode, bool]] = [(self._root, False)]
            while stack:
                node, seen = stack.pop()
                if not seen:
                    stack.append((node, True))
                    for c in node.children.values():
                        stack.append((c, False))
                    continue
                f = all(fully.pop(id(c)) for c in node.children.values())
                if f:
                    run = 0
                    for _, page in reversed(node.entries):
                        if self.alloc.refcount(page) == 1:
                            run += 1
                        else:
                            break
                    total += run
                    f = run == len(node.entries)
                fully[id(node)] = f
            return total

    def reclaim(self, n: int) -> int:
        """Drop up to ``n`` cold entries whose pages only the tree holds,
        bottom-up and least recently used first: tail entries of the
        coldest leaves pop until a page a live slot shares stops that
        chain; a leaf that empties detaches and exposes its parent's
        tail."""
        evicted: List[Tuple[bytes, int]] = []
        with self._lock:
            while len(evicted) < n:
                cands = [leaf for leaf in self._leaves()
                         if leaf.entries
                         and self.alloc.refcount(leaf.entries[-1][1]) == 1]
                if not cands:
                    break
                leaf = min(cands, key=lambda x: x.stamp)
                while (leaf.entries and len(evicted) < n
                       and self.alloc.refcount(leaf.entries[-1][1]) == 1):
                    evicted.append(leaf.entries.pop())
                    self._size -= 1
                if not leaf.entries:
                    self._detach(leaf)
        self._drop(evicted)
        return len(evicted)

    def snapshot(self) -> Dict[bytes, int]:
        """hash -> page of every cached block."""
        with self._lock:
            out: Dict[bytes, int] = {}
            stack = [self._root]
            while stack:
                n = stack.pop()
                out.update(n.entries)
                stack.extend(n.children.values())
            return out

    def digest(self, limit: int) -> List[Tuple[bytes, int]]:
        """Up to ``limit`` (chain hash, depth in blocks) pairs for the
        fleet's prefix digest, breadth first, so that where the cap bites
        the shallow blocks stay (a shorter remote prompt still finds its
        prefix). Read-only."""
        if not limit:
            return []
        out: List[Tuple[bytes, int]] = []
        with self._lock:
            queue: List[Tuple[_RadixNode, int]] = [(self._root, 0)]
            while queue and len(out) < limit:
                node, d = queue.pop(0)
                for h, _ in node.entries:
                    d += 1
                    out.append((h, d))
                    if len(out) >= limit:
                        break
                for child in node.children.values():
                    queue.append((child, d))
        return out
