"""Cache-aware replica selection (SGLang-style, arXiv:2312.07104).

A copy of ``aios_tpu/serving/router.py`` (``ROUTE_REASONS`` lives here; the
JAX package keeps it in ``serving/pool.py``). The port has no host spill
tier yet, so a replica's overlap is its device-resident rows only.

aiOS traffic is shared-prefix by construction: every agent rebuilds its
prompt from the same system/task preamble each reasoning round. On a
multi-replica pool the throughput lever is therefore WHERE a request
lands — the replica already holding the prompt's prefix pages serves it
with a page-table update instead of a prefill. Selection order:

  1. **sticky** — a ``task_id`` continuation goes back to the replica
     that served the task before (its whole conversation KV lives there);
  2. **prefix** — score every replica by prefix-cache overlap with the
     prompt ids (a read-only peek at the replica's prefix index — the
     radix tree ``paged.RadixPrefixIndex`` by default, which credits
     PARTIAL-node overlap: a prompt diverging inside another prompt's
     cached run still scores the blocks it shares — no hit/miss
     counters touched, no LRU refresh, no node splits) and take the
     best one when the overlap covers at least ``overlap_min_ratio``
     of the prompt. Rows resident only in a replica's host spill tier
     (``paged.HostPageStore``) count at
     ``paged.HOST_OVERLAP_DISCOUNT``: a restorable prefix is a memcpy,
     not free, so routing still prefers true HBM residency but credits
     the replica that can restore over one that must recompute;
  3. **least_loaded** — otherwise, fewest outstanding tokens (queued
     prompt+budget plus live remaining budget) wins.

The pool overrides a full chosen replica with the least-loaded one that
still has queue room (reason ``spill``) before the admission queue-bound
gate sheds.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional, Sequence, Tuple

from ..analysis.locks import make_lock

_STICKY_CAPACITY = 4096  # task ids are client input; LRU-bound the map

ROUTE_REASONS = ("prefix", "sticky", "least_loaded", "spill", "single")


class Router:
    def __init__(self, overlap_min_ratio: float = 0.25) -> None:
        self.overlap_min_ratio = overlap_min_ratio
        self._sticky: "OrderedDict[str, int]" = OrderedDict()  #: guarded_by _lock
        self._lock = make_lock("router")

    def select(self, replicas: Sequence, prompt_ids: List[int],
               task_id: str = "",
               hashes: Optional[List[bytes]] = None,
               detail: Optional[dict] = None) -> Tuple[int, str]:
        """Pick a replica index for a request. ``replicas`` are
        Replica-shaped objects (``overlap_rows(ids, hashes=None)``,
        ``outstanding_tokens()``); returns (index, reason). ``hashes``
        are the prompt's precomputed block digests (the ``bytes`` sha256
        chain of ``paged.chain_hashes``) — the pool hashes once so N
        replicas don't each redo the sha256 chain. A caller-supplied
        ``detail`` dict receives the decision's evidence (best overlap
        rows — host-discounted rows included, per the replica's probe —
        and the threshold it was held to) for the flight recorder."""
        if len(replicas) == 1:
            return 0, "single"
        sticky = self._sticky_for(task_id, len(replicas))
        if sticky is not None:
            return sticky, "sticky"
        best, best_rows = -1, 0
        for i, r in enumerate(replicas):
            rows = r.overlap_rows(prompt_ids, hashes=hashes)
            if rows > best_rows:
                best, best_rows = i, rows
        threshold = max(1, int(len(prompt_ids) * self.overlap_min_ratio))
        if detail is not None:
            detail["overlap_rows"] = best_rows
            detail["overlap_threshold"] = threshold
        if best >= 0 and best_rows >= threshold:
            return best, "prefix"
        return self.least_loaded(replicas), "least_loaded"

    @staticmethod
    def least_loaded(replicas: Sequence) -> int:
        return min(
            range(len(replicas)),
            key=lambda i: replicas[i].outstanding_tokens(),
        )

    def _sticky_for(self, task_id: str, n: int) -> Optional[int]:
        if not task_id:
            return None
        with self._lock:
            idx = self._sticky.get(task_id)
            if idx is None:
                return None
            self._sticky.move_to_end(task_id)
            # a shrunk pool (failed replica) invalidates the binding
            return idx if idx < n else None

    def note_routed(self, task_id: str, idx: int) -> None:
        """Record where a task landed so its continuations stay put."""
        if not task_id:
            return
        with self._lock:
            self._sticky[task_id] = idx
            self._sticky.move_to_end(task_id)
            while len(self._sticky) > _STICKY_CAPACITY:
                self._sticky.popitem(last=False)
