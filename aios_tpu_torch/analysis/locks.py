"""Runtime lock verification: named, order-checking debug locks.

A copy of ``aios_tpu/analysis/locks.py`` for the port's serving plane.

``make_lock(<registry name>)`` is what the declared serving-plane locks
call instead of ``threading.Lock()``. Normally it returns a plain
``threading.Lock`` — zero overhead, identical semantics. Under
``AIOS_TPU_LOCK_DEBUG=1`` it returns a :class:`DebugLock` that:

  * tracks the per-thread stack of held lock NAMES (roles, not
    instances: two replicas' batcher locks are one role — an AB/BA
    inversion between roles is a deadlock hazard whichever instances
    are involved);
  * records every acquired-while-holding edge the process observes, with
    the stack that first took it, and RAISES :class:`LockOrderError`
    the moment any thread acquires in an order that closes a cycle —
    the error carries BOTH stacks (the current acquisition and the one
    that established the opposite ordering), which is the whole
    diagnosis;
  * runs a held-too-long watchdog (``AIOS_TPU_LOCK_WATCHDOG_SECS``,
    default 120, 0 disables): a lock held past the threshold logs the
    holder's live stack (via ``sys._current_frames``) and lands in
    :func:`watchdog_trips` for tests to assert on.

The test suite's conftest enables the flag, so every test of the serving
plane doubles as dynamic lock-order verification.

Fast-path cost when enabled: a thread-local list append plus, only on
NESTED acquisitions (rare), one global dict check under a small lock —
cheap enough to leave on for an entire pytest run.
"""

from __future__ import annotations

import logging
import os
import sys
import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple

log = logging.getLogger("aios.analysis.locks")

__all__ = [
    "DebugLock", "LockOrderError", "make_lock", "debug_enabled",
    "watchdog_trips", "order_errors", "observed_edges", "reset_debug_state",
]


def debug_enabled() -> bool:
    return os.environ.get("AIOS_TPU_LOCK_DEBUG", "").lower() in (
        "1", "true", "on"
    )


def make_lock(name: str):
    """A lock for the declared registry role ``name``: plain
    ``threading.Lock`` normally, order-checking :class:`DebugLock` under
    ``AIOS_TPU_LOCK_DEBUG=1``. The names are the lock roles of the JAX
    package's registry."""
    if debug_enabled():
        return DebugLock(name)
    return threading.Lock()


class LockOrderError(RuntimeError):
    """Two lock roles were acquired in both orders — a latent deadlock.

    The message carries the acquisition stack that closed the cycle AND
    the stack that first established the opposite edge."""


# -- global debug state ------------------------------------------------------

_tls = threading.local()  # .stack: List[Tuple[name, lock_id]]

_state_lock = threading.Lock()
# (held_name, acquired_name) -> formatted stack that first took the edge
_edges: Dict[Tuple[str, str], str] = {}
# lock_id -> (name, thread_id, t_acquired) for the watchdog
_held_now: Dict[int, Tuple[str, int, float]] = {}
_watchdog_trips: List[dict] = []
_watchdog_thread: Optional[threading.Thread] = None
# every LockOrderError raised, also where a serving thread's handler
# swallowed it: (the two roles, the raising thread's name)
_order_errors: List[dict] = []


def watchdog_trips() -> List[dict]:
    """Held-too-long events observed so far (name, seconds, holder
    thread's stack at trip time)."""
    return list(_watchdog_trips)


def order_errors() -> List[dict]:
    """Lock-order inversions raised so far, on any thread: {held,
    acquiring, thread}."""
    return list(_order_errors)


def observed_edges() -> List[Tuple[str, str]]:
    """The (held, acquired) role pairs observed so far, sorted."""
    with _state_lock:
        return sorted(_edges)


def reset_debug_state() -> None:
    """Forget observed edges/trips — test isolation only."""
    with _state_lock:
        _edges.clear()
        _watchdog_trips.clear()
        _held_now.clear()
        _order_errors.clear()


def _watchdog_secs() -> float:
    raw = os.environ.get("AIOS_TPU_LOCK_WATCHDOG_SECS", "").strip()
    if not raw:
        return 120.0
    try:
        return float(raw)
    except ValueError:
        return 120.0


def _ensure_watchdog() -> None:
    global _watchdog_thread
    if _watchdog_thread is not None and _watchdog_thread.is_alive():
        return
    with _state_lock:
        if _watchdog_thread is not None and _watchdog_thread.is_alive():
            return
        t = threading.Thread(
            target=_watchdog_loop, name="aios-lock-watchdog", daemon=True
        )
        _watchdog_thread = t
        t.start()


def _watchdog_loop() -> None:
    warned: Dict[Tuple[int, float], bool] = {}
    while True:
        limit = _watchdog_secs()
        time.sleep(min(max(limit / 4.0, 0.01), 1.0))
        if limit <= 0:
            continue
        now = time.monotonic()
        for lock_id, (name, tid, t0) in list(_held_now.items()):
            if now - t0 <= limit or warned.get((lock_id, t0)):
                continue
            warned[(lock_id, t0)] = True
            frames = sys._current_frames()
            holder = frames.get(tid)
            stack = (
                "".join(traceback.format_stack(holder))
                if holder is not None else "<holder thread gone>"
            )
            trip = {
                "lock": name,
                "held_secs": round(now - t0, 3),
                "thread_id": tid,
                "stack": stack,
            }
            _watchdog_trips.append(trip)
            log.warning(
                "DebugLock '%s' held for %.1fs (> %.1fs watchdog) by "
                "thread %d; holder stack:\n%s",
                name, now - t0, limit, tid, stack,
            )
        # drop warn marks for released locks so a re-acquire re-arms
        for key in [k for k in warned if k[0] not in _held_now]:
            del warned[key]


class DebugLock:
    """Drop-in ``threading.Lock`` replacement with a role name, global
    acquisition-order cycle detection, and a held-too-long watchdog."""

    __slots__ = ("name", "_lock")

    def __init__(self, name: str) -> None:
        self.name = name
        self._lock = threading.Lock()
        if _watchdog_secs() > 0:
            _ensure_watchdog()

    # -- threading.Lock surface ---------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        self._check_order()
        got = self._lock.acquire(blocking, timeout)
        if got:
            self._note_acquired()
        return got

    def release(self) -> None:
        self._note_released()
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<DebugLock {self.name!r} locked={self.locked()}>"

    # -- ordering ------------------------------------------------------------

    def _check_order(self) -> None:
        held: List[Tuple[str, int]] = getattr(_tls, "stack", None) or []
        if not held:
            return
        held_names = {n for n, _ in held if n != self.name}
        if not held_names:
            return
        me = self.name
        with _state_lock:
            # Would acquiring `me` while holding `h` close a cycle?
            # Follow existing edges OUT of `me`; if any held lock is
            # reachable, the opposite ordering was already observed.
            reachable = {me}
            frontier = [me]
            first_hop: Dict[str, Tuple[str, str]] = {}
            while frontier:
                cur = frontier.pop()
                for (a, b), stk in _edges.items():
                    if a == cur and b not in reachable:
                        reachable.add(b)
                        first_hop[b] = (a, stk)
                        frontier.append(b)
            bad = held_names & (reachable - {me})
            if bad:
                victim = sorted(bad)[0]
                _, opposite_stack = first_hop[victim]
                _order_errors.append({
                    "held": victim, "acquiring": self.name,
                    "thread": threading.current_thread().name,
                })
                current = "".join(traceback.format_stack())
                raise LockOrderError(
                    f"lock-order inversion: thread holds "
                    f"'{victim}' and is acquiring '{self.name}', but the "
                    f"order '{self.name}' -> ... -> '{victim}' was "
                    f"already observed.\n"
                    f"--- current acquisition ---\n{current}"
                    f"--- first stack that established the opposite "
                    f"order ---\n{opposite_stack}"
                )
            new_edges = [
                (h, me) for h in held_names if (h, me) not in _edges
            ]
            if new_edges:
                stk = "".join(traceback.format_stack())
                for e in new_edges:
                    _edges[e] = stk

    def _note_acquired(self) -> None:
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        stack.append((self.name, id(self)))
        _held_now[id(self)] = (
            self.name, threading.get_ident(), time.monotonic()
        )

    def _note_released(self) -> None:
        stack = getattr(_tls, "stack", None)
        if stack:
            for i in range(len(stack) - 1, -1, -1):
                if stack[i][1] == id(self):
                    del stack[i]
                    break
        _held_now.pop(id(self), None)
