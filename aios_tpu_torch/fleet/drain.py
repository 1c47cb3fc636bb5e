"""Graceful drain: hand the host's work to the fleet, then leave.

A kill -9 is already survivable — the handoff's resume ladder re-hands every
stream a dead decode host was holding, and the membership plane marks
the corpse ``dead`` after a timeout. But survivable is not graceful:
the sources eat a full suspect/dead detection window, in-flight KV
pushes hit a black hole, and the host's hot radix chains die with it.
This module is the cooperative exit: ``POST /fleet/drain`` (or
``fleetctl drain``) walks the host through the closed
:data:`DRAIN_PHASES` ladder —

    serving    normal operation (the implicit phase of every healthy
               host; descriptors omit nothing — peers treat a missing
               phase as "serving")
    draining   admission sheds NEW work with the closed
               ``draining_host`` cause; the Handoff servicer refuses
               new handoffs and aborts LIVE handoff streams UNAVAILABLE
               so each source's resume ladder re-hands prompt+emitted
               to a survivor (tokens already relayed are never lost);
               local pools drain; hot radix chains push through kvx to
               the least-loaded surviving peer
    leaving    terminal: the descriptor announces ``phase=leaving`` so
               peers stop routing to this host *before* it dies, then
               the process exits 0

The protocol runs on a worker thread — the HTTP handler that triggered
it answers 202 immediately. ``request_drain`` is idempotent: a second
POST while draining reports the current phase instead of starting a
second protocol. Routers (``pick_decode``, ``gprefix.best_peer``) skip
any peer whose phase is not "serving", so the announce at phase flip is
the fleet-visible half of the contract.

Knobs (docs/CONFIG.md "Fleet fault domain"):
``AIOS_TPU_FLEET_DRAIN_TIMEOUT_SECS`` bounds the pool-drain wait;
``AIOS_TPU_FLEET_DRAIN_PUSH_BYTES`` bounds the hot-chain push (0
disables it).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from typing import Callable, List, Optional, Tuple

from ..analysis.locks import make_lock

log = logging.getLogger("aios.fleet.drain")

__all__ = [
    "DRAIN_PHASES", "DrainCoordinator", "arm", "disarm", "phase",
    "draining", "request_drain",
]

# THE closed drain-phase enum (pinned by test_obs_lint): descriptor
# "phase" values and the /fleet/drain response vocabulary.
DRAIN_PHASES = ("serving", "draining", "leaving")


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def drain_timeout_secs() -> float:
    """Bound on the in-flight pool-drain wait
    (AIOS_TPU_FLEET_DRAIN_TIMEOUT_SECS); past it the host leaves anyway
    — the sources' resume ladder covers whatever was cut."""
    return max(_env_float("AIOS_TPU_FLEET_DRAIN_TIMEOUT_SECS", 10.0), 0.0)


def drain_push_bytes() -> int:
    """Byte budget for the farewell hot-chain push
    (AIOS_TPU_FLEET_DRAIN_PUSH_BYTES, 0 disables): the leaving host's
    hottest cached pages move to a survivor so the fleet keeps the
    cache warmth this host accumulated."""
    return max(int(_env_float("AIOS_TPU_FLEET_DRAIN_PUSH_BYTES",
                              float(32 << 20))), 0)


class DrainCoordinator:
    """Per-process drain state machine. The lock guards ONLY the phase
    flag and thread handle — the protocol itself (pool drains, kvx
    pushes, announces) runs on the worker thread outside every lock."""

    def __init__(self, manager,
                 exit_fn: Callable[[int], None] = os._exit) -> None:
        self.manager = manager
        self.exit_fn = exit_fn
        self._lock = make_lock("drain")
        #: guarded_by _lock
        self._phase = "serving"
        #: guarded_by _lock
        self._thread: Optional[threading.Thread] = None

    def phase(self) -> str:
        with self._lock:
            return self._phase

    def request_drain(self, timeout_s: Optional[float] = None) -> str:
        """Start (or report) the drain. Idempotent: the first call flips
        serving->draining and spawns the protocol thread; later calls
        just return the current phase."""
        with self._lock:
            if self._phase != "serving":
                return self._phase
            self._phase = "draining"
            t = threading.Thread(
                target=self._run,
                args=(drain_timeout_secs() if timeout_s is None
                      else max(float(timeout_s), 0.0),),
                name="fleet-drain", daemon=True,
            )
            self._thread = t
        self._event("draining")
        t.start()
        return "draining"

    # -- the protocol (worker thread; no locks held across any step) --------

    def _run(self, timeout_s: float) -> None:
        from ..serving import admission

        log.warning("graceful drain started (timeout %.1fs)", timeout_s)
        # 1. close the front door: every pool sheds NEW admissions with
        #    the closed draining_host cause; live handoff streams abort
        #    at the servicer's per-token check (the abort IS the signal
        #    that drives each source's resume ladder)
        admission.set_host_draining(True)
        # 2. wait for local in-flight streams to finish (bounded — past
        #    the timeout the host leaves and failover covers the rest)
        for m in self._ready_models():
            if m.pool is not None:
                left = timeout_s
                t0 = time.monotonic()
                m.pool.drain(max(left, 0.01))
                timeout_s = max(timeout_s - (time.monotonic() - t0), 0.0)
        # 3. farewell push: move the hottest cached chains to the
        #    least-loaded survivor so the warmth survives the host
        try:
            self._push_hot_chains()
        except Exception:  # noqa: BLE001 - the push is best-effort by
            # design; a failed farewell must never block the exit
            log.exception("drain hot-chain push failed; leaving anyway")
        # 4. terminal announce: peers see phase=leaving and stop routing
        #    here before the process dies
        with self._lock:
            self._phase = "leaving"
        self._event("leaving")
        self._announce()
        log.warning("graceful drain complete; exiting 0")
        self.exit_fn(0)

    def _ready_models(self) -> list:
        try:
            return list(self.manager.ready_models())
        except Exception:  # noqa: BLE001 - a torn-down manager mid-exit
            return []

    def _push_hot_chains(self) -> None:
        """Export this host's most-recently-used cached pages (HBM
        chains first, then the host spill tier) and push them to one
        surviving peer, bounded by the drain push-bytes budget."""
        from . import disagg, kvx

        budget = drain_push_bytes()
        if budget <= 0:
            return
        plane = disagg.PLANE
        if plane is None:
            return
        for m in self._ready_models():
            engine = m.engine
            if engine is None:
                continue
            target = plane.pick_decode(m.name)
            if target is None:
                log.warning("%s: no surviving peer for the drain push",
                            m.name)
                continue
            host, addr = target
            pairs, total = self._collect_hot(engine, budget)
            if not pairs:
                log.warning("%s: no hot pages to push on drain", m.name)
                continue
            accepted = kvx.push_chain(addr, m.name, pairs, peer=host)
            # warning on purpose: this is the last operationally
            # significant act of a dying host, and smoke harnesses read
            # it off stderr after the exit
            log.warning(
                "%s: drain push moved %d/%d hot pages (%.1f MB) to %s",
                m.name, accepted, len(pairs), total / 1e6, host,
            )

    @staticmethod
    def _collect_hot(engine, budget_bytes: int
                     ) -> Tuple[List[tuple], int]:
        """(hash, entry) pairs for the engine's hottest pages within the
        byte budget. Per-hash exports (chains of length one): the
        digest's iteration order need not be chain order, and content
        addressing means the receiver reassembles prefixes itself."""
        pairs: List[tuple] = []
        total = 0
        seen = set()
        hbm = []
        if getattr(engine, "prefix_index", None) is not None:
            hbm = [h for h, _ in engine.prefix_index.digest(256)]
        for h in hbm:
            if total >= budget_bytes:
                return pairs, total
            for hh, entry in engine.export_hashes([h], max_pages=1):
                nb = sum(int(a.nbytes) for a in entry.values())
                if pairs and total + nb > budget_bytes:
                    return pairs, total
                pairs.append((hh, entry))
                seen.add(hh)
                total += nb
        store = getattr(engine, "host_store", None)
        if store is not None:
            for h in reversed(store.stored_hashes(256)):  # MRU first
                if h in seen:
                    continue
                if total >= budget_bytes:
                    break
                for hh, _crc, entry in store.export_chain([h]):
                    nb = sum(int(a.nbytes) for a in entry.values())
                    if pairs and total + nb > budget_bytes:
                        return pairs, total
                    pairs.append((hh, entry))
                    total += nb
        return pairs, total

    def _announce(self) -> None:
        from ..obs import fleet

        reg = fleet.FLEET
        if reg is not None:
            try:
                reg.announce_once()
            except Exception:  # noqa: BLE001 - partitioned peers must
                # not block the exit; they will mark us dead on their own
                log.exception("drain farewell announce failed")

    def _event(self, to: str) -> None:
        from ..obs import flightrec

        flightrec.RECORDER.model_event(
            "fleet", "drain", phase=to,
        )
        log.warning("drain phase -> %s", to)


# -- process-wide coordinator ------------------------------------------------

COORD: Optional[DrainCoordinator] = None


def arm(manager, exit_fn: Callable[[int], None] = os._exit
        ) -> DrainCoordinator:
    """Arm the drain coordinator (runtime serve() calls this alongside
    the data plane); ``exit_fn`` is injectable for tests."""
    global COORD
    COORD = DrainCoordinator(manager, exit_fn=exit_fn)
    return COORD


def disarm() -> None:
    """Test isolation."""
    global COORD
    COORD = None


def phase() -> str:
    """The host's drain phase — "serving" whenever the coordinator is
    unarmed (solo host), so descriptors stay honest for free."""
    c = COORD
    return c.phase() if c is not None else "serving"


def draining() -> bool:
    """True once a drain has started (draining or leaving) — the
    Handoff servicer's refuse/abort gate."""
    return phase() != "serving"


def request_drain(timeout_s: Optional[float] = None) -> str:
    """Module-level front door for the HTTP route; returns the phase
    (or "serving" with a log when nothing is armed)."""
    c = COORD
    if c is None:
        log.warning("drain requested but no coordinator is armed")
        return "serving"
    return c.request_drain(timeout_s)
