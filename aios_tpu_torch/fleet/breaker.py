"""Per-peer circuit breakers — the fleet's gray-host quarantine.

The membership plane (obs/fleet.py) answers "is the peer's heartbeat
fresh?". That is the wrong question for a GRAY host: one that
heartbeats fine while every data-plane RPC to it crawls or fails.
Before this module, such a peer stayed "up" forever and every prefill
paid a full kvx timeout re-probing it — the retry-every-prefill
behavior this module retires.

Every cross-host call site (kvx push/fetch, Handoff, federation
scrapes, trace stitches) feeds one :class:`BreakerBoard` — a per-peer
EWMA of latency plus a cause-weighted failure score driving the closed
circuit-breaker state machine (:data:`BREAKER_STATES`, pinned by
test_obs_lint):

    closed     healthy: calls flow, failures accumulate score
    open       quarantined: calls refused locally until the cooldown
               elapses (exponential per-peer backoff, capped)
    half_open  probing: a bounded budget of real calls may pass; N
               consecutive successes close the breaker, one failure
               re-opens it with a doubled cooldown

``quarantined`` is an OVERLAY on up/suspect/dead, deliberately
orthogonal: heartbeats alone can never clear it — announce outcomes do
not feed this board — only successful data-plane probes can. Routers
(`FleetRouter`, ``pick_decode``, ``gprefix.best_peer``) treat a
quarantined peer as absent; the federation loop's scrapes double as the
half-open probes, so an idle fleet still heals.

Failure causes are weighted (``crc_mismatch`` > ``timeout``): a peer
returning *corrupt* payloads is actively poisoning callers and trips
the breaker faster than one that is merely slow.

State edges land on ``aios_tpu_fleet_peer_breaker_state_total{host,
peer}`` (value = BREAKER_STATES index) and the flight recorder's fleet
lane as ``quarantine`` events. Knobs: docs/CONFIG.md "Fleet fault
domain".
"""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

from ..analysis.locks import make_lock

log = logging.getLogger("aios.fleet.breaker")

__all__ = [
    "BREAKER_STATES", "BreakerBoard", "BOARD", "reset",
]

# THE closed breaker enum (pinned by test_obs_lint; the gauge value is
# an index into it, so order is part of the contract).
BREAKER_STATES = ("closed", "open", "half_open")

# cause -> score weight: how hard one failure of that flavor pushes the
# peer toward quarantine. Corruption outweighs slowness — a peer
# shipping bad bytes burns caller work on every touch; an unknown cause
# weighs 1.0.
CAUSE_WEIGHTS: Dict[str, float] = {
    "crc_mismatch": 2.0,
    "timeout": 1.0,
    "unavailable": 1.0,
    "decode_error": 2.0,
}

# EWMA smoothing for the per-peer latency estimate (informational +
# the optional latency floor): ~10-call memory.
_LAT_ALPHA = 0.2

# how much one SUCCESS decays the failure score in the closed state —
# occasional blips on a busy edge never accumulate to a trip
_OK_DECAY = 0.5


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


class BreakerConfig:
    """Knobs (docs/CONFIG.md "Fleet fault domain"), read at construction
    so worker processes and tests configure per process."""

    def __init__(self) -> None:
        # failure score at which a closed breaker opens
        self.threshold = _env_float("AIOS_TPU_FLEET_BREAKER_THRESHOLD", 3.0)
        # first-open cooldown; doubles per consecutive open, capped
        self.cooldown_secs = _env_float(
            "AIOS_TPU_FLEET_BREAKER_COOLDOWN_SECS", 5.0
        )
        self.max_cooldown_secs = _env_float(
            "AIOS_TPU_FLEET_BREAKER_MAX_COOLDOWN_SECS", 60.0
        )
        # consecutive half-open successes required to close; also the
        # probe budget one half-open window may spend
        self.probes = int(_env_float("AIOS_TPU_FLEET_BREAKER_PROBES", 3.0))
        # optional gray-latency floor (seconds): a latency EWMA past it
        # counts like a failure even when calls "succeed"; 0 disables
        self.lat_floor_secs = _env_float(
            "AIOS_TPU_FLEET_BREAKER_LAT_SECS", 0.0
        )


class _Peer:
    """One peer's breaker bookkeeping — all fields guarded by the
    board's lock."""

    __slots__ = ("state", "score", "lat_ewma", "opens", "opened_at",
                 "cooldown", "probes_left", "streak")

    def __init__(self) -> None:
        self.state = "closed"
        self.score = 0.0
        self.lat_ewma = 0.0
        self.opens = 0          # consecutive opens -> cooldown exponent
        self.opened_at = 0.0
        self.cooldown = 0.0
        self.probes_left = 0
        self.streak = 0         # consecutive half-open successes


class BreakerBoard:
    """The per-process board of per-peer breakers. ``clock`` is
    injectable for deterministic state-machine tests."""

    def __init__(self, cfg: Optional[BreakerConfig] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self.cfg = cfg or BreakerConfig()
        self.clock = clock
        self._lock = make_lock("quarantine")
        self._peers: Dict[str, _Peer] = {}  #: guarded_by _lock

    # -- the feeding surface --------------------------------------------------

    def allow(self, peer: str) -> bool:
        """May a cross-host call to ``peer`` proceed? closed -> yes;
        open -> no until the cooldown elapses (then the breaker goes
        half-open and this call consumes one probe slot); half-open ->
        yes while the probe budget lasts."""
        if not peer:
            return True
        edges: List[Tuple[str, str, str, str]] = []
        with self._lock:
            p = self._peers.get(peer)
            if p is None or p.state == "closed":
                return True
            if p.state == "open":
                if self.clock() - p.opened_at < p.cooldown:
                    return False
                self._transition(p, peer, "half_open", "cooldown_elapsed",
                                 edges)
                p.probes_left = max(1, self.cfg.probes)
                p.streak = 0
            if p.probes_left <= 0:
                allowed = False
            else:
                p.probes_left -= 1
                allowed = True
        self._emit(edges)
        return allowed

    def record_ok(self, peer: str, latency_s: float = 0.0) -> None:
        """A cross-host call to ``peer`` succeeded (data plane or
        probe). NEVER called for heartbeat announces — heartbeats must
        not clear quarantine."""
        if not peer:
            return
        edges: List[Tuple[str, str, str, str]] = []
        with self._lock:
            p = self._ensure(peer)
            p.lat_ewma = (
                latency_s if p.lat_ewma == 0.0
                else (1 - _LAT_ALPHA) * p.lat_ewma + _LAT_ALPHA * latency_s
            )
            floor = self.cfg.lat_floor_secs
            if floor > 0 and p.lat_ewma > floor:
                # "success" past the gray floor IS the gray-host case
                self._score_failure(p, peer, "gray_latency", 1.0, edges)
            elif p.state == "half_open":
                p.streak += 1
                if p.streak >= max(1, self.cfg.probes):
                    self._transition(p, peer, "closed", "probes_ok", edges)
                    p.score = 0.0
                    p.opens = 0
            else:
                p.score *= _OK_DECAY
        self._emit(edges)

    def record_failure(self, peer: str, cause: str = "unavailable") -> None:
        """A cross-host call to ``peer`` failed; ``cause`` picks the
        score weight (kvx.KVX_FAIL_CAUSES vocabulary plus
        "gray_latency")."""
        if not peer:
            return
        edges: List[Tuple[str, str, str, str]] = []
        with self._lock:
            p = self._ensure(peer)
            self._score_failure(
                p, peer, cause, CAUSE_WEIGHTS.get(cause, 1.0), edges
            )
        self._emit(edges)

    # -- the routing surface --------------------------------------------------

    def quarantined(self, peer: str) -> bool:
        """True while the peer's breaker is anything but closed —
        routers treat such a peer as absent."""
        with self._lock:
            p = self._peers.get(peer)
            return p is not None and p.state != "closed"

    def state(self, peer: str) -> str:
        with self._lock:
            p = self._peers.get(peer)
            return p.state if p is not None else "closed"

    def snapshot(self) -> Dict[str, dict]:
        """Per-peer debug view (tests, /fleet/members overlays)."""
        with self._lock:
            return {
                peer: {
                    "state": p.state,
                    "score": round(p.score, 3),
                    "lat_ewma": round(p.lat_ewma, 6),
                    "opens": p.opens,
                    "cooldown": p.cooldown,
                    "probes_left": p.probes_left,
                }
                for peer, p in sorted(self._peers.items())
            }

    # -- internals ------------------------------------------------------------

    def _ensure(self, peer: str) -> _Peer:
        # caller holds _lock
        p = self._peers.get(peer)
        if p is None:
            # aios: waive(guarded-by): private helper invoked only from record_ok/record_failure with _lock already held — the with-block lives in the caller
            p = self._peers[peer] = _Peer()
        return p

    def _score_failure(self, p: _Peer, peer: str, cause: str,
                       weight: float, edges: List[Tuple[str, str, str, str]]
                       ) -> None:
        # caller holds _lock
        p.score += weight
        if p.state == "half_open":
            # one failed probe re-opens with a doubled cooldown
            self._open(p, peer, cause, edges)
        elif p.state == "closed" and p.score >= self.cfg.threshold:
            self._open(p, peer, cause, edges)

    def _open(self, p: _Peer, peer: str, cause: str,
              edges: List[Tuple[str, str, str, str]]) -> None:
        # caller holds _lock
        p.opens += 1
        p.opened_at = self.clock()
        p.cooldown = min(
            self.cfg.cooldown_secs * (2.0 ** (p.opens - 1)),
            self.cfg.max_cooldown_secs,
        )
        p.probes_left = 0
        p.streak = 0
        self._transition(p, peer, "open", cause, edges)

    def _transition(self, p: _Peer, peer: str, to: str, why: str,
                    edges: List[Tuple[str, str, str, str]]) -> None:
        # caller holds _lock; emission happens in _emit after release
        frm, p.state = p.state, to
        edges.append((peer, frm, to, why))

    def _emit(self, edges: List[Tuple[str, str, str, str]]) -> None:
        """Metric + recorder evidence for breaker edges — outside the
        quarantine lock (no quarantine->recorder/metrics edge)."""
        if not edges:
            return
        from ..faults import net
        from ..obs import flightrec, incidents, instruments

        host = net.self_host()
        for peer, frm, to, why in edges:
            # gauge value = index into the closed BREAKER_STATES enum —
            # registration and rendering iterate the same tuple
            instruments.FLEET_PEER_BREAKER.labels(
                host=host, peer=peer
            ).set(float(BREAKER_STATES.index(to)))
            flightrec.RECORDER.model_event(
                "fleet", "quarantine", peer=peer, frm=frm, to=to,
                cause=why,
            )
            if to == "open":
                # a quarantined peer is exactly the moment to freeze
                # the surrounding telemetry window (no-op when unarmed)
                incidents.notify("fleet", "breaker_open",
                                 peer=peer, why=why)
            log.warning("fleet peer breaker %s: %s -> %s (%s)",
                        peer, frm, to, why or "?")


# -- process-wide board ------------------------------------------------------

BOARD = BreakerBoard()


def reset(cfg: Optional[BreakerConfig] = None,
          clock: Callable[[], float] = time.monotonic) -> BreakerBoard:
    """Swap in a fresh board (tests / env re-reads); returns it."""
    global BOARD
    BOARD = BreakerBoard(cfg=cfg, clock=clock)
    return BOARD
