"""Fleet incident bundles: freeze *everything* around an anomaly trigger.

The anomaly system grew one trigger at a time — flightrec auto-snapshots
(abort / shed spike / crash-respawn / SLO breach), autoscale actions,
breaker open->quarantine edges, fired faults — and each freezes only its
own evidence. This module closes the loop: every trigger also produces
one **incident bundle** holding the cross-layer context an operator
actually pages through afterwards:

  * the tsdb window +/- ``window_secs`` around the trigger
    (:meth:`Tsdb.window_snapshot` — empty-but-marked when the ring is
    unarmed);
  * the matching flight-recorder snapshot (or a live model-lane slice
    when none fired);
  * the fault-injection journal tail (``faults.fired()``);
  * the devprof ledger state (``devprof.snapshot_all()``);
  * lock-watchdog trips (``analysis.locks.watchdog_trips()``).

Triggers funnel through :func:`notify` — a module-global None check when
the store is unarmed (the faults/devprof pattern), so hot paths pay
nothing. The trigger cause is the CLOSED :data:`TRIGGER_CAUSES` enum
(pinned by test_obs_lint, iterated at metric registration); causes
shared with flightrec.SNAPSHOT_CAUSES keep their names so one grep finds
both artifacts.

The store mirrors the flightrec snapshot discipline: the per-(model,
cause) cooldown stamp and incident id are claimed synchronously under
the lock (a burst of triggers freezes exactly one), then the bundle is
built on a background daemon thread — after waiting out the post-trigger
half of the window so the ring holds the aftermath — and appended to a
bounded deque served at ``GET /debug/incidents``. With
``AIOS_TPU_INCIDENT_DUMP_DIR`` set, each bundle also lands on disk as
JSON.

Arming: ``AIOS_TPU_INCIDENTS=1``, or implicitly with ``AIOS_TPU_TSDB``
(bundles center on tsdb windows); ``AIOS_TPU_INCIDENTS=0`` forces off.

Locking: ``_lock`` (registry role "incidents") guards the bundle deque,
cooldown stamps, and the id counter only. Bundle *construction* — which
reads tsdb, the recorder, faults, devprof, and the watchdog under their
own locks — runs outside it; metric/recorder emission likewise.
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from ..analysis.locks import make_lock

log = logging.getLogger("aios.incidents")

# THE closed trigger-cause enum (pinned by test_obs_lint, AST-iterated
# at metric registration). The first five ride the flightrec snapshot
# path (SNAPSHOT_CAUSES + manual); "autoscale" hooks the controller's
# action journal, "breaker_open" the quarantine board's open edge,
# "fault" the injection layer's fired-fault record. A new trigger is a
# reviewed enum change, never a stray label value.
TRIGGER_CAUSES = ("abort", "autoscale", "breaker_open", "crash_respawn",
                  "fault", "manual", "shed_spike", "slo_breach")

# Bundle store bound: bundles are heavy (a tsdb window + a snapshot);
# 16 spans the recent past without letting /debug/incidents balloon.
MAX_INCIDENTS = 16

# Fault-journal slice folded into each bundle (the journal itself is
# already bounded; the tail is what surrounds the trigger).
_FAULT_TAIL = 64


def _env_float(name: str, default: float, lo: float, hi: float) -> float:
    try:
        v = float(os.environ.get(name, "") or default)
    except ValueError:
        return default
    return min(max(v, lo), hi)


class IncidentConfig:
    """Knobs (docs/CONFIG.md "Incident bundles" rows). Read live from
    the environment at construction."""

    def __init__(self) -> None:
        raw = os.environ.get("AIOS_TPU_INCIDENTS", "").lower()
        if raw in ("0", "false", "off"):
            self.enabled = False
        elif raw in ("1", "true", "on"):
            self.enabled = True
        else:
            # default: ride the tsdb arming — bundles center on its
            # windows, and a process that wants history wants both
            self.enabled = os.environ.get(
                "AIOS_TPU_TSDB", ""
            ).lower() in ("1", "true", "on")
        self.window_secs = _env_float(
            "AIOS_TPU_INCIDENT_WINDOW_SECS", 60.0, 0.0, 600.0
        )
        self.cooldown_secs = _env_float(
            "AIOS_TPU_INCIDENT_COOLDOWN_SECS", 30.0, 0.0, 3600.0
        )
        self.dump_dir = os.environ.get("AIOS_TPU_INCIDENT_DUMP_DIR", "")


class IncidentStore:
    """Bounded bundle store + background builder. ``clock`` is wall
    time (bundle timestamps join tsdb points and dump filenames);
    injectable for tests."""

    def __init__(self, cfg: Optional[IncidentConfig] = None,
                 clock: Callable[[], float] = time.time) -> None:
        self.cfg = cfg or IncidentConfig()
        self.clock = clock
        self._lock = make_lock("incidents")
        self._incidents: deque = deque(maxlen=MAX_INCIDENTS)  #: guarded_by _lock
        self._last_at: Dict[Tuple[str, str], float] = {}  #: guarded_by _lock
        self._seq = 0  #: guarded_by _lock
        self._stop = threading.Event()
        self._register_metrics()

    def _register_metrics(self) -> None:
        """Pre-register every trigger-cause child by iterating the
        closed TRIGGER_CAUSES enum (the autoscale/SLO registration
        pattern, pinned by test_obs_lint) — a healthy process renders 0
        for every cause instead of absence."""
        from . import instruments

        for cause in TRIGGER_CAUSES:
            instruments.INCIDENTS.labels(cause=cause)
            instruments.INCIDENTS_SUPPRESSED.labels(cause=cause)

    # -- the trigger funnel ---------------------------------------------------

    def notify(self, model: str, cause: str, sync: bool = False,
               **fields) -> Optional[dict]:
        """One trigger fired: claim the cooldown stamp + incident id
        synchronously (a burst freezes exactly one), then build the
        bundle on a daemon thread — the freeze never stalls a scheduler
        tick. ``sync=True`` (tests, smoke scripts) builds inline and
        returns the bundle."""
        from . import instruments

        if cause not in TRIGGER_CAUSES:
            cause = "manual"
        t = self.clock()
        with self._lock:
            last = self._last_at.get((model, cause))
            if last is not None and t - last < self.cfg.cooldown_secs:
                suppressed = True
            else:
                suppressed = False
                self._last_at[(model, cause)] = t
                self._seq += 1
                inc_id = self._seq
        if suppressed:
            instruments.INCIDENTS_SUPPRESSED.labels(cause=cause).inc()
            return None
        instruments.INCIDENTS.labels(cause=cause).inc()
        if not sync:
            threading.Thread(
                target=self._build, args=(inc_id, model, cause, t, fields),
                name="incident-build", daemon=True,
            ).start()
            return None
        return self._build(inc_id, model, cause, t, fields, wait=False)

    def _build(self, inc_id: int, model: str, cause: str, t: float,
               fields: dict, wait: bool = True) -> dict:
        """Assemble one bundle. Waits out the post-trigger half of the
        window first (background path only) so the tsdb ring holds the
        aftermath, not just the run-up."""
        if wait and self.cfg.window_secs > 0:
            self._stop.wait(self.cfg.window_secs)
        w = self.cfg.window_secs
        bundle = {
            "id": inc_id,
            "model": model,
            "cause": cause,
            "at": t,
            "fields": {k: v for k, v in sorted(fields.items())},
            "window": {"start": t - w, "end": t + w},
            "tsdb": self._tsdb_window(t - w, t + w),
            "flightrec": self._flightrec_slice(model, cause, t),
            "faults": self._fault_tail(),
            "devprof": self._devprof_state(),
            "lock_trips": self._lock_trips(),
        }
        with self._lock:
            self._incidents.append(bundle)
        from . import flightrec

        flightrec.RECORDER.model_event(
            model, "incident", cause=cause, incident_id=inc_id,
        )
        self._dump(bundle)
        return bundle

    # -- bundle sections (each section is fail-soft: a sick layer
    # becomes its own evidence, never a lost bundle) ---------------------------

    def _tsdb_window(self, start: float, end: float) -> dict:
        from . import tsdb

        ring = tsdb.TSDB
        if ring is None:
            return {"armed": False, "series": [], "truncated": 0}
        try:
            out = ring.window_snapshot(start, end)
            out["armed"] = True
            return out
        except Exception as exc:  # noqa: BLE001
            return {"armed": True, "series": [], "truncated": 0,
                    "error": repr(exc)[:200]}

    def _flightrec_slice(self, model: str, cause: str, t: float) -> dict:
        from . import flightrec

        try:
            for snap in reversed(flightrec.RECORDER.snapshots()):
                if snap.get("model") == model and snap.get("cause") == cause:
                    return {"snapshot_id": snap.get("id"),
                            "snapshot": snap}
            # no snapshot for this (model, cause) — e.g. autoscale /
            # breaker / fault triggers: freeze the live model lane
            return {
                "snapshot_id": None,
                "model_events": [
                    {"t_wall": w, "model": m, "kind": k, **f}
                    for w, m, k, f in flightrec.RECORDER.model_events(model)
                ],
            }
        except Exception as exc:  # noqa: BLE001
            return {"error": repr(exc)[:200]}

    def _fault_tail(self) -> List[dict]:
        from .. import faults

        try:
            return list(faults.fired())[-_FAULT_TAIL:]
        except Exception as exc:  # noqa: BLE001
            return [{"error": repr(exc)[:200]}]

    def _devprof_state(self) -> dict:
        from . import devprof

        try:
            return devprof.snapshot_all()
        except Exception as exc:  # noqa: BLE001
            return {"error": repr(exc)[:200]}

    def _lock_trips(self) -> List[dict]:
        from ..analysis import locks

        try:
            return locks.watchdog_trips()
        except Exception as exc:  # noqa: BLE001
            return [{"error": repr(exc)[:200]}]

    def _dump(self, bundle: dict) -> None:
        dump_dir = self.cfg.dump_dir
        if not dump_dir:
            log.warning(
                "incident bundle frozen (%s/%s, id %d); "
                "GET /debug/incidents to read it",
                bundle["model"], bundle["cause"], bundle["id"],
            )
            return
        try:
            os.makedirs(dump_dir, exist_ok=True)
            path = os.path.join(
                dump_dir,
                f"incident-{bundle['model']}-{bundle['cause']}-"
                f"{bundle['id']}.json",
            )
            with open(path, "w") as f:
                json.dump(bundle, f)
            log.warning("incident bundle (%s/%s) -> %s",
                        bundle["model"], bundle["cause"], path)
        except (OSError, TypeError, ValueError) as exc:
            log.warning("incident dump failed: %s", exc)

    # -- surfaces -------------------------------------------------------------

    def incidents(self) -> List[dict]:
        with self._lock:
            return list(self._incidents)

    def stop(self) -> None:
        self._stop.set()

    def clear(self) -> None:
        """Test isolation."""
        with self._lock:
            self._incidents.clear()
            self._last_at.clear()
            self._seq = 0


# -- process-wide instance ----------------------------------------------------

# The one store the trigger hooks and /debug/incidents read; None until
# maybe_start() arms it — notify() below is a single None check when off.
STORE: Optional[IncidentStore] = None


def enabled() -> bool:
    return STORE is not None


def notify(model: str, cause: str, **fields) -> None:
    """The trigger funnel every hook calls (flightrec.snapshot,
    autoscale._record, breaker._emit, faults._record). One None check
    when unarmed — hot paths pay nothing."""
    store = STORE
    if store is None:
        return
    store.notify(model, cause, **fields)


def maybe_start() -> Optional[IncidentStore]:
    """Arm the store when configured (AIOS_TPU_INCIDENTS, or riding
    AIOS_TPU_TSDB) — called by maybe_start_metrics_server. Idempotent."""
    global STORE
    cfg = IncidentConfig()
    if STORE is not None or not cfg.enabled:
        return STORE
    STORE = IncidentStore(cfg)
    log.info(
        "incident bundles armed: window=+/-%.0fs cooldown=%.0fs dump=%s",
        cfg.window_secs, cfg.cooldown_secs, cfg.dump_dir or "(store only)",
    )
    return STORE


def install(store: Optional[IncidentStore]) -> Optional[IncidentStore]:
    """Swap the process-wide store (tests); returns the previous."""
    global STORE
    prev, STORE = STORE, store
    return prev
