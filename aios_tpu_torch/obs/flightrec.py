"""Serving-plane flight recorder: one structured timeline per request.

A copy of ``aios_tpu/obs/flightrec.py`` without its tracing half: the
closed enums (event kinds, shed causes, abort causes and the retryable
ones), ``abort_cause``, ``Timeline``, ``FlightRecorder`` (bounded
per-model rings of finished timelines, the model lane, anomaly snapshots)
and the process-wide ``RECORDER``. Span folding (``export_span``,
``install_span_export``) waits for the port's tracing, the Chrome-trace
export for its HTTP debug routes, and incident bundles for
``obs/incidents.py``; the service opens timelines with an empty trace id.

Every request through the serving plane is recorded: the admission
decision (shed cause and retry-after), the route (replica, reason, overlap
rows), the queue wait, each prefill or chunk, one event per decode
DISPATCH (never per token), and the terminal event (retire, cancel, abort
with a closed-enum cause). Records live in bounded rings, and
``AIOS_TPU_FLIGHTREC=0`` disables the recorder without changing a single
dispatch.
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

log = logging.getLogger("aios.obs")

# -- closed enums (linted by tests/test_obs_lint.py) ------------------------
# Every label-shaped string the recorder (and the aios_tpu_slo_* family
# built on it) emits comes from one of these tuples — free-form strings
# ride in non-enumerated detail fields only, so neither the recorder
# output nor any metric built on it can grow unbounded label sets.

# Timeline event kinds. "admit"/"shed" are the admission decision,
# "route" the replica choice, "queue" the wait for a slot, "prefill" one
# prefill dispatch (chunked admissions record one per chunk), "decode" a
# plain/masked decode dispatch, "jump" a grammar jump-ahead run, "spec" a
# speculative round batch, "restore"/"spill" the host KV tier moving
# pages, "retire"/"abort"/"cancel" the terminal event, "span" a folded-in
# finished tracing span, "respawn" a replica crash-respawn (model lane),
# "failover" an in-flight re-route to a surviving replica after a crash
# (serving/failover.py), "fault" an injected fault firing (model lane,
# aios_tpu/faults/), "kv_compress" a slot crossing the window+sink
# compression threshold and "seq_prefill" a sequence-sharded whole-mesh
# prefill admission (model lane, docs/ENGINE_PERF.md "Long-context
# tier").
EVENT_KINDS = (
    "admit", "shed", "route", "queue", "prefill", "decode", "jump",
    "spec", "restore", "spill", "retire", "abort", "cancel", "span",
    "respawn", "failover", "fault", "kv_compress", "seq_prefill",
    # "autoscale": an SLO-burn controller action (scale up/down, degrade
    # ladder rung, restore) on the model lane (serving/autoscale.py)
    "autoscale",
    # "fleet_member": a membership state-machine edge (new/up/suspect/
    # dead) on the "fleet" pseudo-model lane (obs/fleet.py) — the same
    # evidence as the transition journal, time-aligned with request
    # timelines
    "fleet_member",
    # "handoff": a disaggregated prefill->decode transfer of an
    # in-flight stream to a peer host (aios_tpu/fleet/disagg.py) — on
    # the request timeline when it rides one, else the model lane
    "handoff",
    # "quarantine": a per-peer circuit-breaker state edge (closed/open/
    # half_open) on the "fleet" pseudo-model lane
    # (aios_tpu/fleet/breaker.py) — the gray-host evidence trail
    "quarantine",
    # "drain": a graceful-drain phase edge (serving -> draining ->
    # leaving) on the "fleet" pseudo-model lane (aios_tpu/fleet/drain.py)
    "drain",
    # "incident": an incident bundle frozen on the model lane — the tsdb
    # window + snapshot + fault journal + devprof + lock-watchdog state
    # around an anomaly trigger (aios_tpu/obs/incidents.py)
    "incident",
)

# Shed causes — THE closed enum; serving/admission.py raises with these
# and serving/pool.py counts by them (both import this tuple).
# "degraded" is the autoscaler's ladder rung 3: best-effort (priority <
# the protected floor) requests shed while the pool digs out of an SLO
# burn — the reactive/operational tiers keep admitting.
#
# "draining_host" is the fleet drain protocol (aios_tpu/fleet/drain.py):
# the whole HOST is leaving, so unlike the per-pool "draining" cause the
# retry hint points clients at the surviving fleet, not this process.
SHED_CAUSES = ("quota", "deadline", "queue_full", "draining", "degraded",
               "draining_host")

# Abort causes: the batcher's human-readable ``abort_reason`` strings
# normalize onto this enum (the free-form text rides in the timeline's
# ``abort_detail``, never in a label).
ABORT_CAUSES = (
    "evicted", "prompt_too_large", "scheduler_failed", "model_unloading",
    "other",
)

# Abort causes a CLIENT retry (or the pool's transparent failover) can
# plausibly fix: the replica state that killed the request is transient.
# The runtime service returns UNAVAILABLE + retry-after-ms trailing
# metadata for these — the same convention as admission sheds — and
# serving/failover.py retries them in-flight before the client ever
# sees the abort ("evicted" only re-routes on a multi-replica pool; the
# same starved replica would just evict another victim). Deliberate
# aborts (model_unloading is an operator action, prompt_too_large a
# client error) stay non-retryable: a backoff hint there would put
# compliant clients in a futile retry loop.
RETRYABLE_ABORT_CAUSES = ("scheduler_failed", "evicted")

# Terminal timeline states.
STATES = ("live", "retired", "cancelled", "aborted", "shed")

# Anomaly snapshot causes.
SNAPSHOT_CAUSES = ("shed_spike", "crash_respawn", "slo_breach", "abort",
                   "manual")


def abort_cause(reason: str) -> str:
    """Normalize a free-form batcher ``abort_reason`` onto ABORT_CAUSES."""
    if reason.startswith("evicted"):
        return "evicted"
    if reason.startswith("prompt exceeds"):
        return "prompt_too_large"
    if reason.startswith("scheduler failed"):
        return "scheduler_failed"
    if reason.startswith("model unloading"):
        return "model_unloading"
    return "other"


# -- bounds -----------------------------------------------------------------

# Events per timeline: a decode event lands once per DISPATCH (~chunk_steps
# tokens), so 512 events cover a ~8k-token generation with default chunks;
# past the cap events drop and are counted (the record stays bounded no
# matter how long the stream runs).
MAX_EVENTS = 512

# Snapshot policy: how many frozen snapshots to keep, and the per-model
# per-cause cooldown (an abort storm must not thrash the snapshot store —
# the FIRST freeze holds the interesting state).
MAX_SNAPSHOTS = 8
SNAPSHOT_COOLDOWN_SECS = 30.0

# Shed-spike trigger: this many sheds inside the window freezes a snapshot.
SHED_SPIKE_N = 20
SHED_SPIKE_WINDOW_SECS = 10.0

class Timeline:
    """One request's flight record. Mutated only by the threads that own
    the request at the time (gRPC handler -> pool -> scheduler thread, a
    strictly sequenced handoff); readers (debug routes) take copies."""

    __slots__ = (
        "model", "request_id", "tenant", "trace_id", "priority",
        "prompt_tokens", "t0_wall", "t0", "events", "dropped_events",
        "state", "replica", "route_reason", "shed_cause", "abort_cause",
        "abort_detail", "retry_after_ms", "queue_wait_ms", "ttft_ms",
        "tpot_ms", "tokens_out", "device_us", "finished_at",
        "__weakref__",
    )

    def __init__(self, model: str, request_id: str, tenant: str,
                 trace_id: str, prompt_tokens: int, priority: int) -> None:
        self.model = model
        self.request_id = request_id
        self.tenant = tenant
        self.trace_id = trace_id
        self.priority = priority
        self.prompt_tokens = prompt_tokens
        self.t0_wall = time.time()
        self.t0 = time.monotonic()
        self.events: List[Tuple[float, str, dict]] = []
        self.dropped_events = 0
        self.state = "live"
        self.replica = -1
        self.route_reason = ""
        self.shed_cause = ""
        self.abort_cause = ""  # one of ABORT_CAUSES when aborted
        self.abort_detail = ""
        self.retry_after_ms = 0
        self.queue_wait_ms = 0.0
        self.ttft_ms = 0.0
        self.tpot_ms = 0.0
        self.tokens_out = 0
        # estimated device-microseconds attributed to this request
        # (obs/devprof.py: per-dispatch ledger means split by batch
        # occupancy + measured prefill time); 0 unless devprof is armed
        self.device_us = 0.0
        self.finished_at = 0.0  # monotonic, 0 while live

    def event(self, kind: str, **fields) -> Optional[dict]:
        """Append one event (bounded; drops count rather than grow).
        Returns the stored fields dict so the owning scheduler thread
        can join late-arriving per-dispatch data (the pipelined decode
        worker's sampled device-µs lands at consume time) — readers only
        see FINISHED timelines (the rings), so an owner-side join on a
        live one never races a reader's copy."""
        if len(self.events) >= MAX_EVENTS:
            self.dropped_events += 1
            return None
        self.events.append((time.monotonic() - self.t0, kind, fields))
        return fields

    @property
    def duration_ms(self) -> float:
        end = self.finished_at or time.monotonic()
        return (end - self.t0) * 1000.0

    def to_dict(self, events: bool = True) -> dict:
        out = {
            "model": self.model,
            "request_id": self.request_id,
            "tenant": self.tenant,
            "trace_id": self.trace_id,
            "priority": self.priority,
            "prompt_tokens": self.prompt_tokens,
            "submitted_at": self.t0_wall,
            "state": self.state,
            "replica": self.replica,
            "route_reason": self.route_reason,
            "shed_cause": self.shed_cause,
            "abort_cause": self.abort_cause,
            "abort_detail": self.abort_detail,
            "retry_after_ms": self.retry_after_ms,
            "queue_wait_ms": round(self.queue_wait_ms, 3),
            "ttft_ms": round(self.ttft_ms, 3),
            "tpot_ms": round(self.tpot_ms, 3),
            "tokens_out": self.tokens_out,
            "device_us": round(self.device_us, 1),
            "duration_ms": round(self.duration_ms, 3),
            "dropped_events": self.dropped_events,
        }
        if events:
            out["events"] = [
                {"t_ms": round(t * 1000.0, 3), "kind": k, **f}
                for t, k, f in list(self.events)
            ]
        return out


class FlightRecorder:
    """Bounded per-model rings of finished timelines + anomaly snapshots.

    One process-wide instance (``RECORDER``); tests build private ones.
    ``begin`` is the only entry point that allocates; every other hot-path
    touch is an O(1) append on the timeline itself.
    """

    def __init__(self, ring: Optional[int] = None,
                 enabled: Optional[bool] = None) -> None:
        if ring is None:
            try:
                ring = int(os.environ.get("AIOS_TPU_FLIGHTREC_RING", "256"))
            except ValueError:
                ring = 256
        if enabled is None:
            enabled = os.environ.get(
                "AIOS_TPU_FLIGHTREC", ""
            ).lower() not in ("0", "off", "false", "no")
        self.ring_size = max(ring, 1)
        self.enabled = enabled and ring != 0
        self._lock = make_lock("recorder")
        self._rings: Dict[str, deque] = {}  #: guarded_by _lock
        self._model_events: Dict[str, deque] = {}  #: guarded_by _lock
        self._snapshots: deque = deque(maxlen=MAX_SNAPSHOTS)
        self._snapshot_at: Dict[Tuple[str, str], float] = {}
        self._shed_marks: Dict[str, deque] = {}
        self._snap_ids = 0
        # finish listeners (the SLO engine registers itself): called with
        # the finished Timeline OUTSIDE the recorder lock; must not raise.
        self._listeners: List[Callable[[Timeline], None]] = []

    # -- lifecycle ----------------------------------------------------------

    def begin(self, model: str, request_id: str = "",
              tenant: str = "anonymous", trace_id: str = "",
              prompt_tokens: int = 0,
              priority: int = 0) -> Optional[Timeline]:
        """Open a timeline (None when the recorder is disabled — every
        call site guards on that)."""
        if not self.enabled:
            return None
        return Timeline(model, request_id, tenant, trace_id, prompt_tokens,
                        priority)

    def add_listener(self, fn: Callable[[Timeline], None]) -> None:
        self._listeners.append(fn)

    def _ring(self, model: str) -> deque:
        ring = self._rings.get(model)
        if ring is None:
            ring = self._rings.setdefault(
                model, deque(maxlen=self.ring_size)
            )
        return ring

    def finish(self, tl: Optional[Timeline], state: str = "retired",
               abort_reason: str = "", shed_cause: str = "",
               retry_after_ms: int = 0) -> None:
        """Close a timeline into its model's ring — the ONE owner of the
        close sequence (terminal event, ring append, listener fan-out)
        for every state. ``state`` is one of STATES; an aborted finish
        normalizes ``abort_reason`` onto the closed ABORT_CAUSES enum
        (the raw string rides in abort_detail) and freezes an anomaly
        snapshot."""
        if tl is None or tl.finished_at:
            return
        tl.finished_at = time.monotonic()
        tl.state = state
        if state == "aborted":
            tl.abort_cause = abort_cause(abort_reason)
            tl.abort_detail = abort_reason[:200]
            tl.event("abort", cause=tl.abort_cause)
        elif state == "retired":
            tl.event("retire", tokens=tl.tokens_out)
        elif state == "cancelled":
            tl.event("cancel")
        elif state == "shed":
            tl.shed_cause = (
                shed_cause if shed_cause in SHED_CAUSES else "draining"
            )
            tl.retry_after_ms = int(retry_after_ms)
            tl.event("shed", cause=tl.shed_cause,
                     retry_after_ms=tl.retry_after_ms)
        with self._lock:
            self._ring(tl.model).append(tl)
        for fn in self._listeners:
            try:
                fn(tl)
            except Exception:  # noqa: BLE001 - obs must not break serving
                log.exception("flight-recorder finish listener failed")
        if state == "aborted":
            # async: finish() runs on the batcher scheduler thread
            self.snapshot(tl.model, "abort", sync=False)

    def finish_shed(self, tl: Optional[Timeline], cause: str,
                    retry_after_ms: int, model: str = "") -> None:
        """Close a timeline as shed (+ spike detection, which fires even
        when the recorder is disabled so the snapshot trigger still
        guards the plane)."""
        model = model or (tl.model if tl is not None else "")
        self.finish(tl, "shed", shed_cause=cause,
                    retry_after_ms=retry_after_ms)
        if model:
            self._note_shed(model)

    def _note_shed(self, model: str) -> None:
        now = time.monotonic()
        with self._lock:
            marks = self._shed_marks.setdefault(
                model, deque(maxlen=SHED_SPIKE_N)
            )
            marks.append(now)
            spike = (
                len(marks) == SHED_SPIKE_N
                and now - marks[0] <= SHED_SPIKE_WINDOW_SECS
            )
        if spike:
            self.snapshot(model, "shed_spike", sync=False)  # gRPC path

    # -- model-lane events (engine/pool happenings not owned by one
    # request: host-tier spills, restores, replica respawns) ---------------

    def model_event(self, model: str, kind: str, **fields) -> None:
        if not self.enabled:
            return
        entry = (time.monotonic(), time.time(), kind, fields)
        with self._lock:
            # append INSIDE the lock: model_events()/snapshot() iterate
            # this deque under it, and a concurrent append would raise
            # "deque mutated during iteration" into the engine hot path
            self._model_events.setdefault(
                model, deque(maxlen=MAX_EVENTS)
            ).append(entry)

    # -- reads --------------------------------------------------------------

    def recent(self, model: str = "", limit: int = 64) -> List[Timeline]:
        """Most-recent finished timelines, oldest first."""
        with self._lock:
            if model:
                tls = list(self._rings.get(model, ()))
            else:
                tls = [t for ring in self._rings.values() for t in ring]
        tls.sort(key=lambda t: t.t0)
        return tls[-limit:]

    def model_events(self, model: str = "") -> List[tuple]:
        """Model-lane events as (wall_ts, model, kind, fields) tuples."""
        with self._lock:
            lanes = (
                {model: self._model_events.get(model, ())}
                if model else dict(self._model_events)
            )
            return [
                (wall, m, kind, fields)
                for m, lane in lanes.items()
                for _, wall, kind, fields in lane
            ]

    # -- anomaly snapshots ---------------------------------------------------

    def snapshot(self, model: str, cause: str,
                 sync: bool = True) -> Optional[dict]:
        """Freeze the model's last N timelines (+ model-lane events) so a
        transient anomaly survives ring churn. Cooldown-limited per
        (model, cause); returns the snapshot dict, or None when skipped
        — or when ``sync=False``, which builds the snapshot on a
        background daemon thread (the auto-trigger paths run on the
        scheduler / gRPC threads, and the O(ring x events) to_dict()
        pass must not stall decode scheduling exactly while the plane is
        degraded). The cooldown stamp and snapshot id are still claimed
        synchronously, so a burst of triggers freezes exactly one."""
        if cause not in SNAPSHOT_CAUSES:
            cause = "manual"
        now = time.monotonic()
        with self._lock:
            last = self._snapshot_at.get((model, cause), 0.0)
            if now - last < SNAPSHOT_COOLDOWN_SECS:
                return None
            self._snapshot_at[(model, cause)] = now
            self._snap_ids += 1
            snap_id = self._snap_ids
            # copy references only — the dict-building pass runs OUTSIDE
            # the lock, or every finish()/model_event() on the serving
            # path would stall behind the serialization
            tls = list(self._rings.get(model, ()))
            lane = list(self._model_events.get(model, ()))
        if not sync:
            threading.Thread(
                target=self._build_snapshot,
                args=(snap_id, model, cause, tls, lane),
                name="flightrec-snapshot", daemon=True,
            ).start()
            return None
        return self._build_snapshot(snap_id, model, cause, tls, lane)

    def _build_snapshot(self, snap_id: int, model: str, cause: str,
                        tls: list, lane: list) -> dict:
        snap = {
            "id": snap_id,
            "model": model,
            "cause": cause,
            "at": time.time(),
            "timelines": [t.to_dict() for t in tls],
            "model_events": [
                {"t_wall": w, "kind": k, **f} for _, w, k, f in lane
            ],
        }
        with self._lock:
            self._snapshots.append(snap)
        dump_dir = os.environ.get("AIOS_TPU_FLIGHTREC_DUMP_DIR", "")
        if dump_dir:
            try:
                os.makedirs(dump_dir, exist_ok=True)
                path = os.path.join(
                    dump_dir, f"flightrec-{model}-{cause}-{snap['id']}.json"
                )
                with open(path, "w") as f:
                    json.dump(snap, f)
                log.warning("flight recorder snapshot (%s/%s) -> %s",
                            model, cause, path)
            except OSError as exc:
                log.warning("flight recorder dump failed: %s", exc)
        else:
            log.warning(
                "flight recorder snapshot frozen (%s/%s, %d timelines); "
                "RECORDER.snapshots() reads it", model, cause,
                len(snap["timelines"]),
            )
        return snap

    def snapshots(self) -> List[dict]:
        with self._lock:
            return list(self._snapshots)

    def clear(self) -> None:
        """Test isolation."""
        with self._lock:
            self._rings.clear()
            self._model_events.clear()
            self._snapshots.clear()
            self._snapshot_at.clear()
            self._shed_marks.clear()


# -- process-wide instance ----------------------------------------------------

RECORDER = FlightRecorder()
