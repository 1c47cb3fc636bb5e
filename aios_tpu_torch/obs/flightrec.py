"""Serving-plane flight recorder: one structured timeline per request.

RTP-LLM (PAPERS.md) treats request-level timelines as the operability
backbone of a serving engine: when a request is slow, was shed, or came
back truncated, the operator needs WHAT HAPPENED TO *THIS* REQUEST, not
another aggregate. The recorder answers that question for every request
through the serving plane:

    admission decision (quota/deadline/shed cause + retry-after)
      -> route choice (replica, reason, overlap rows incl. the
         host-discounted ones)
      -> queue wait -> prefill chunks (cached / restored rows)
      -> per-dispatch decode ticks (step count, batch occupancy,
         pipeline host gap) / jump-ahead runs / spec rounds
      -> retirement (or abort / shed, with a CLOSED-ENUM cause)

Everything is host-side bookkeeping: events are appended per DISPATCH or
per DECISION (never per token), records live in a bounded per-model ring
buffer, and the whole thing can be disabled (``AIOS_TPU_FLIGHTREC=0``)
without changing a single dispatch — the engine's compile counters and
dispatch counts are identical recorder ON vs OFF (the engine's
dispatch invariant, extended to observability).

Timelines correlate with the span tree through the request's trace id:
``install_span_export`` wires the previously-dormant
``tracing.set_exporter`` hook so finished RPC spans fold into the
matching timeline as ``span`` events.

Export surfaces (obs/http.py): ``/debug/requests`` (recent timelines as
JSON), ``/debug/trace`` (Chrome trace-event / Perfetto JSON),
``/debug/spans`` (the finished-span ring), and anomaly auto-snapshots —
a shed spike, crash-respawn, SLO breach, or abort freezes the last N
timelines so the evidence survives the ring (docs/RUNBOOK.md section 4).
"""

from __future__ import annotations

import json
import logging
import os
import threading
import time
from collections import OrderedDict, deque
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
# aios_tpu_torch/faults/), "kv_compress" a slot crossing the window+sink
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
    # in-flight stream to a peer host (aios_tpu_torch/fleet/disagg.py) — on
    # the request timeline when it rides one, else the model lane
    "handoff",
    # "quarantine": a per-peer circuit-breaker state edge (closed/open/
    # half_open) on the "fleet" pseudo-model lane
    # (aios_tpu_torch/fleet/breaker.py) — the gray-host evidence trail
    "quarantine",
    # "drain": a graceful-drain phase edge (serving -> draining ->
    # leaving) on the "fleet" pseudo-model lane (aios_tpu_torch/fleet/drain.py)
    "drain",
    # "incident": an incident bundle frozen on the model lane — the tsdb
    # window + snapshot + fault journal + devprof + lock-watchdog state
    # around an anomaly trigger (aios_tpu_torch/obs/incidents.py)
    "incident",
)

# Shed causes — THE closed enum; serving/admission.py raises with these
# and serving/pool.py counts by them (both import this tuple).
# "degraded" is the autoscaler's ladder rung 3: best-effort (priority <
# the protected floor) requests shed while the pool digs out of an SLO
# burn — the reactive/operational tiers keep admitting.
#
# "draining_host" is the fleet drain protocol (aios_tpu_torch/fleet/drain.py):
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

# trace_id -> timeline index bound (client-driven cardinality).
_MAX_TRACE_INDEX = 4096


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
        live one never races a /debug copy."""
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
        # trace_id -> recent timelines sharing it: an agent task's RPCs
        # all propagate ONE traceparent, so a single-slot map would make
        # every begin() steal the previous request's span correlation
        self._by_trace: "OrderedDict[str, deque]" = OrderedDict()
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
        tl = Timeline(model, request_id, tenant, trace_id, prompt_tokens,
                      priority)
        if trace_id:
            with self._lock:
                peers = self._by_trace.get(trace_id)
                if peers is None:
                    peers = self._by_trace[trace_id] = deque(maxlen=8)
                else:
                    self._by_trace.move_to_end(trace_id)
                peers.append(tl)
                while len(self._by_trace) > _MAX_TRACE_INDEX:
                    self._by_trace.popitem(last=False)
        return tl

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

    # -- span folding (the dormant tracing.set_exporter hook) --------------

    def export_span(self, span) -> None:
        """tracing exporter callback: fold a finished span into the
        timeline sharing its trace id (live or recently finished — RPC
        server spans close AFTER the request retires). An agent task's
        RPCs share ONE propagated traceparent, so among the trace's
        recent timelines the span lands on the newest one whose lifetime
        overlaps it (1 s grace for clock jitter), not blindly on the
        latest begin()."""
        if not self.enabled:
            return
        with self._lock:
            peers = self._by_trace.get(span.trace_id)
            candidates = list(peers) if peers else ()
        if not candidates:
            return
        start = getattr(span, "start", 0.0)
        end = getattr(span, "end", 0.0) or time.time()
        tl = candidates[-1]
        for cand in reversed(candidates):  # newest first
            cand_end = cand.t0_wall + cand.duration_ms / 1000.0
            if cand.t0_wall - 1.0 <= end and start <= cand_end + 1.0:
                tl = cand
                break
        tl.event(
            "span", name=span.name, dur_ms=round(span.duration_s * 1e3, 3),
            status=span.status, span_id=span.span_id,
        )

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
        # Every fired snapshot is also an incident trigger: the bundle
        # freezes the tsdb window + fault journal + devprof state around
        # the same anomaly. Hooked here — after the append — so the
        # incident's flightrec section always finds the snapshot it
        # belongs to. Late import: flightrec loads before incidents in
        # the obs package; notify() is a no-op when the store is
        # unarmed, and runs its own per-(model, cause) cooldown.
        from . import incidents as _incidents
        _incidents.notify(model, cause)
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
                "GET /debug/snapshots to read it", model, cause,
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
            self._by_trace.clear()
            self._snapshots.clear()
            self._snapshot_at.clear()
            self._shed_marks.clear()


# -- Chrome trace-event export ----------------------------------------------

# Event kinds rendered as zero-duration instants unless they carry dur_ms.
_PHASE_NAMES = {
    "prefill": "prefill", "decode": "decode", "jump": "jump-ahead",
    "spec": "speculative", "span": "span",
}


def _tl_view(tl) -> tuple:
    """Uniform view over a live :class:`Timeline` or a frozen snapshot's
    ``to_dict()`` dict, so one renderer serves both (the snapshot path
    must not drift from the live one): (model, request_id, tenant,
    state, t0_wall, duration_ms, queue_wait_ms, events, summary_args)
    with events as (t_rel_s, kind, fields) tuples."""
    if isinstance(tl, dict):
        events = [
            (e.get("t_ms", 0.0) / 1e3, e.get("kind", ""),
             {k: v for k, v in e.items() if k not in ("t_ms", "kind")})
            for e in tl.get("events", ())
        ]
        return (
            tl.get("model", ""), tl.get("request_id", ""),
            tl.get("tenant", ""), tl.get("state", ""),
            tl.get("submitted_at", 0.0), tl.get("duration_ms", 0.0),
            tl.get("queue_wait_ms", 0.0), events,
            {k: v for k, v in tl.items() if k != "events"},
        )
    return (
        tl.model, tl.request_id, tl.tenant, tl.state, tl.t0_wall,
        tl.duration_ms, tl.queue_wait_ms, list(tl.events),
        tl.to_dict(events=False),
    )


def chrome_trace(timelines: list, model_events: List[tuple] = ()) -> dict:
    """Render timelines (live :class:`Timeline` objects or a snapshot's
    frozen dicts) as Chrome trace-event JSON (chrome://tracing /
    Perfetto "JSON Object Format"): one pid per model, one tid per
    request, X (complete) events for the request envelope + queue wait +
    dur-carrying dispatches, i (instant) events for decisions. ts/dur
    are microseconds of wall time. ``model_events`` are the recorder's
    (wall_ts, model, kind, fields) lane tuples, rendered on tid 0."""
    events: List[dict] = []
    pids: Dict[str, int] = {}

    def pid_of(model: str) -> int:
        pid = pids.get(model)
        if pid is None:
            pid = pids[model] = len(pids) + 1
            events.append({
                "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
                "args": {"name": f"model:{model}"},
            })
            events.append({
                "ph": "M", "pid": pid, "tid": 0, "name": "thread_name",
                "args": {"name": "engine lane"},
            })
        return pid

    for tid, tl in enumerate(timelines, start=1):
        (model, request_id, tenant, state, t0_wall, duration_ms,
         queue_wait_ms, tl_events, summary) = _tl_view(tl)
        pid = pid_of(model)
        base_us = t0_wall * 1e6
        events.append({
            "ph": "M", "pid": pid, "tid": tid, "name": "thread_name",
            "args": {"name": f"{request_id or 'req'} ({tenant})"},
        })
        events.append({
            "ph": "X", "pid": pid, "tid": tid,
            "name": f"request[{state}]",
            "cat": "request", "ts": base_us,
            "dur": max(duration_ms * 1e3, 1.0),
            "args": summary,
        })
        if queue_wait_ms:
            events.append({
                "ph": "X", "pid": pid, "tid": tid, "name": "queue",
                "cat": "queue", "ts": base_us,
                "dur": max(queue_wait_ms * 1e3, 1.0),
                "args": {"wait_ms": round(queue_wait_ms, 3)},
            })
        for t_rel, kind, fields in tl_events:
            ts = base_us + t_rel * 1e6
            dur_ms = fields.get("dur_ms")
            if dur_ms is not None:
                events.append({
                    "ph": "X", "pid": pid, "tid": tid,
                    "name": _PHASE_NAMES.get(kind, kind), "cat": kind,
                    "ts": ts - float(dur_ms) * 1e3,
                    "dur": max(float(dur_ms) * 1e3, 1.0),
                    "args": dict(fields),
                })
            else:
                events.append({
                    "ph": "i", "pid": pid, "tid": tid, "name": kind,
                    "cat": kind, "ts": ts, "s": "t",
                    "args": dict(fields),
                })
    for wall, model, kind, fields in model_events:
        events.append({
            "ph": "i", "pid": pid_of(model), "tid": 0, "name": kind,
            "cat": kind, "ts": wall * 1e6, "s": "p", "args": dict(fields),
        })
    events.sort(key=lambda e: e.get("ts", 0))
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def snapshot_trace(snap: dict) -> dict:
    """A frozen anomaly snapshot in Chrome trace shape — same renderer
    as the live path (snapshots store to_dict() timelines and the
    engine-lane events; both survive the freeze)."""
    lane = [
        (e.get("t_wall", 0.0), snap.get("model", ""), e.get("kind", ""),
         {k: v for k, v in e.items() if k not in ("t_wall", "kind")})
        for e in snap.get("model_events", ())
    ]
    return chrome_trace(snap.get("timelines", ()), lane)


# -- process-wide instance + tracing hookup ---------------------------------

RECORDER = FlightRecorder()


def install_span_export() -> None:
    """Wire the dormant ``tracing.set_exporter`` hook to the recorder —
    only when nothing else claimed it (a deployment's own exporter
    wins)."""
    from . import tracing

    if tracing.get_exporter() is None:
        tracing.set_exporter(RECORDER.export_span)
