"""ReplicaPool: N engine+batcher replicas behind one managed model.

A copy of ``aios_tpu/serving/pool.py`` over the port's engines and
batchers. On one card the replicas share one copy of the weights (the
model manager builds replicas 1..N-1 over replica 0's serving leaves);
each owns its page pool, prefix index, CUDA graphs and graph stream, and
its batcher thread replays on that thread's current stream, the device's
legacy default stream, which orders the replicas' work one after another.
The SLO autoscaler (``serving/autoscale.py``) drives ``add_replica`` /
``remove_replica`` and the degrade ladder; the devprof ledger seeds the
deadline gate's cold-start rate (``_devprof_rate``).

Sits between ``RuntimeService`` and the engines with no wire-format
change: ``LoadModel``/``UnloadModel`` operate on the pool, every
``Infer``/``StreamInfer`` goes admission -> routing -> one replica's
continuous batcher. Lifecycle is coordinated here:

  * **spawn** — the pool builds one batcher per engine through a factory
    (the same factory respawns crashed ones);
  * **drain** — stop admitting, let in-flight streams finish;
  * **hot-swap** — ModelManager builds the NEW pool first, swaps it into
    the registry, then drains and shuts this one down in the background;
  * **crash-restart** — a replica whose scheduler thread died (or
    recorded a fatal error) gets a fresh batcher over the same engine,
    counted by the spawner-style restart counter
    (``aios_tpu_serving_replica_restarts_total``);
  * **device fault** — the port's own rule: a CUDA error poisons the
    context all replicas share, so it is never respawned or failed over;
    the pool refuses new work (``DeviceFault``) and ``on_device_fault``
    tells its owner.

Everything reports through the obs layer (``aios_tpu_serving_*``) and
``pool.stats()`` — the pool-level twin of ``engine.stats()``.
"""

from __future__ import annotations

import logging
import time
import weakref
from typing import Callable, Dict, List, Optional, Sequence

from ..analysis.locks import make_lock
from ..device import DEVICE_FAULT_REASON, DeviceFault
from ..obs import instruments as obs
from ..obs import flightrec
from ..obs.flightrec import SHED_CAUSES
from .admission import AdmissionController, AdmissionError
from .config import ServingConfig
from .failover import FailoverHandle
from .router import ROUTE_REASONS, Router

log = logging.getLogger("aios.torch.serving")


class Replica:
    """One engine + its continuous batcher, with the live numbers the
    router and admission gates read."""

    def __init__(self, idx: int, engine, batcher) -> None:
        self.idx = idx
        self.engine = engine
        self.batcher = batcher

    def overlap_rows(self, prompt_ids: List[int], hashes=None) -> int:
        fn = getattr(self.engine, "prefix_overlap_rows", None)
        return fn(prompt_ids, hashes=hashes) if fn is not None else 0

    def prefix_hashes(self, prompt_ids: List[int]):
        fn = getattr(self.engine, "prefix_hashes", None)
        return fn(prompt_ids) if fn is not None else []

    def outstanding_tokens(self) -> int:
        return self.batcher.outstanding_tokens()

    def queue_depth(self) -> int:
        return self.batcher.queue_depth()

    def tokens_per_second(self) -> float:
        return self.batcher.tokens_per_second()

    def occupancy(self) -> float:
        n = self.engine.num_slots
        return float(self.engine.active.sum()) / n if n else 0.0

    def idle(self) -> bool:
        return self.queue_depth() == 0 and self.batcher.active_count == 0

    def dead(self) -> bool:
        """A replica needing a respawn: its scheduler thread exited
        outside shutdown, or recorded a fatal scheduler error (which
        aborted every outstanding request — a fresh batcher gives the
        next request a clean slate)."""
        b = self.batcher
        if b._closed or getattr(b, "device_fault", None) is not None:
            return False  # shutting down, or past any respawn
        return b.last_error is not None or not b._thread.is_alive()


class ReplicaPool:
    def __init__(
        self,
        name: str,
        engines: Sequence,
        batcher_factory: Callable,
        config: Optional[ServingConfig] = None,
    ) -> None:
        if not engines:
            raise ValueError("a pool needs at least one engine")
        self.name = name
        self.cfg = config or ServingConfig()
        self._factory = batcher_factory
        self.router = Router(overlap_min_ratio=self.cfg.overlap_min_ratio)
        self.admission = AdmissionController(self.cfg, name)
        # the first CUDA error any replica's scheduler met; the pool then
        # takes no request, and on_device_fault(exc) tells its owner
        self.device_fault: Optional[BaseException] = None
        self.on_device_fault: Optional[Callable] = None
        self.replicas: List[Replica] = []
        try:
            for i, e in enumerate(engines):
                self.replicas.append(Replica(i, e, self._spawn_batcher(e)))
        except BaseException:
            # a failed spawn must not leave earlier replicas' scheduler
            # threads running (the caller will close the engines)
            for r in self.replicas:
                try:
                    r.batcher.shutdown()
                # aios: waive(silent-except): best-effort cleanup of a failed pool spawn — the root cause re-raises right below
                except Exception:  # noqa: BLE001
                    pass
            raise
        self.restarts = 0  # spawner-style: batchers respawned after crash
        # Degrade ladder position (serving/autoscale.py): 0 = healthy,
        # 1 = speculation off, 2 = + jump-ahead off, 3 = + best-effort
        # tiers shed at admission. Mechanism lives HERE (fresh batchers
        # from crash-respawn or scale-up inherit the level); policy —
        # when to move — lives in the controller. Plain int, flipped
        # cross-thread by set_degrade_level.
        self.degrade_level = 0
        # set by an attached AutoscaleController; shutdown() stops it so
        # an unload/hot-swap can never leave a controller scaling a
        # drained pool
        self.autoscaler = None
        # cold-start deadline feasibility: seed the assumed decode rate
        # from the devprof ledger's per-graph step means when devprof is
        # armed (env knob wins — see AdmissionController.assumed_rate)
        self.admission.devprof_rate_fn = self._devprof_rate
        # optional hook fired as on_respawn(replica_idx, new_batcher) —
        # ModelManager uses it to keep ManagedModel's replica-0 batcher
        # snapshot from going stale after a crash-respawn
        self.on_respawn: Optional[Callable] = None
        self._draining = False
        self._closed = False
        self._lock = make_lock("pool")
        #: guarded_by _lock
        self._routed: Dict[str, int] = {r: 0 for r in ROUTE_REASONS}
        #: guarded_by _lock
        self._shed: Dict[str, int] = {c: 0 for c in SHED_CAUSES}
        self._obs_routed = {
            r: obs.SERVING_ROUTING_DECISIONS.labels(model=name, reason=r)
            for r in ROUTE_REASONS
        }
        self._obs_restarts = obs.SERVING_REPLICA_RESTARTS.labels(model=name)
        self._register_gauges()

    def _spawn_batcher(self, engine):
        b = self._factory(engine)
        b.on_device_fault = self._device_lost
        # serving-side queue-wait histogram: observed by the batcher at
        # slot assignment (see ContinuousBatcher.queue_wait_obs)
        b.queue_wait_obs = obs.SERVING_QUEUE_WAIT.labels(model=self.name)
        # a batcher spawned mid-degrade (crash-respawn, scale-up)
        # inherits the pool's current ladder position
        level = getattr(self, "degrade_level", 0)
        b.degrade_spec = level >= 1
        b.degrade_jump = level >= 2
        return b

    def _devprof_rate(self) -> float:
        """Devprof-seeded cold-start decode rate: chunk_steps tokens per
        decode dispatch over the ledger's mean sampled step seconds — a
        conservative single-slot tokens/sec floor for the deadline
        feasibility gate. 0.0 (gate stays cold-disabled) when devprof is
        unarmed or has no step samples yet."""
        from ..obs import devprof

        reps = self.replicas
        if not reps:
            return 0.0
        steps = getattr(reps[0].batcher, "chunk_steps", 0)
        if steps <= 0:
            return 0.0
        means = [
            m for m in (
                led.mean_s("step") for led in devprof.ledgers_for(self.name)
            ) if m
        ]
        if not means:
            return 0.0
        return steps / (sum(means) / len(means))

    def _register_gauges(self) -> None:
        ref = weakref.ref(self)
        # (child, bound fn, removal) triples: shutdown drops any series
        # STILL bound to this pool — a replacement pool of fewer replicas
        # must not leave the old higher-index series scraping 0.0 forever,
        # while series a replacement already rebound are left alone
        self._gauge_bindings = []

        def nrep():
            p = ref()
            return float(len(p.replicas)) \
                if p is not None and not p._closed else 0.0

        child = obs.SERVING_REPLICAS.labels(model=self.name)
        child.set_function(nrep)
        self._gauge_bindings.append((
            child, nrep,
            lambda: obs.SERVING_REPLICAS.remove(model=self.name),
        ))
        for i in range(len(self.replicas)):
            self._bind_occupancy(i)

    def _bind_occupancy(self, i: int) -> None:
        """Bind the per-index occupancy gauge (shared by construction
        and autoscale add_replica; an index past the live list — a
        scaled-down or crashed replica — reads 0.0)."""
        ref = weakref.ref(self)

        def occ(i=i):
            p = ref()
            if p is None or p._closed or i >= len(p.replicas):
                return 0.0
            return p.replicas[i].occupancy()

        child = obs.SERVING_REPLICA_OCCUPANCY.labels(
            model=self.name, replica=str(i)
        )
        child.set_function(occ)
        self._gauge_bindings.append((
            child, occ,
            lambda i=i: obs.SERVING_REPLICA_OCCUPANCY.remove(
                model=self.name, replica=str(i)
            ),
        ))

    # -- serving ------------------------------------------------------------

    def submit(self, req, tenant: str = "anonymous",
               deadline_s: Optional[float] = None):
        """Admission -> routing -> replica submit. Raises
        :class:`AdmissionError` when the request is shed (the service
        maps it to RESOURCE_EXHAUSTED + retry-after-ms metadata).
        Eligible requests come back wrapped in a
        :class:`~aios_tpu_torch.serving.failover.FailoverHandle`: a replica
        crash mid-stream resumes on a surviving replica instead of
        truncating (grammar-constrained requests are not wrapped — a
        mid-stream resume cannot reproduce their forced first token).
        Raises :class:`~aios_tpu_torch.device.DeviceFault` once a replica
        met a CUDA error."""
        if self.device_fault is not None:
            rec = getattr(req, "rec", None)
            if rec is not None:
                flightrec.RECORDER.finish(
                    rec, "aborted", abort_reason=DEVICE_FAULT_REASON)
            self._check_device()
        # flight recorder: the runtime service opens the timeline with
        # tenant + trace context; direct pool callers (tests, bench) get
        # one here so every request through the front door is recorded
        if getattr(req, "rec", None) is None:
            req.rec = flightrec.RECORDER.begin(
                self.name, req.request_id, tenant,
                prompt_tokens=len(req.prompt_ids),
                priority=getattr(req, "priority", 0),
            )
        fo = None
        if (
            self.cfg.failover_retries > 0
            and getattr(req, "json_schema", None) is None
            and not getattr(req, "json_mode", False)
            and getattr(req, "failover", None) is None
        ):
            # installed BEFORE the batcher sees the request: a crash in
            # the window between submit and wrap would otherwise finish
            # the timeline as aborted and strand the retry
            fo = FailoverHandle(
                self, req, tenant, self.cfg.failover_retries,
                self.cfg.failover_backoff_ms,
            )
            req.failover = fo
        try:
            handle = self._submit(req, tenant, deadline_s)
        except AdmissionError as e:
            with self._lock:
                self._shed[e.cause] = self._shed.get(e.cause, 0) + 1
            # the shed IS the request's terminal event: record cause +
            # retry-after and run spike detection (a shed storm freezes
            # an anomaly snapshot even with the recorder disabled)
            flightrec.RECORDER.finish_shed(
                req.rec, e.cause, e.retry_after_ms, model=self.name
            )
            raise
        if fo is None:
            return handle
        fo._inner = handle
        return fo

    def submit_failover(self, req, cause: str, attempt: int,
                        backoff_ms: float):
        """Re-route an in-flight request whose replica failed
        (serving/failover.py). Admission is SKIPPED: the quota was
        debited and the queue/deadline gates judged this request at
        first admission — a crashed replica must not double-bill the
        tenant or shed a stream the client is already consuming.
        Crashed replicas respawn first; then the grown prompt (prompt +
        already-emitted tokens) routes normally — the radix index / host
        tier make the re-prefill a cache hit. An ``evicted`` failover
        routes least-loaded instead (sticky/prefix would send it
        straight back to the starved replica that just evicted it)."""
        if self._draining or self._closed:
            raise RuntimeError(f"model {self.name} is draining")
        self._check_device()
        self._respawn_dead()
        # snapshot: a concurrent autoscale add/remove rebinding
        # self.replicas must not tear index selection mid-route
        reps = self.replicas
        route_ids, _ = self._route_ids(req)
        route_detail: Dict[str, int] = {}
        if cause == "evicted" and len(reps) > 1:
            idx, reason = self.router.least_loaded(reps), \
                "least_loaded"
        else:
            hashes = reps[0].prefix_hashes(route_ids)
            idx, reason = self.router.select(
                reps, route_ids, req.request_id, hashes=hashes,
                detail=route_detail,
            )
        rec = getattr(req, "rec", None)
        if rec is not None:
            rec.replica, rec.route_reason = idx, reason
            rec.event(
                "failover", attempt=attempt, cause=cause,
                backoff_ms=backoff_ms, replica=idx, reason=reason,
                resumed_tokens=len(req.prompt_ids), **route_detail,
            )
        task_id = req.request_id
        handle = reps[idx].batcher.submit(req)
        self._count_route(reason, task_id, idx)
        return handle

    def _route_ids(self, req):
        """The ADMISSION-TRUNCATED prompt (engines keep only the last
        max_context-1 ids) + the cap — shared by first-admission routing
        and failover re-routing: the router's overlap threshold is a
        fraction of the prompt it compares against cacheable rows, so an
        over-length raw prompt would make the prefix route
        unreachable."""
        cap = getattr(self.replicas[0].engine, "max_context", None)
        route_ids = req.prompt_ids
        if cap is not None and len(route_ids) > cap - 1:
            route_ids = route_ids[-(cap - 1):]
        return route_ids, cap

    def _count_route(self, reason: str, task_id: str, idx: int) -> None:
        """Routing bookkeeping shared by _submit and submit_failover:
        tallies + metric, and the sticky binding — except for ``spill``
        (a one-off overflow must not REBIND the task away from its
        cache-holding replica: sticky outranks prefix at select time, so
        recording the spill index would pin every later continuation to
        the wrong replica after the full one drains)."""
        with self._lock:
            self._routed[reason] = self._routed.get(reason, 0) + 1
        self._obs_routed[reason].inc()
        if reason != "spill":
            self.router.note_routed(task_id, idx)

    def _submit(self, req, tenant: str, deadline_s: Optional[float]):
        if self._draining or self._closed:
            raise self.admission.shed(
                "draining", f"model {self.name} is draining", 2000
            )
        # host-level graceful drain (fleet/drain.py): the whole host is
        # leaving — shed before any gate debits quota or queues work
        self.admission.check_host_drain()
        # degrade ladder rung 3 (clock-free policy gate, before any
        # routing work): best-effort tiers shed while the autoscaler digs
        # the pool out of an SLO burn; priority >= 1 stays protected
        self.admission.check_priority(getattr(req, "priority", 0))
        self._respawn_dead()
        # snapshot: a concurrent autoscale add/remove rebinding
        # self.replicas must not tear index selection mid-route
        reps = self.replicas
        # hash the blocks ONCE; every replica's probe reuses the digests
        # (replicas share page size and truncation — see _route_ids)
        route_ids, cap = self._route_ids(req)
        hashes = reps[0].prefix_hashes(route_ids)
        rec = getattr(req, "rec", None)
        route_detail: Dict[str, int] = {}
        idx, reason = self.router.select(
            reps, route_ids, req.request_id, hashes=hashes,
            detail=route_detail,
        )
        if (
            self.cfg.max_queue > 0
            and len(reps) > 1
            and reps[idx].queue_depth() >= self.cfg.max_queue
        ):
            # spill: a full cache-preferred replica must not shed while a
            # sibling has queue room (losing the prefix hit beats a shed)
            # — least-loaded AMONG the replicas with room, not overall
            # (the global minimum can itself be full of small budgets)
            with_room = [
                i for i, rep in enumerate(reps)
                if rep.queue_depth() < self.cfg.max_queue
            ]
            if with_room:
                alt = min(
                    with_room,
                    key=lambda i: reps[i].outstanding_tokens(),
                )
                idx, reason = alt, "spill"
        r = reps[idx]
        self.admission.check_queue(
            r.queue_depth(), r.outstanding_tokens(), r.tokens_per_second()
        )
        # the cache caps what this request can actually decode — a giant
        # max_tokens on a small context (or after a long prompt) is not a
        # giant deadline requirement; the truncated prompt length is what
        # actually occupies cache rows
        decode_cost = req.max_tokens
        if cap is not None:
            decode_cost = min(
                req.max_tokens, max(cap - len(route_ids), 0)
            )
        self.admission.check_deadline(
            deadline_s, r.outstanding_tokens(), decode_cost,
            r.tokens_per_second(),
        )
        # quota debits LAST, once nothing further can shed: a request
        # rejected by the queue/deadline gates was never served, so it
        # must not burn the tenant's bucket (shed->retry loops would
        # starve the tenant's feasible traffic). Cost = the work the pool
        # will actually do: truncated prompt + cache-capped decode.
        self.admission.check_quota(tenant, len(route_ids) + decode_cost)
        if rec is not None:
            rec.replica, rec.route_reason = idx, reason
            rec.event("route", replica=idx, reason=reason, **route_detail)
            # admission verdict AFTER the last gate that can shed: the
            # admit event means every gate passed, with the evidence the
            # gates judged (queue depth, decode budget, deadline)
            rec.event(
                "admit", replica=idx, queue_depth=r.queue_depth(),
                outstanding_tokens=r.outstanding_tokens(),
                decode_cost=decode_cost,
                deadline_s=round(deadline_s, 3)
                if deadline_s is not None else None,
            )
        # capture BEFORE batcher.submit: it assigns an auto id to blank
        # request_ids, which must not enter the sticky map (auto ids are
        # per-batcher counters and collide across replicas)
        task_id = req.request_id
        handle = r.batcher.submit(req)
        self._count_route(reason, task_id, idx)
        return handle

    def _check_device(self) -> None:
        if self.device_fault is not None:
            raise DeviceFault(
                f"model {self.name}: {DEVICE_FAULT_REASON}: {self.device_fault!r}")

    def _device_lost(self, exc: BaseException) -> None:
        """A replica's scheduler met a CUDA error (on its thread). The
        context every replica shares is poisoned, so nothing respawns and
        failover claims nothing: the pool refuses new work and tells its
        owner, which takes the model out of service."""
        with self._lock:
            first = self.device_fault is None
            if first:
                self.device_fault = exc
        if not first:
            return
        log.error("%s: CUDA error in a replica's scheduler (%r); the pool "
                  "takes no more requests", self.name, exc)
        flightrec.RECORDER.model_event(
            self.name, "device_fault", error=repr(exc)[:200])
        if self.on_device_fault is not None:
            self.on_device_fault(exc)

    def _respawn_dead(self) -> None:
        with self._lock:
            for r in self.replicas:
                if not r.dead():
                    continue
                err = r.batcher.last_error
                log.warning(
                    "%s replica %d scheduler crashed (%r); respawning its "
                    "batcher", self.name, r.idx, err,
                )
                try:
                    r.batcher.shutdown()
                # aios: waive(silent-except): the crashed batcher's thread may already be gone — the crash itself is logged + counted just above/below
                except Exception:  # noqa: BLE001 - old thread may be gone
                    pass
                r.batcher = self._spawn_batcher(r.engine)
                self.restarts += 1
                self._obs_restarts.inc()
                # the crashed scheduler aborted every outstanding request
                # — freeze the evidence (their timelines, with the abort
                # causes) before the ring churns past it
                flightrec.RECORDER.model_event(
                    self.name, "respawn", replica=r.idx,
                    error=repr(err)[:200],
                )
                flightrec.RECORDER.snapshot(
                    self.name, "crash_respawn", sync=False  # submit path
                )
                if self.on_respawn is not None:
                    self.on_respawn(r.idx, r.batcher)

    # -- elastic lifecycle (serving/autoscale.py drives these) --------------

    def set_degrade_level(self, level: int) -> int:
        """Move the degrade ladder: 0 healthy, 1 speculation off, 2 +
        jump-ahead off, 3 + best-effort admission shed (priority < 1;
        the reactive/operational tiers stay protected). Applies to every
        live replica batcher and to admission; fresh batchers (respawn,
        scale-up) inherit via _spawn_batcher. Greedy token streams are
        pinned identical across any transition — both switched paths are
        token-identical on/off by construction. Returns the clamped
        level actually applied."""
        level = max(0, min(int(level), 3))
        self.degrade_level = level
        for r in self.replicas:
            r.batcher.degrade_spec = level >= 1
            r.batcher.degrade_jump = level >= 2
        self.admission.min_priority = 1 if level >= 3 else 0
        return level

    def add_replica(self, engine) -> int:
        """Scale up: attach one more engine+batcher replica (the
        autoscaler builds the engine OUTSIDE any pool lock — warmup
        compiles take seconds). The new replica starts cold (no prefix
        pages) so the router's least-loaded fallback naturally sends it
        the overflow. Returns the new replica index."""
        if self._closed or self._draining:
            raise RuntimeError(f"model {self.name} is draining")
        r = Replica(len(self.replicas), engine, self._spawn_batcher(engine))
        # atomic list rebind: submit paths snapshot self.replicas once,
        # so they see either the old or the new list, never a torn one
        self.replicas = self.replicas + [r]
        self._bind_occupancy(r.idx)
        return r.idx

    def remove_replica(self, drain_timeout: float = 30.0):
        """Scale down: detach the LAST replica (sticky bindings past the
        new length self-invalidate — Router._sticky_for clamps), drain
        its in-flight streams, shut its batcher down, and return the
        detached :class:`Replica` (the caller owns the engine and closes
        it if it created it). Returns None when the pool is at one
        replica — a pool never scales to zero."""
        reps = self.replicas
        if len(reps) <= 1 or self._closed:
            return None
        victim = reps[-1]
        # unroute first (atomic rebind), then drain: new submissions can
        # no longer land on the victim while its in-flight streams finish
        self.replicas = reps[:-1]
        deadline = time.monotonic() + drain_timeout
        while time.monotonic() < deadline and not victim.idle():
            time.sleep(0.02)
        victim.batcher.shutdown()
        return victim

    # -- lifecycle ----------------------------------------------------------

    def drain(self, timeout: float = 30.0) -> bool:
        """Stop admitting and wait for in-flight streams to finish.
        Returns True when every replica went idle within ``timeout``."""
        self._draining = True
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(r.idle() for r in self.replicas):
                return True
            time.sleep(0.02)
        return all(r.idle() for r in self.replicas)

    def shutdown(self, drain_timeout: float = 0.0) -> None:
        """Shut every replica down (optionally draining first) and free
        engine HBM deterministically."""
        self._draining = True
        # stop the attached autoscaler FIRST: a controller tick racing
        # shutdown must not spawn a replica onto a draining pool
        if self.autoscaler is not None:
            self.autoscaler.stop()
        if drain_timeout > 0:
            self.drain(drain_timeout)
        self._closed = True
        for r in self.replicas:
            r.batcher.shutdown()
            r.engine.close()
        # drop the gauge series this pool still owns; a hot-swap
        # replacement rebound its own indices already (fn differs), and
        # those must stay
        for child, fn, remove in getattr(self, "_gauge_bindings", ()):
            if child._fn is fn:
                remove()

    # -- observability -------------------------------------------------------

    def stats(self) -> Dict[str, float]:
        """Pool-level twin of ``engine.stats()``: engine counters summed
        across replicas, batcher counters, routing/shed tallies. Flat
        scalars only — HealthCheck renders it as k=v pairs."""
        out: Dict[str, float] = {
            "replicas": len(self.replicas),
            "replica_restarts": self.restarts,
            "degrade_level": self.degrade_level,
        }
        occ = []
        for r in self.replicas:
            for k, v in r.engine.stats().items():
                if k == "batch_occupancy":
                    occ.append(v)
                    continue
                out[k] = out.get(k, 0) + v
            out["waiting"] = out.get("waiting", 0) + r.queue_depth()
            out["completed"] = out.get("completed", 0) + r.batcher.completed
            out["cancelled"] = (
                out.get("cancelled", 0) + r.batcher.cancellations
            )
            out["pool_evictions"] = (
                out.get("pool_evictions", 0) + r.batcher.pool_evictions
            )
            out["num_slots"] = out.get("num_slots", 0) + r.engine.num_slots
            out[f"replica{r.idx}_occupancy"] = round(r.occupancy(), 3)
        if occ:
            out["batch_occupancy"] = round(sum(occ) / len(occ), 3)
        # the armed megagraph window: the engines sum mega_dispatches and
        # mega_ticks; K is configuration, so the pool reports it (dispatches
        # x K - ticks is what the early exits saved)
        mega_k = max((r.engine.mega_ticks for r in self.replicas), default=0)
        if mega_k:
            out["mega_k"] = mega_k
        with self._lock:
            for reason, n in self._routed.items():
                out[f"routed_{reason}"] = n
            for cause, n in self._shed.items():
                out[f"shed_{cause}"] = n
        return out

    def heartbeat_stats(self) -> Dict[str, float]:
        """The compact per-pool slice a fleet heartbeat carries
        (obs/fleet.py): enough for peers to rank hosts by load and spot
        degraded pools, small enough to ride every announce."""
        s = self.stats()
        return {
            k: s[k]
            for k in ("replicas", "replica_restarts", "degrade_level",
                      "batch_occupancy", "waiting", "completed",
                      "num_slots", "mega_dispatches", "mega_ticks",
                      "mega_k")
            if k in s
        }
