"""The pool's front door: quotas, deadlines, bounded queues, load shedding.

A copy of ``aios_tpu/serving/admission.py``. ``devprof_rate_fn`` stays a
hook that nothing installs until the port has a device ledger, so a cold
pool's deadline gate uses ``AIOS_TPU_ASSUMED_TPS`` or never sheds.

RTP-LLM (arXiv:2605.29639) frames the overload problem: an unbounded
admission queue converts overload into client-side timeouts for EVERY
request; deadline/priority-aware admission sheds the requests that cannot
succeed anyway and keeps the rest inside their budgets. Three gates:

  1. **queue bound** — a replica whose waiting queue is full sheds
     instead of queueing (the batcher's deque would otherwise grow
     without limit while clients time out one by one).
  2. **deadline feasibility** — the propagated gRPC deadline is compared
     with (replica outstanding tokens + this request's cache-capped
     decode budget) / observed decode rate; an infeasible request is
     shed IMMEDIATELY, before it consumes a slot or queue position.
  3. **quota** — per-tenant token buckets (tenant = agent id or task-id
     prefix). A request reserves prompt + max_tokens; an empty bucket
     rejects with a retry-after derived from the refill rate. One noisy
     tenant exhausts its own bucket, not the pool. Quota runs LAST —
     debiting is a side effect, and a request the other gates shed must
     not burn the tenant's bucket.

Every rejection raises :class:`AdmissionError`, which the runtime service
maps to ``RESOURCE_EXHAUSTED`` with a ``retry-after-ms`` trailing
metadata hint — clients back off instead of hammering a saturated pool.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional

from .. import faults
from ..analysis.locks import make_lock
from ..obs import instruments as obs
from ..obs.flightrec import SHED_CAUSES
from .config import ServingConfig

# Bound the retry-after hint: past this, the client should re-resolve /
# re-plan rather than sleep (also caps what a huge quota deficit emits).
MAX_RETRY_AFTER_MS = 30_000

# per-process tenant-bucket cap: tenant names derive from client input
_MAX_TENANTS = 4096

# Host-level drain flag (fleet/drain.py flips it): module-level so EVERY
# pool in the process sheds new work while the host drains — unlike the
# per-pool "draining" cause, "draining_host" tells clients the whole
# host is leaving and they should resubmit to a surviving fleet peer.
# Plain bool store/load, no lock (same cross-thread pattern as
# min_priority below).
_host_draining = False


def set_host_draining(active: bool) -> None:
    """Flip the process-wide drain gate (fleet/drain.py owns this)."""
    global _host_draining
    _host_draining = bool(active)


def host_draining() -> bool:
    return _host_draining


class AdmissionError(Exception):
    """A request shed at the front door. ``cause`` is one of
    quota|deadline|queue_full|draining; ``retry_after_ms`` is the backoff
    hint the service returns as trailing metadata. ``retriable=False``
    marks a PERMANENT condition (e.g. a cost no bucket refill can ever
    cover) — the service maps it to a non-retriable status so compliant
    clients don't retry forever."""

    def __init__(self, message: str, cause: str, retry_after_ms: int = 1000,
                 retriable: bool = True):
        super().__init__(message)
        self.cause = cause
        self.retriable = retriable
        self.retry_after_ms = max(0, min(int(retry_after_ms),
                                         MAX_RETRY_AFTER_MS))


def tenant_of(request, mode: str = "agent") -> str:
    """Tenant identity from an InferRequest-shaped object: the requesting
    agent id, falling back to the task id's prefix (the segment before
    the first separator — agent task ids are "<agent>-<seq>"-shaped)."""
    agent = getattr(request, "requesting_agent", "") or ""
    task = getattr(request, "task_id", "") or ""
    if mode == "agent" and agent:
        return agent
    if task:
        for sep in ("-", ":", "/"):
            if sep in task:
                return task.split(sep, 1)[0]
        return task
    return agent or "anonymous"


class TokenBucket:
    """Lazy-refill token bucket (monotonic clock; caller holds no lock —
    the bucket locks itself)."""

    def __init__(self, rate: float, burst: float) -> None:
        self.rate = rate
        self.burst = burst
        self.tokens = burst  #: guarded_by _lock
        self._at = time.monotonic()
        self._lock = make_lock("token_bucket")

    def try_take(self, cost: float) -> float:
        """Take ``cost`` tokens; returns 0.0 on success, else the seconds
        until the bucket could cover the cost (capped at the burst — a
        cost the bucket can NEVER cover reports the full-refill time)."""
        with self._lock:
            now = time.monotonic()
            self.tokens = min(
                self.burst, self.tokens + (now - self._at) * self.rate
            )
            self._at = now
            if self.tokens >= cost:
                self.tokens -= cost
                return 0.0
            deficit = min(cost, self.burst) - self.tokens
            return deficit / self.rate if self.rate > 0 else float("inf")


class AdmissionController:
    """Per-pool admission policy. Stateless w.r.t. replicas — the pool
    passes the chosen replica's live numbers in, so unit tests drive the
    policy with plain fakes."""

    def __init__(self, cfg: ServingConfig, model: str) -> None:
        self.cfg = cfg
        self.model = model
        # the "0 -> 4 s of refill" burst default applies at USE site, not
        # just in the env parser — a directly-constructed config with a
        # rate but no burst must not hand TokenBucket(burst=0), which
        # rejects 100% of traffic
        self._burst = (
            cfg.tenant_burst_tokens
            if cfg.tenant_burst_tokens > 0
            else 4.0 * cfg.tenant_tokens_per_sec
        )
        self._buckets: Dict[str, TokenBucket] = {}  #: guarded_by _lock
        self._lock = make_lock("admission")
        # Degrade gate (autoscale ladder rung 3): requests below this
        # priority floor shed with cause "degraded" while the pool digs
        # out of an SLO burn. 0 = gate off. Flipped cross-thread by
        # ReplicaPool.set_degrade_level — plain int store, no lock.
        self.min_priority = 0
        # Cold-start decode-rate seed: when no rate has been observed
        # AND the operator set no AIOS_TPU_ASSUMED_TPS floor, the pool
        # installs a callable deriving tokens/sec from the devprof
        # ledger's per-graph step means (docs/RUNBOOK.md §8) — a stale
        # hardcoded floor mis-sheds deadline requests on fast hardware.
        # The env knob (cfg.assumed_tokens_per_sec > 0) always wins.
        self.devprof_rate_fn: Optional[Callable[[], float]] = None
        # one closed enum end to end: the shed counter's label set, the
        # AdmissionError causes, and the flight recorder's shed events
        # all draw from obs.flightrec.SHED_CAUSES
        self._obs_shed = {
            cause: obs.SERVING_SHED.labels(model=model, cause=cause)
            for cause in SHED_CAUSES
        }

    def shed(self, cause: str, message: str, retry_after_ms: int = 1000,
             retriable: bool = True) -> AdmissionError:
        """Count and build (not raise) the shed error for ``cause``."""
        self._obs_shed[cause].inc()
        return AdmissionError(message, cause, retry_after_ms, retriable)

    # -- host drain gate (before every other gate: a leaving host must
    # not debit quota or queue work it will never finish) ------------------

    def check_host_drain(self) -> None:
        if not _host_draining:
            return
        raise self.shed(
            "draining_host",
            "host is draining (graceful drain in progress): resubmit to "
            "a surviving fleet peer",
            2000,
        )

    # -- gate 0: degrade-ladder priority floor (clock-free, runs first) ----

    def check_priority(self, priority: int) -> None:
        """Autoscale ladder rung 3: shed best-effort traffic (priority
        below the protected floor) while the controller is digging the
        pool out of an SLO burn. Reactive/operational tiers (priority
        >= 1) keep admitting — the preemption order the batcher's
        priority-aware slot admission already enforces continues to
        protect them once admitted."""
        if self.min_priority <= 0 or priority >= self.min_priority:
            return
        raise self.shed(
            "degraded",
            f"pool degraded under SLO burn: best-effort traffic "
            f"(priority {priority} < floor {self.min_priority}) is "
            f"temporarily shed",
            5000,
        )

    # -- gate 3 (runs LAST — debiting is a side effect): tenant quota ------

    def check_quota(self, tenant: str, cost_tokens: float) -> None:
        if self.cfg.tenant_tokens_per_sec <= 0:
            return
        if cost_tokens > self._burst:
            # no refill can EVER cover this cost — a retriable shed would
            # put compliant clients in an infinite retry loop; fail it as
            # permanent so they resize the request (or the operator the
            # burst)
            obs.SERVING_QUOTA_REJECTIONS.labels(tenant=tenant).inc()
            raise self.shed(
                "quota",
                f"request cost ({cost_tokens:g} tokens) exceeds the "
                f"tenant burst capacity ({self._burst:g}); shrink the "
                "prompt/max_tokens or raise "
                "AIOS_TPU_TENANT_BURST_TOKENS",
                MAX_RETRY_AFTER_MS, retriable=False,
            )
        with self._lock:
            bucket = self._buckets.get(tenant)
            if bucket is None:
                if len(self._buckets) >= _MAX_TENANTS:
                    # refuse-new rather than evict-old: evicting refills
                    # a drained bucket, which is exactly what a tenant
                    # spraying fresh ids would want
                    raise self.shed(
                        "quota", "tenant table full", MAX_RETRY_AFTER_MS
                    )
                bucket = TokenBucket(
                    self.cfg.tenant_tokens_per_sec, self._burst
                )
                self._buckets[tenant] = bucket
        wait_s = bucket.try_take(cost_tokens)
        if wait_s > 0:
            obs.SERVING_QUOTA_REJECTIONS.labels(tenant=tenant).inc()
            raise self.shed(
                "quota",
                f"tenant {tenant!r} over token quota "
                f"({self.cfg.tenant_tokens_per_sec:g} tok/s, burst "
                f"{self._burst:g})",
                int(wait_s * 1000) or 1,
            )

    # -- gate 1: bounded queue ---------------------------------------------

    def check_queue(self, queue_depth: int, outstanding_tokens: int,
                    rate_tps: float) -> None:
        if self.cfg.max_queue <= 0 or queue_depth < self.cfg.max_queue:
            return
        raise self.shed(
            "queue_full",
            f"admission queue full ({queue_depth} waiting, bound "
            f"{self.cfg.max_queue})",
            self._drain_ms(outstanding_tokens, rate_tps),
        )

    # -- gate 2: deadline feasibility --------------------------------------

    def check_deadline(self, deadline_s: Optional[float],
                       outstanding_tokens: int, max_tokens: int,
                       rate_tps: float) -> None:
        if deadline_s is None:
            return
        act = faults.point("admission.clock_skew", self.model)
        if act is not None and act.skew_s:
            # chaos: the gate's clock runs fast — deadlines look closer
            # than they are, driving deadline sheds (and their
            # retry-after metadata) on demand
            deadline_s = deadline_s - act.skew_s
        rate = rate_tps or self.assumed_rate()
        if rate <= 0:
            return  # no observed rate yet: cannot estimate, never shed
        need_s = (outstanding_tokens + max_tokens) / rate
        if need_s > deadline_s:
            raise self.shed(
                "deadline",
                f"deadline infeasible: ~{need_s:.2f}s of queued+requested "
                f"decode at {rate:.0f} tok/s exceeds the {deadline_s:.2f}s "
                f"deadline",
                self._drain_ms(outstanding_tokens, rate),
            )

    def assumed_rate(self) -> float:
        """Cold-start decode-rate floor for the feasibility gate: the
        operator's AIOS_TPU_ASSUMED_TPS knob when set, else the
        devprof-seeded estimate installed by the pool (0.0 when devprof
        is unarmed or has no step samples yet — the gate then never
        sheds, the pre-existing cold behavior)."""
        if self.cfg.assumed_tokens_per_sec > 0:
            return self.cfg.assumed_tokens_per_sec
        fn = self.devprof_rate_fn
        return float(fn() or 0.0) if fn is not None else 0.0

    @staticmethod
    def _drain_ms(outstanding_tokens: int, rate_tps: float) -> int:
        if rate_tps <= 0:
            return 1000
        return int(outstanding_tokens / rate_tps * 1000) or 1
