"""SLO-burn-driven autoscaling + degrade ladder for a ReplicaPool.

Closes the loop the observability PRs opened: the SLO engine (obs/slo.py)
already computes windowed burn rates per objective and the devprof ledger
(obs/devprof.py) already attributes device-seconds per replica — this
controller is the first consumer. Policy (RTP-LLM-style load-aware
engine management, PAPERS.md):

  * **scale out first** — while the pool is below the configured replica
    ceiling and an engine factory is attached, sustained burn adds a
    replica (reusing the pool's spawn lifecycle; the new replica starts
    cold and picks up overflow via least-loaded routing). When devprof
    is armed, the measured device-seconds-per-replica between ticks is
    the capacity denominator: per-replica utilization rides every action
    event so an operator can see whether the pool was actually
    compute-bound when the controller acted.
  * **degrade below the ceiling** — at the ceiling (or with no factory)
    the controller walks a deterministic ladder of optional-work sheds:
    rung 1 speculation off, rung 2 grammar jump-ahead off, rung 3 shed
    best-effort admissions (priority < 1; the reactive/operational tiers
    stay protected, and the batcher's priority-aware slot admission +
    pool-pressure eviction keep preempting in their favor). Every rung
    is token-identical for greedy streams by construction, so a ladder
    transition never perturbs an in-flight stream.
  * **hysteresis + cooldown** — an action needs ``hold_ticks``
    consecutive over/under-threshold evaluations AND ``cooldown_secs``
    since the previous action, so the controller cannot flap on a noisy
    window. Recovery walks the ladder back BEFORE scaling in (restoring
    work is free; giving up a replica is not).
  * **kill switch** — ``AIOS_TPU_AUTOSCALE_KILL=1`` (checked every
    tick) restores the pool to healthy and freezes the controller; the
    operator override documented in docs/RUNBOOK.md §8.

Every action increments the closed-enum
``aios_tpu_autoscale_actions_total{action,cause}`` family (children
pre-registered by iterating ACTIONS x CAUSES) and lands on the flight
recorder's model lane as an ``autoscale`` event with the evidence the
decision was made on (burn, level, replicas, utilization).
"""

from __future__ import annotations

import logging
import math
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

from ..analysis.locks import make_lock
from ..obs import flightrec
from ..obs import incidents as incidents_mod
from ..obs import instruments as obs
from ..obs import slo as slo_mod
from ..obs import tsdb as tsdb_mod

log = logging.getLogger("aios.serving")

# Closed enums — the only values the metric family's ``action`` and
# ``cause`` labels may carry (tests/test_obs_lint.py pins every call
# site and that registration iterates the tuples).
ACTIONS = ("scale_up", "scale_down", "degrade", "restore")
CAUSES = ("burn", "ceiling", "recovery", "kill_switch")

# The degrade ladder, in escalation order (pool.set_degrade_level maps
# rung index -> mechanism; docs/RUNBOOK.md §8 documents the order).
LADDER = ("spec_off", "jump_off", "shed_best_effort")

_MAX_JOURNAL = 256  # bounded action journal (state()/bench evidence)


def _env_float(name: str, default: float, minimum: float = 0.0) -> float:
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        v = float(raw)
        if v < minimum:
            raise ValueError(f"must be >= {minimum}")
        return v
    except ValueError as exc:
        log.warning("%s=%r ignored (%s); using %s", name, raw, exc, default)
        return default


def enabled() -> bool:
    """Whether AIOS_TPU_AUTOSCALE arms a controller per loaded pool
    (read by ModelManager.load_model)."""
    return os.environ.get("AIOS_TPU_AUTOSCALE", "").lower() in (
        "1", "on", "true", "yes",
    )


def kill_switch() -> bool:
    """AIOS_TPU_AUTOSCALE_KILL=1: restore the pool and freeze the
    controller (checked every tick, so an operator can flip it on a
    live deployment without a restart)."""
    return os.environ.get("AIOS_TPU_AUTOSCALE_KILL", "").lower() in (
        "1", "on", "true", "yes",
    )


@dataclass(frozen=True)
class AutoscaleConfig:
    """Controller policy, read once at attach (the serving-config
    convention: a running controller's policy is immutable; the kill
    switch is the only live override)."""

    # replica ceiling the controller may scale up to (>= the pool's
    # starting size; scale-down never goes below the starting size)
    max_replicas: int = 4
    # control-loop period (the background thread's tick interval)
    interval_secs: float = 5.0
    # burn-rate thresholds: escalate when the worst watched objective
    # burns above up_burn for hold_ticks consecutive ticks; recover when
    # it stays below down_burn as long. 1.0 = burning exactly at the
    # error budget.
    up_burn: float = 1.0
    down_burn: float = 0.25
    hold_ticks: int = 2
    # minimum seconds between actions (flap damping on top of the hold)
    cooldown_secs: float = 30.0
    # objectives whose burn drives the loop. Availability is deliberately
    # excluded by default: ladder rung 3 sheds best-effort work, which
    # counts against availability — including it would let the
    # controller's own mitigation hold it at the ceiling forever.
    objectives: Tuple[str, ...] = ("ttft", "tpot")
    # devprof capacity denominator: target per-replica busy fraction
    # used for the suggested-replicas estimate on action events
    target_util: float = 0.7

    @classmethod
    def from_env(cls) -> "AutoscaleConfig":
        return cls(
            max_replicas=int(_env_float(
                "AIOS_TPU_AUTOSCALE_MAX_REPLICAS", 4, 1
            )),
            interval_secs=_env_float(
                "AIOS_TPU_AUTOSCALE_INTERVAL_SECS", 5.0, 0.05
            ),
            up_burn=_env_float("AIOS_TPU_AUTOSCALE_UP_BURN", 1.0, 0.0),
            down_burn=_env_float("AIOS_TPU_AUTOSCALE_DOWN_BURN", 0.25, 0.0),
            hold_ticks=int(_env_float("AIOS_TPU_AUTOSCALE_HOLD_TICKS", 2, 1)),
            cooldown_secs=_env_float(
                "AIOS_TPU_AUTOSCALE_COOLDOWN_SECS", 30.0, 0.0
            ),
        )


class AutoscaleController:
    """One controller per ReplicaPool. ``tick()`` is the whole control
    law (tests/bench drive it directly; ``start()`` runs it on a daemon
    thread every ``interval_secs``). The controller lock guards ONLY
    bookkeeping — engine builds, pool mutations, and metric increments
    all run outside it (an engine factory warms up for seconds)."""

    def __init__(
        self,
        pool,
        cfg: Optional[AutoscaleConfig] = None,
        engine_factory: Optional[Callable[[], object]] = None,
        slo_engine=None,
        start: bool = False,
    ) -> None:
        self.pool = pool
        self.cfg = cfg or AutoscaleConfig.from_env()
        self.engine_factory = engine_factory
        self.slo = slo_engine if slo_engine is not None else slo_mod.ENGINE
        self.min_replicas = len(pool.replicas)
        self._lock = make_lock("autoscale")
        self._hold_up = 0  #: guarded_by _lock
        self._hold_down = 0  #: guarded_by _lock
        self._last_action_t = 0.0  #: guarded_by _lock
        self._acted = False  #: guarded_by _lock
        self._journal: List[dict] = []  #: guarded_by _lock
        self._killed = False  #: guarded_by _lock
        # engines THIS controller built (scale-down closes only these;
        # baseline engines belong to the model manager)
        self._added: List = []  #: guarded_by _lock
        # devprof capacity denominator: last (t, total device-seconds)
        self._dev_mark: Optional[Tuple[float, float]] = None  #: guarded_by _lock
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # pre-register every (action, cause) child by iterating the
        # closed enums (the SLO-objectives registration pattern)
        self._obs_actions = {
            (a, c): obs.AUTOSCALE_ACTIONS.labels(
                model=pool.name, action=a, cause=c
            )
            for a in ACTIONS for c in CAUSES
        }
        pool.autoscaler = self
        if start:
            self.start()

    # -- control law --------------------------------------------------------

    def tick(self, now: Optional[float] = None) -> str:
        """One evaluation + at most one action. Returns what happened:
        idle|hold|cooldown|kill|steady|saturated or an ACTIONS member."""
        t = time.monotonic() if now is None else now
        if kill_switch():
            with self._lock:
                was_killed = self._killed
                self._killed = True
            if not was_killed and self.pool.degrade_level > 0:
                self.pool.set_degrade_level(0)
                self._record("restore", "kill_switch", t, burn=None,
                             level=0)
            return "kill"
        with self._lock:
            self._killed = False
        burn = self.worst_burn(now=t)
        if burn is None:
            return "idle"  # no evaluable window yet: provably quiescent
        with self._lock:
            if burn > self.cfg.up_burn:
                self._hold_up += 1
                self._hold_down = 0
            elif burn < self.cfg.down_burn:
                self._hold_down += 1
                self._hold_up = 0
            else:
                self._hold_up = 0
                self._hold_down = 0
            want_up = self._hold_up >= self.cfg.hold_ticks
            want_down = self._hold_down >= self.cfg.hold_ticks
            cooling = (
                self._acted
                and t - self._last_action_t < self.cfg.cooldown_secs
            )
        if not (want_up or want_down):
            return "hold"
        if cooling:
            return "cooldown"
        return self._escalate(t, burn) if want_up \
            else self._deescalate(t, burn)

    def _escalate(self, t: float, burn: float) -> str:
        pool = self.pool
        n = len(pool.replicas)
        if n < self.cfg.max_replicas and self.engine_factory is not None:
            # engine build + warmup runs HERE, outside every lock —
            # seconds of compile must not block scrapes or submits
            engine = self.engine_factory()
            try:
                idx = pool.add_replica(engine)
            except BaseException:
                # a pool that started draining mid-build must not leak
                # the freshly-built engine's HBM
                engine.close()
                raise
            with self._lock:
                self._added.append(engine)
            self._record("scale_up", "burn", t, burn=burn, replica=idx,
                         replicas=idx + 1, level=pool.degrade_level)
            return "scale_up"
        level = pool.degrade_level
        if level < len(LADDER):
            new = pool.set_degrade_level(level + 1)
            cause = (
                "ceiling"
                if self.engine_factory is not None
                and n >= self.cfg.max_replicas
                else "burn"
            )
            self._record("degrade", cause, t, burn=burn, level=new,
                         rung=LADDER[new - 1], replicas=n)
            return "degrade"
        return "saturated"  # ceiling + fully degraded: nothing left

    def _deescalate(self, t: float, burn: float) -> str:
        pool = self.pool
        level = pool.degrade_level
        if level > 0:
            new = pool.set_degrade_level(level - 1)
            self._record("restore", "recovery", t, burn=burn, level=new,
                         rung=LADDER[level - 1],
                         replicas=len(pool.replicas))
            return "restore"
        if len(pool.replicas) > self.min_replicas:
            victim = pool.remove_replica()
            if victim is None:
                return "steady"
            engine = victim.engine
            with self._lock:
                ours = engine in self._added
                if ours:
                    self._added.remove(engine)
            if ours:
                # we built it, we free its HBM; baseline engines belong
                # to the model manager
                engine.close()
            self._record("scale_down", "recovery", t, burn=burn,
                         replica=victim.idx, replicas=len(pool.replicas),
                         level=pool.degrade_level)
            return "scale_down"
        return "steady"

    # -- signals ------------------------------------------------------------

    def worst_burn(self, now: Optional[float] = None) -> Optional[float]:
        """Max burn rate over the watched objectives, or None when no
        objective has an evaluable window yet (fewer than the SLO
        engine's min_samples — a cold pool never triggers actions).
        ``now`` (the tick's clock) bypasses the SLO engine's 1 s scrape
        cache so each control decision sees the live window."""
        if self.pool.name not in self.slo.models():
            return None
        ev = self.slo.evaluate(self.pool.name, now=now)
        burns = [
            v["burn_rate"]
            for o, v in ev.items()
            if o in self.cfg.objectives
            and v["samples"] >= self.slo.cfg.min_samples
        ]
        return max(burns) if burns else None

    def utilization(self, now: Optional[float] = None) -> Optional[dict]:
        """Devprof capacity denominator: device-seconds accrued per
        replica per wall-second since the previous reading, plus the
        replica count that busy fraction suggests at ``target_util``.
        None when devprof is unarmed / has no samples yet or on the
        first reading (no delta)."""
        from ..obs import devprof

        t = time.monotonic() if now is None else now
        busy = 0.0
        seen = False
        for led in devprof.ledgers_for(self.pool.name):
            for kind in devprof.GRAPH_KINDS:
                s = led.device_seconds(kind)
                if s:
                    seen = True
                    busy += s
        if not seen:
            return None
        with self._lock:
            mark, self._dev_mark = self._dev_mark, (t, busy)
        if mark is None or t <= mark[0]:
            return None
        elapsed = t - mark[0]
        n = max(len(self.pool.replicas), 1)
        per_replica = (busy - mark[1]) / elapsed / n
        return {
            "device_seconds_per_replica_per_sec": round(per_replica, 6),
            "replicas_suggested": max(
                1,
                math.ceil((busy - mark[1]) / elapsed
                          / max(self.cfg.target_util, 1e-6)),
            ),
        }

    # -- bookkeeping ---------------------------------------------------------

    def _record(self, action: str, cause: str, t: float, *,
                burn: Optional[float], **fields) -> None:
        util = self.utilization(t)
        if util is not None:
            fields.update(util)
        # When the tsdb ring is armed, annotate the decision with the
        # recent burn trend — the journal then records not just the
        # instantaneous burn the controller acted on but the direction
        # it was heading (None when unarmed: zero cost on the hot path).
        burn_trend = tsdb_mod.trend(
            "aios_tpu_slo_burn_rate_ratio", {"model": self.pool.name},
        )
        entry = dict(action=action, cause=cause,
                     burn=round(burn, 4) if burn is not None else None,
                     **fields)
        if burn_trend is not None:
            entry["burn_trend"] = burn_trend
        with self._lock:
            self._hold_up = 0
            self._hold_down = 0
            self._last_action_t = t
            self._acted = True
            self._journal.append(entry)
            del self._journal[:-_MAX_JOURNAL]
        self._obs_actions[(action, cause)].inc()
        flightrec.RECORDER.model_event(
            self.pool.name, "autoscale", **entry
        )
        incidents_mod.notify(
            self.pool.name, "autoscale",
            action=action, autoscale_cause=cause,
            burn=entry["burn"],
        )
        log.warning(
            "%s autoscale %s (%s): burn=%s level=%d replicas=%d",
            self.pool.name, action, cause, entry["burn"],
            self.pool.degrade_level, len(self.pool.replicas),
        )

    def actions(self) -> List[dict]:
        """The bounded action journal, oldest first (bench/tests read
        this as the controller's evidence trail)."""
        with self._lock:
            return list(self._journal)

    def state(self) -> dict:
        """Flat controller state for stats()/debug surfaces."""
        with self._lock:
            return {
                "level": self.pool.degrade_level,
                "replicas": len(self.pool.replicas),
                "min_replicas": self.min_replicas,
                "max_replicas": self.cfg.max_replicas,
                "actions": len(self._journal),
                "hold_up": self._hold_up,
                "hold_down": self._hold_down,
                "killed": self._killed,
            }

    # -- thread --------------------------------------------------------------

    def start(self) -> None:
        if self._thread is not None and self._thread.is_alive():
            return
        self._stop_evt.clear()
        self._thread = threading.Thread(
            target=self._run, name=f"autoscale-{self.pool.name}",
            daemon=True,
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop_evt.wait(self.cfg.interval_secs):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 - the loop must survive a bad tick
                log.exception(
                    "%s autoscale tick failed", self.pool.name
                )

    def stop(self) -> None:
        self._stop_evt.set()
        t = self._thread
        if t is not None and t.is_alive():
            t.join(timeout=10)
